"""Hold two source trees of the port to the same bits: the TINY ADNM-UNet's
outputs on the CPU (duality, bimamba, VSSD duality, VSSD bimamba; fp32,
and bf16 where the configuration runs in it), its training step on the
CPU (duality and bimamba: the loss, every gradient and the parameters
after AdamW) in one process and on two gloo ranks of a 'data' mesh and,
where a card is visible, K2's outputs without a carried state at the main
path's shapes and K2's backward there, forward and reversed, fp32 and
bf16.

    python3 scripts/torch_parent_bits.py TREE_A TREE_B

Each tree runs in a process of its own (its ``adnm_tpu_torch`` first on
the path; K2 is built in each tree's build directory). Prints each
output's verdict and exits 1 if any differs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np

CHILD = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from adnm_tpu_torch.core.layers import seeded_init_
from adnm_tpu_torch.models.adnm_unet import ADNMUNet
torch.set_num_threads(1)
cfg = dict(channels=5, out_channels=2, kernel=(3, 3, 3), wt_levels=(1, 1, 1), headdim=2,
           embed_dim=(8,) * 6, refine_dim=(8,) * 4, refine_headdim=(2,) * 4)
cases = {"duality": {}, "bimamba": {"linear_attn_duality": False}, "vssd": {"mixer_type": "vssd"},
         "vssd-bimamba": {"mixer_type": "vssd", "linear_attn_duality": False}}
x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 5, 1, 32, 32)).astype(np.float32))
out = {}
for name, kw in cases.items():
    for dtype in (torch.float32, torch.bfloat16):
        if name == "vssd-bimamba" and dtype == torch.bfloat16:
            continue  # fp32 only, as in JAX
        model = seeded_init_(ADNMUNet(**cfg, **kw), 0).eval()
        with torch.no_grad():
            out[f"cpu {name} {dtype}"] = model(x.to(dtype)).float().numpy()
if torch.cuda.is_available():
    from adnm_tpu_torch.device import resolve_device
    from adnm_tpu_torch.ops import ssd
    resolve_device("cuda")
    for b, h, l in ((1, 8, 65536), (4, 8, 65536), (1, 32, 1024), (1, 64, 256), (1, 4, 65536)):
        gen = torch.Generator(device="cuda").manual_seed(l + h + b)
        x = torch.randn(b, h, 4, l, generator=gen, device="cuda")
        dt = torch.nn.functional.softplus(torch.randn(b, h, l, generator=gen, device="cuda") - 4)
        A = -torch.exp(torch.rand(h, generator=gen, device="cuda") * 2.77)
        B, C = (torch.randn(b, 16, l, generator=gen, device="cuda") for _ in range(2))
        D = 0.5 + torch.rand(h, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in (x, dt, A, B, C, D)]
            for reverse in (False, True):
                y = ssd.ssd_chunked_scan(*args, 256, reverse=reverse)
                out[f"K2 {(b, h, l)} {dtype} reverse={reverse}"] = y.float().cpu().numpy()
    for (b, h, l) in ((1, 8, 65536), (1, 32, 1024)):
        gen = torch.Generator(device="cuda").manual_seed(3 * l + h + b)
        x = torch.randn(b, h, 4, l, generator=gen, device="cuda")
        dt = torch.nn.functional.softplus(torch.randn(b, h, l, generator=gen, device="cuda") - 4)
        A = -torch.exp(torch.rand(h, generator=gen, device="cuda") * 2.77)
        B, C = (torch.randn(b, 16, l, generator=gen, device="cuda") for _ in range(2))
        D = 0.5 + torch.rand(h, generator=gen, device="cuda")
        dy = torch.randn(b, h, 4, l, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in (x, dt, A, B, C, D, dy)]
            for reverse in (False, True):
                grads = ssd.ssd_chunked_scan_backward(*args, 256, reverse)
                for name, g in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads):
                    out[f"K2 backward {(b, h, l)} {dtype} reverse={reverse} {name}"] = (
                        g.float().cpu().numpy())
if __name__ == "__main__":
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset
    sys.path.insert(0, sys.argv[1] + "/tests")
    import functools
    import tempfile
    from adnm_tpu_torch.parallel import spawn
    from test_torch_port_parallel_workers import Job, load_ranks, run_steps
    batch = np.random.default_rng(2).uniform(0, 1, (2, 7, 1, 32, 32)).astype(np.float32)
    for name in ("duality", "bimamba"):
        make = functools.partial(ADNMUNet, **cfg, **cases[name])
        t = Trainer(make(), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, torch.device("cpu"),
                    seed=0)
        loss, grads = t.grads(batch)
        out[f"step {name} loss"] = np.float64(loss)
        out.update({f"step {name} grad {k}": g.numpy() for k, g in grads.items()})
        t.train_step(torch.from_numpy(batch), 1e-3, 0.025)
        out.update({f"step {name} param {k}": v.numpy() for k, v in t.model.state_dict().items()})
        job = Job(make, "ADNMUnet", batch, grads=True)
        with tempfile.TemporaryDirectory() as tmp:
            spawn(run_steps, 2, args=(job, tmp), device="cpu", timeout_s=600)
            rank = load_ranks(tmp, 2)[0]
        out[f"data=2 {name} loss"] = np.float64(rank["grad_loss"])
        out.update({f"data=2 {name} grad {k}": g.numpy() for k, g in rank["grads"].items()})
        out.update({f"data=2 {name} param {k}": v.numpy() for k, v in rank["params"].items()})
    np.savez(sys.argv[2], **out)
"""


def outputs(tree: str, path: str) -> dict:
    subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(tree), path], check=True)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit(__doc__)
    with tempfile.TemporaryDirectory() as tmp:
        a, b = (outputs(t, os.path.join(tmp, f"{i}.npz")) for i, t in enumerate(argv))
    differ = 0
    for key in sorted(set(a) | set(b)):
        same = key in a and key in b and np.array_equal(a[key], b[key])
        differ += not same
        print(f"{key}: {'bit-equal' if same else 'DIFFERS'}")
    print(f"{len(a)} outputs, {differ} differ")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
