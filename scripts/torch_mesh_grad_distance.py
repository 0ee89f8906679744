"""How far one training step on a ('data', 'seq', 'model') mesh lies from
one process's, on the CPU: the TINY ADNM-UNet (duality and bimamba, the
seeded init) at 32^2, batch 2, its two gloo ranks against one process.

    python3 scripts/torch_mesh_grad_distance.py [--tree DIR] [--mesh data=1,seq=2]

Prints, for each configuration, the worst gradient tensor's distance
relative to its norm (over the tensors above 1e-4 of the whole gradient's
norm) and the whole gradient's relative distance. ``--tree`` runs the
port of another source tree (its ``adnm_tpu_torch`` and its tests' rank
functions first on the path): a copy with a collective's backward broken
on purpose shows how far such a fault moves the gradients beside the
sound tree's distance and the tests' bound (1e-3 of a tensor's norm,
``tests/test_torch_port_mesh_train.py``).
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile

import numpy as np
import torch

CFG = dict(channels=5, out_channels=2, kernel=(3, 3, 3), embed_dim=(8,) * 6, refine_dim=(8,) * 4,
           wt_levels=(1, 1, 1), headdim=2, refine_headdim=(2,) * 4, depth=(1, 1, 1),
           refine_depth=(1, 1, 1, 1))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--mesh", default="data=1,seq=2")
    args = p.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    from adnm_tpu_torch.core.layers import seeded_init_
    from adnm_tpu_torch.models.adnm_unet import ADNMUNet
    from adnm_tpu_torch.parallel import parse_mesh, spawn
    from test_torch_port_parallel_workers import (MeshTrainJob, one_process_train,
                                                  run_mesh_cases)

    torch.set_num_threads(1)
    sizes = parse_mesh(args.mesh)
    axes = (sizes["data"], sizes.get("seq", 1), sizes.get("model", 1))
    batch = np.random.default_rng(3).uniform(0, 1, (2, 7, 1, 32, 32)).astype(np.float32)
    for label, kw in (("duality", {}), ("bimamba", {"linear_attn_duality": False})):
        make = functools.partial(ADNMUNet, **CFG, **kw)
        job = MeshTrainJob(label, make, "ADNMUnet", batch, seeded_init_(make(), 0).state_dict(),
                           steps=1)
        with tempfile.TemporaryDirectory() as out:
            spawn(run_mesh_cases, int(np.prod(axes)), args=(axes, [job], out), device="cpu",
                  timeout_s=600)
            got = torch.load(os.path.join(out, f"{label}_rank0.pt"), weights_only=False)
        want, got = one_process_train(job, torch.device("cpu"))["grads"][0], got["grads"][0]
        total = float(torch.sqrt(sum(w.double().square().sum() for w in want.values())))
        worst = max((float((got[k].double() - w.double()).norm() / w.double().norm()), k)
                    for k, w in want.items() if float(w.double().norm()) > 1e-4 * total)
        whole = float(torch.sqrt(sum((got[k].double() - w.double()).square().sum()
                                     for k, w in want.items()))) / total
        print(f"{label} on {args.mesh} ({tree}): worst tensor {worst[0]:.3e} ({worst[1]}), "
              f"whole gradient {whole:.3e}")


if __name__ == "__main__":
    main()
