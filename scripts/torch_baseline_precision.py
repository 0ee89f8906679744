"""How far the port's fp32 baselines are from fp64, on the CPU: the yardstick
for the card-against-CPU bounds of ``chip_smoke.py``'s baseline phase.

    python3 scripts/torch_baseline_precision.py [--img-size 64] [MODEL ...]

For SmaATUnet, ConvLSTM, TrajGRU, LPTQPN, TransUnet and SwinUnet at full
width, from the init seeded with 0 (``predict.load_model(None, ...)``, as
the smoke serves them; the dropout and DropPath rates at 0, as the smoke's
card-against-CPU step runs them) and the smoke's batch-1 input and
training clip: the batch-1 forward's max
abs and relative L2 error of fp32 against the same model in fp64, and one
training step's (the preset's loss, train mode) loss, global gradient norm
and worst gradient tensor against fp64: its relative L2 error among the
tensors above 1e-4 of the global norm, and its error over the smoke's
per-tensor bound (2e-2 of its norm + 1e-7 of the global norm); for SmaAt
and TransUnet apart, the largest error of a parameter whose gradient is 0
in exact arithmetic, rounding noise in fp32 (``chip_smoke.exact_zero_gradient``:
SmaAt's conv biases before a BatchNorm, TransUnet's key biases) over the
global norm. Card and CPU each round fp32 in their own order,
so they differ by up to about twice these distances. Runs on the CPU with
one intra-op thread.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adnm_tpu_torch.cli import predict  # noqa: E402
from adnm_tpu_torch.core.stochastic import zero_rates  # noqa: E402
from chip_smoke import exact_zero_gradient  # noqa: E402
from adnm_tpu_torch.data.shanghai import _synthetic_clip  # noqa: E402
from adnm_tpu_torch.models.registry import BASELINES  # noqa: E402
from adnm_tpu_torch.train.presets import get_preset  # noqa: E402


def step(model, batch: torch.Tensor, loss_fn) -> tuple:
    model.train()
    loss = loss_fn(model(batch[:, :5]), batch[:, 5:])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), [g.double() for g in grads]


def main() -> None:
    p = argparse.ArgumentParser("torch_baseline_precision")
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("models", nargs="*", default=list(BASELINES))
    args = p.parse_args()
    size = args.img_size
    torch.set_num_threads(1)
    x = np.random.RandomState(0).rand(1, 5, 1, size, size).astype(np.float32)
    clip = _synthetic_clip(np.random.default_rng(0), 25, size)[None, :, None]
    for name in args.models:
        m32 = zero_rates(predict.load_model(None, "cpu", model_name=name, img_size=size))
        m64 = zero_rates(predict.load_model(None, "cpu", model_name=name, img_size=size)).double()
        with torch.no_grad():
            y32 = m32(torch.from_numpy(x)).double()
            y64 = m64(torch.from_numpy(x).double())
        fwd_abs = float((y32 - y64).abs().max())
        fwd_rel = float((y32 - y64).norm() / y64.norm())
        loss_fn = get_preset(name, 5, 20, 6, "Shanghai").loss_fn
        l32, g32 = step(m32, torch.from_numpy(clip), loss_fn)
        l64, g64 = step(m64, torch.from_numpy(clip).double(), loss_fn)
        n32 = float(torch.sqrt(sum(g.square().sum() for g in g32)))
        n64 = float(torch.sqrt(sum(g.square().sum() for g in g64)))
        worst = max(float((a - b).norm() / b.norm()) for a, b in zip(g32, g64)
                    if b.norm() > 1e-4 * n64)
        names = [n for n, _ in m32.named_parameters()]
        vs_bound = max(float((a - b).norm()) / (2e-2 * float(b.norm()) + 1e-7 * n64)
                       for n, a, b in zip(names, g32, g64) if not exact_zero_gradient(n))
        noise = max((float((a - b).norm()) / n64 for n, a, b in zip(names, g32, g64)
                     if exact_zero_gradient(n)), default=0.0)
        print(f"{name} {size}^2 fp32 vs fp64: forward max_abs {fwd_abs:.3e}, rel L2 "
              f"{fwd_rel:.3e} (max |y| {float(y64.abs().max()):.3f}); step loss rel "
              f"{abs(l32 - l64) / abs(l64):.3e}, grad norm rel {abs(n32 - n64) / n64:.3e}, "
              f"worst tensor rel L2 {worst:.3e}, worst tensor over the step bound "
              f"{vs_bound:.3e}" + (f", parameters of exact gradient 0: "
                                   f"largest error {noise:.3e} of the global norm"
                                   if name in ("SmaATUnet", "TransUnet") else ""))


if __name__ == "__main__":
    main()
