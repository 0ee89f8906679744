"""How far the port's bf16 compute is from its fp32, on the CPU: the
yardstick of ``chip_smoke.py``'s bf16 bounds (``BF16_FORWARD_REL``,
``BF16_STEP_REL``, ``BASELINE_BF16_REL``: 4 times these distances, rounded
up).

    python3 scripts/torch_bf16_distance.py [--img-size 32] [CONFIG ...]

For the full-width ADNM-UNet ``create_adnm_unet(5, 20, 6)`` of each
configuration (duality, bimamba, mla), from the weights the smoke uses
(the serving init seeded with 0, ``predict.load_model(None, ...)``; the
trainer's seeded and reference init, ``chip_smoke.make_trainer``), and for
each of the six baselines at its published width (SmaATUnet, ConvLSTM,
TrajGRU, LPTQPN, TransUnet, SwinUnet; the serving init, and the train
CLI's trainer with the dropout and DropPath rates at 0,
``chip_smoke.baseline_trainer``): the relative L2 distance of the bf16
predictions from the fp32 ones for a forward of 2 random clips, and of a
batch-1 step's loss and global gradient norm in bf16 compute from fp32
(the smoke's training clip). Runs on the CPU with one intra-op thread.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from adnm_tpu_torch.cli import predict  # noqa: E402
from chip_smoke import (  # noqa: E402
    ALL_BASELINES,
    BIMAMBA,
    MLA,
    baseline_trainer,
    gnorm,
    grads_of,
    make_trainer,
    train_batch,
)

CONFIGS = {"duality": {}, "bimamba": BIMAMBA, "mla": MLA,
           **{name: {"model_name": name} for name in ALL_BASELINES}}


def rel(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main() -> None:
    p = argparse.ArgumentParser("torch_bf16_distance")
    p.add_argument("--img-size", type=int, default=32)
    p.add_argument("configs", nargs="*", default=list(CONFIGS), help=", ".join(CONFIGS))
    args = p.parse_args()
    size, cpu = args.img_size, torch.device("cpu")
    torch.set_num_threads(1)
    x = np.random.RandomState(0).rand(2, 5, 1, size, size).astype(np.float32)
    batch = train_batch(1, size)
    for name in args.configs:
        kw = CONFIGS[name]
        if "model_name" in kw:
            kw = {**kw, "img_size": size}
        preds = {dt: predict.forecast(predict.load_model(None, cpu, compute_dtype=dt, **kw), x, 2,
                                      cpu, compute_dtype=dt)
                 for dt in (torch.float32, torch.bfloat16)}
        trainer = (baseline_trainer(name, cpu, size, rates0=True) if "model_name" in kw
                   else make_trainer(cpu, **kw))
        steps = {}
        for dt in (torch.float32, torch.bfloat16):
            trainer.compute_dtype = dt  # read by _split_batch alone
            steps[dt] = grads_of(trainer, batch)
        (l32, g32), (l16, g16) = steps[torch.float32], steps[torch.bfloat16]
        print(f"{name} {size}^2 bf16 vs fp32: forward of 2 clips rel L2 "
              f"{rel(preds[torch.bfloat16], preds[torch.float32]):.3e}; batch-1 step loss rel "
              f"{abs(l16 - l32) / abs(l32):.3e}, global grad norm rel "
              f"{abs(gnorm(g16) - gnorm(g32)) / gnorm(g32):.3e}")


if __name__ == "__main__":
    main()
