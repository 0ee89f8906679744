"""How far the full-width ADNM-UNet's forward on the mesh's 'seq' axis lies
from one process's: ``forecast`` of the duality and bimamba models (the
seeded init, ``predict.load_model``) on a ('data', 'seq') = (1, S) mesh of
gloo ranks, each holding its band of rows, against the same forward in
this process, on the same seeded frames.

    python3 scripts/torch_seq_distance.py [--img-size 64] [--batch 2] [--seq 2] [--device cpu]

On ``--device cuda`` the ranks share card 0 over gloo. Prints each rank's
largest difference and the largest |prediction| per model. The bounds of
``chip_smoke.py``'s phase 6k (``SEQ_ATOL``) were set from its CPU
readings at 64^2.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {"duality": {}, "bimamba": {"linear_attn_duality": False}}


def frames(batch: int, size: int) -> np.ndarray:
    return np.random.RandomState(11).rand(batch, 5, 1, size, size).astype(np.float32)


def rank_main(rank: int, world: int, device, args, out: str) -> None:
    from adnm_tpu_torch.cli.predict import forecast, load_model
    from adnm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, world, device=device)
    x = frames(args.batch, args.img_size)
    torch.save({label: forecast(load_model(None, device, img_size=args.img_size, **kw), x,
                                args.batch, device, mesh=mesh, graphs=False)
                for label, kw in CASES.items()}, os.path.join(out, f"rank{rank}.pt"))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=2)
    p.add_argument("--device", default="cpu")
    args = p.parse_args()
    from adnm_tpu_torch.cli.predict import forecast, load_model
    from adnm_tpu_torch.device import resolve_device
    from adnm_tpu_torch.parallel import spawn

    device = resolve_device(args.device)
    x = frames(args.batch, args.img_size)
    one = {label: forecast(load_model(None, device, img_size=args.img_size, **kw), x,
                           args.batch, device, graphs=False) for label, kw in CASES.items()}
    with tempfile.TemporaryDirectory() as out:
        spawn(rank_main, args.seq, args=(args, out), device=args.device, backend="gloo",
              shared_device=True, timeout_s=1800)
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(args.seq)]
    for label in CASES:
        errs = [float(np.abs(r[label] - one[label]).max()) for r in ranks]
        print(f"{label} {args.img_size}^2 batch {args.batch} on seq={args.seq} ({device}): "
              f"max_abs_err per rank {errs}, max |prediction| {np.abs(one[label]).max():.4f}")


if __name__ == "__main__":
    main()
