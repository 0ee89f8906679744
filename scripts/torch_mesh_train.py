"""Training of the PyTorch port on meshes of this host's cards against one
process: the counterpart of ``scripts/torch_mesh_validate.py`` for the
training step.

    python3 scripts/torch_mesh_train.py [--rows R] [--steps K] [--zero1] MESH ...

Each MESH is a training ``--mesh`` spec with at most two axes larger than
1 (``data=2,seq=2``, ``data=2,model=2``, ``data=1,seq=4``, ...); its
ranks take a card each over NCCL, so it needs ``data x seq x model``
visible cards. On each mesh, ``chip_smoke.py``'s
``mesh_training_records``: K steps (``--steps``, 2 by default) of the
full-width duality and bimamba ADNM-UNet at 256^2 (``create_adnm_unet(5,
20, 6)``, the seeded and reference init) on a global batch of R rows a
'data' position (``--rows``, 2 by default), each 'data' position its rows,
with ``--zero1`` ZeRO-1 over 'data'; rank 0 first runs one process's
steps on the whole batch. Each mesh is held to phase 6l's checks
(``check_mesh_training``): the loss, the gradient norm and every gradient
within ``STEP_TOL`` of one process's, the parameters within 2 lr a step,
the ranks bit-equal, each rank's kernel launches a step counted and
traced, bytes over each split axis in the forward and the backward.
Prints one line a mesh and model with the card's name and power limit, the
step walls and peak memories beside one process's, then a JSON line of the
figures, and exits 1 if a mesh failed a check. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def train_rank(rank: int, world: int, device, axes: tuple, rows: int, steps: int, zero1: bool,
               out: str) -> None:
    """A rank of one mesh: ``mesh_training_records`` on it."""
    import chip_smoke

    batch = torch.from_numpy(chip_smoke.train_batch(rows * axes[0])).to(device)
    rec = chip_smoke.mesh_training_records(rank, device, {"mesh": axes}, batch,
                                           chip_smoke.kernel_counts(), zero1, steps)
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("meshes", nargs="+")
    p.add_argument("--rows", type=int, default=2)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--zero1", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_train: CUDA is not available")
    import chip_smoke
    from adnm_tpu_torch.ops import build_kernels
    from adnm_tpu_torch.parallel import parse_mesh, spawn

    card = chip_smoke.card_line().splitlines()[0]
    build_kernels(("rms_norm", "ssd_scan"))
    figures, failures = {}, {}
    for spec in args.meshes:
        sizes = parse_mesh(spec)
        axes = (sizes["data"], sizes.get("seq", 1), sizes.get("model", 1))
        world = axes[0] * axes[1] * axes[2]
        if world > torch.cuda.device_count():
            raise SystemExit(f"torch_mesh_train: {spec} takes {world} cards, "
                             f"{torch.cuda.device_count()} visible")
        with tempfile.TemporaryDirectory() as out:
            spawn(train_rank, world, args=(axes, args.rows, args.steps, args.zero1, out),
                  device="cuda", timeout_s=1800)
            ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                     for r in range(world)]
        try:
            res = chip_smoke.check_mesh_training(card, ranks, {spec: axes},
                                                 f"NCCL, a card a rank, {args.rows} rows a "
                                                 f"'data' position"
                                                 f"{', ZeRO-1' if args.zero1 else ''}")
        except AssertionError as e:
            failures[spec] = str(e)
            print(f"[{card}] train --mesh {spec}: FAILED: {e}")
            continue
        figures[spec] = {k.split(" ", 1)[1]: v for k, v in res.items()}
    print(json.dumps({"card": card, "train": figures}))
    if failures:
        raise SystemExit(f"torch_mesh_train: meshes disagree with one process: {failures}")


if __name__ == "__main__":
    main()
