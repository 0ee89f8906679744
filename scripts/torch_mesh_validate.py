"""``validate`` of the PyTorch port on meshes of this host's cards against
one process, to measure what a mesh buys and to check it agrees.

    python3 scripts/torch_mesh_validate.py [--synthetic-len N] [--img-size S] [--phase-6j] MESH ...

Each MESH is a ``--mesh`` spec (``data=2``, ``data=2,model=2``, ...); its
ranks take a card each over NCCL, so it needs ``data x model`` visible
cards. The full-width duality ADNM-UNet (``create_adnm_unet(5, 20, 6)``,
the seeded init and the reference init: no checkpoint) runs the synthetic
test split (``--synthetic-len 64``: 9 clips, batches 4, 4 and 1) through
``cli.validate.main`` once in this process, then once on each mesh. For
each run: the wall on the host's clock around the CLI call (the ranks'
start, each rank's model build and its kernels' load included: the
kernels are built once before), and for each mesh the largest difference
of its predictions from the single process's, whether the two printed
tables are identical, and the test losses. Each mesh is held to
``chip_smoke.py``'s phase 6j (a) checks: the predictions within
``MESH_DATA_ATOL['validate']`` on a 'data' axis alone and within
``MESH_ATOL['duality']`` with a 'model' axis (its partial sums), the
ground truths equal, the test loss within 1e-4 relative, and the table
identical where the predictions are bit-equal. Prints one line a run,
each with the card's name and power limit, then a JSON line of the
figures, and exits 1 if a mesh failed a check. With ``--phase-6j`` it
then runs ``chip_smoke.py``'s phase 6j (``mesh_inference_phase``) alone,
which on two or more cards also runs the model=2 forwards over NCCL, a
card a rank. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mesh_failures(mesh: str, got: dict, one: dict) -> list:
    """What ``got``, validate on ``mesh``, fails of phase 6j (a)'s checks
    against ``one``, one process's validate."""
    import chip_smoke
    from adnm_tpu_torch.metrics import metrics_table
    from adnm_tpu_torch.parallel import parse_mesh

    tol = (chip_smoke.MESH_ATOL["duality"]
           if parse_mesh(mesh, training=False).get("model", 1) > 1
           else chip_smoke.MESH_DATA_ATOL["validate"])
    failed = []
    if got["preds"].shape != one["preds"].shape:
        return [f"predictions of shape {got['preds'].shape}, not {one['preds'].shape}"]
    err = float(np.abs(got["preds"] - one["preds"]).max())
    if not err <= tol:
        failed.append(f"predictions max_abs_err {err:.3e} above {tol:g}")
    if not np.array_equal(got["gts"], one["gts"]):
        failed.append("ground truths differ")
    if abs(got["test_loss"] - one["test_loss"]) > 1e-4 * abs(one["test_loss"]):
        failed.append(f"test loss {got['test_loss']} against {one['test_loss']}")
    if (np.array_equal(got["preds"], one["preds"]) and metrics_table(got["metrics"], pod=True)
            != metrics_table(one["metrics"], pod=True)):
        failed.append("bit-equal predictions, other table")
    return failed


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("meshes", nargs="+")
    p.add_argument("--synthetic-len", type=int, default=64)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--phase-6j", action="store_true")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_mesh_validate: CUDA is not available")
    import chip_smoke
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.metrics import metrics_table
    from adnm_tpu_torch.ops import build_kernels

    card = chip_smoke.card_line().splitlines()[0]
    build_kernels(("rms_norm", "ssd_scan") if args.phase_6j else ("rms_norm",))
    failures = {}
    with tempfile.TemporaryDirectory() as root:
        cli = ["--synthetic", "--synthetic-len", str(args.synthetic_len), "--batch-size", "4",
               "--img-size", str(args.img_size), "--root", root]
        t0 = time.perf_counter()
        one = validate_cli.main(cli)
        walls = {"one process": time.perf_counter() - t0}
        print(f"[{card}] validate, one process ({torch.cuda.device_count()} cards visible): "
              f"{walls['one process']:.2f} s wall, {one['preds'].shape[0]} clips, test loss "
              f"{one['test_loss']:.8f}")
        figures = {"one process": {"wall_s": walls["one process"]}}
        for mesh in args.meshes:
            t0 = time.perf_counter()
            got = validate_cli.main([*cli, "--mesh", mesh])
            wall = time.perf_counter() - t0
            err = float(np.abs(got["preds"] - one["preds"]).max())
            same = (metrics_table(got["metrics"], pod=True)
                    == metrics_table(one["metrics"], pod=True))
            failed = mesh_failures(mesh, got, one)
            if failed:
                failures[mesh] = failed
            figures[mesh] = {"wall_s": wall, "max_abs_err": err, "tables_identical": same,
                             "test_loss": got["test_loss"], "failed": failed}
            print(f"[{card}] validate --mesh {mesh}: {wall:.2f} s wall against "
                  f"{walls['one process']:.2f} s in one process; predictions max_abs_err "
                  f"{err:.3e}; tables {'identical' if same else 'DIFFER'}; test loss "
                  f"{got['test_loss']:.8f}; {'; '.join(failed) if failed else 'checks passed'}")
    print(json.dumps({"card": card, "validate": figures}))
    if failures:
        raise SystemExit(f"torch_mesh_validate: meshes disagree with one process: {failures}")
    if args.phase_6j:
        chip_smoke.mesh_inference_phase(card)


if __name__ == "__main__":
    main()
