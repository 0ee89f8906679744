"""``validate`` of the PyTorch port on meshes of this host's cards against
one process, to measure what a mesh buys and to check it agrees.

    python3 scripts/torch_mesh_validate.py [--synthetic-len N] [--img-size S] [--forwards] [--phase-6j] MESH ...

Each MESH is a ``--mesh`` spec (``data=2``, ``data=2,model=2``,
``data=1,seq=2``, ``data=1,seq=2,model=2``, ...); its ranks take a card
each over NCCL, so it needs ``data x seq x model`` visible cards. The full-width duality ADNM-UNet (``create_adnm_unet(5, 20, 6)``,
the seeded init and the reference init: no checkpoint) runs the synthetic
test split (``--synthetic-len 64``: 9 clips, batches 4, 4 and 1) through
``cli.validate.main`` once in this process, then once on each mesh. For
each run: the wall on the host's clock around the CLI call (the ranks'
start, each rank's model build and its kernels' load included: the
kernels are built once before), and for each mesh the largest difference
of its predictions from the single process's, whether the two printed
tables are identical, and the test losses. Each mesh is held to
``chip_smoke.py``'s phase 6j (a) checks: the predictions within
``MESH_DATA_ATOL['validate']`` on a 'data' axis alone, within
``MESH_ATOL['duality']`` with a 'model' axis (its partial sums) and
within ``SEQ_VALIDATE_ATOL`` with a 'seq' axis (phase 6k's bound), the
ground truths equal, the test loss within 1e-4 relative, and the table
identical where the predictions are bit-equal. Prints one line a run,
each with the card's name and power limit, then a JSON line of the
figures, and exits 1 if a mesh failed a check. With ``--forwards``, for
each mesh with a 'seq' or 'model' axis, ``forecast`` of the duality and
bimamba models at batch 4 on it over NCCL, a card a rank, against this
process's eager forward: each rank's largest difference (held to that
model's ``MESH_ATOL`` with a 'model' axis and its ``SEQ_ATOL`` with a
'seq' axis), wall (median of 3) and peak memory. With ``--phase-6j`` it
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
from typing import Optional

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def mesh_failures(mesh: str, got: dict, one: dict) -> list:
    """What ``got``, validate on ``mesh``, fails of phase 6j (a)'s checks
    against ``one``, one process's validate."""
    from adnm_tpu_torch.metrics import metrics_table

    tol = mesh_tolerance(mesh)
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


def mesh_tolerance(mesh: str, label: Optional[str] = None) -> float:
    """The bound of phase 6j (a), 6j (b) or 6k on ``mesh``: for validate's
    predictions without ``label``, else for the ``label`` model's
    forward."""
    import chip_smoke
    from adnm_tpu_torch.parallel import parse_mesh

    axes = parse_mesh(mesh, training=False)
    tol = chip_smoke.MESH_DATA_ATOL["validate"]
    if axes.get("model", 1) > 1:
        tol = max(tol, chip_smoke.MESH_ATOL[label or "duality"])
    if axes.get("seq", 1) > 1:
        tol = max(tol, chip_smoke.SEQ_VALIDATE_ATOL if label is None
                  else chip_smoke.SEQ_ATOL[label])
    return tol


def forward_rank(rank: int, world: int, device, mesh: str, out: str) -> None:
    """A rank of ``--forwards``: ``forecast`` of the duality and bimamba
    models at batch 4 on ``mesh``, its predictions, wall and peak memory."""
    import chip_smoke
    from adnm_tpu_torch.cli import predict as predict_cli
    from adnm_tpu_torch.parallel import make_mesh, parse_mesh

    axes = parse_mesh(mesh, training=False)
    dmesh = make_mesh(axes["data"], axes.get("seq", 1), axes.get("model", 1), device)
    x = chip_smoke.mesh_batch()
    rec = {}
    for label, kwargs in chip_smoke.MESH_CASES.items():
        model = predict_cli.load_model(None, device, **kwargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        preds = predict_cli.forecast(model, x, 4, device, mesh=dmesh)
        walls = chip_smoke.host_times(lambda: predict_cli.forecast(model, x, 4, device,
                                                                   mesh=dmesh), 3, warm=0)
        rec[label] = {"preds": preds, "wall_ms": float(np.median(walls)),
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        del model
        torch.cuda.empty_cache()
    torch.save(rec, os.path.join(out, f"rank{rank}.pt"))


def forwards(card: str, meshes: list) -> dict:
    """``--forwards``: each mesh's ranks over NCCL against this process's
    eager forward; the failures by mesh."""
    import chip_smoke
    from adnm_tpu_torch.cli import predict as predict_cli
    from adnm_tpu_torch.parallel import parse_mesh, spawn

    device = torch.device("cuda")
    one = {}
    for label, kwargs in chip_smoke.MESH_CASES.items():
        model = predict_cli.load_model(None, device, **kwargs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        preds = predict_cli.forecast(model, chip_smoke.mesh_batch(), 4, device, graphs=False)
        walls = chip_smoke.host_times(lambda: predict_cli.forecast(
            model, chip_smoke.mesh_batch(), 4, device, graphs=False), 3, warm=0)
        one[label] = {"preds": preds, "wall_ms": float(np.median(walls)),
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        del model
        torch.cuda.empty_cache()
    failures = {}
    for mesh in meshes:
        axes = parse_mesh(mesh, training=False)
        if axes.get("seq", 1) == axes.get("model", 1) == 1:
            continue
        world = axes["data"] * axes.get("seq", 1) * axes.get("model", 1)
        with tempfile.TemporaryDirectory() as out:
            spawn(forward_rank, world, args=(mesh, out), device="cuda", timeout_s=900)
            ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                     for r in range(world)]
        for label in chip_smoke.MESH_CASES:
            errs = [float(np.abs(r[label]["preds"] - one[label]["preds"]).max()) for r in ranks]
            print(f"[{card}] forecast {label} batch 4 on {mesh} (NCCL, a card a rank): "
                  f"max_abs_err per rank {[f'{e:.3e}' for e in errs]} (tol "
                  f"{mesh_tolerance(mesh, label):g}); wall per rank "
                  f"{[round(r[label]['wall_ms'], 1) for r in ranks]} ms against "
                  f"{one[label]['wall_ms']:.1f} ms eager in one process; peak per rank "
                  f"{[round(r[label]['peak_mib'], 1) for r in ranks]} MiB against "
                  f"{one[label]['peak_mib']:.1f} MiB")
            if not max(errs) <= mesh_tolerance(mesh, label):
                failures.setdefault(mesh, []).append(f"{label} forward {max(errs):.3e}")
    return failures


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("meshes", nargs="+")
    p.add_argument("--synthetic-len", type=int, default=64)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--phase-6j", action="store_true")
    p.add_argument("--forwards", action="store_true")
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
    if args.forwards:
        for mesh, failed in forwards(card, args.meshes).items():
            failures.setdefault(mesh, []).extend(failed)
    if failures:
        raise SystemExit(f"torch_mesh_validate: meshes disagree with one process: {failures}")
    if args.phase_6j:
        chip_smoke.mesh_inference_phase(card)


if __name__ == "__main__":
    main()
