"""Validate a trained model (counterpart of adnm_tpu/cli/validate.py;
reference: validate.py).

    python -m adnm_tpu_torch.cli.validate --synthetic --ckpt PATH [--model NAME] [--dataset LAPS] [--device cpu] [--bf16]

Loads a checkpoint of the port's train CLI for ``--model`` (``--ckpt``,
else the model's best checkpoint under ``--root``; with BatchNorm's
running statistics), runs the test split and prints CSI, POD and
HSS per threshold and FAR/RMSE/SSIM/LPIPS (for LAPS over its 3 frames at
its thresholds, with the Shanghai task's value scale of 90, as the JAX
package's validate does). Without a checkpoint it
evaluates the fresh init. ``--device`` defaults to cuda and raises when
CUDA is absent. With ``--bf16`` the model runs in bf16 and the evaluator
receives its predictions in fp32.

On a mesh of this host (the JAX package's flags), the same table:

    python -m adnm_tpu_torch.cli.validate --synthetic --ckpt PATH --mesh data=2 --device cpu          # 2 CPU ranks, gloo
    python -m adnm_tpu_torch.cli.validate --synthetic --ckpt PATH --mesh data=2,model=2               # 4 cards, NCCL
    python -m adnm_tpu_torch.cli.validate --synthetic --ckpt PATH --mesh data=1,seq=2 --device cpu    # 2 CPU ranks, a band each
    python -m adnm_tpu_torch.cli.validate --synthetic --ckpt PATH --data-parallel                     # every visible card

Each 'data' position evaluates its rows of every test batch, the ranks of
a position split the ADNM-UNet's frame rows in bands over 'seq' and the
heads and hidden channels over 'model', and rank 0 gathers the
predictions in order and prints the table. ``--coordinator``
exits: collection stays on one host, as in JAX.
"""

from __future__ import annotations

import argparse

from adnm_tpu_torch.cli.common import (add_common_args, build, inference_launch, resolve_ckpt,
                                       run_on_mesh)
from adnm_tpu_torch.metrics import SimplifiedEvaluator, print_metrics


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adnm-torch-validate")
    add_common_args(p)
    p.add_argument("--ckpt", default=None, help="checkpoint file (default: the best under --root)")
    return p


def main(argv=None) -> dict:
    """Returns the evaluator's results ("metrics"), the test loss, the
    collected predictions and ground truths ((N, T_out, S, S) arrays) and
    the trainer; on a mesh, rank 0's, without the trainer."""
    args = make_parser().parse_args(argv)
    launch = inference_launch(args, "validate")
    return run(args) if launch is None else run_on_mesh(run, args, launch)


def run(args, mesh=None, device=None) -> dict:
    """Validate in this process, one rank of ``mesh`` where given: every rank
    evaluates its rows, rank 0 prints the table (the others return no
    metrics)."""
    trainer, (_, _, test_loader), (_, to, _, thresholds) = build(args, device=device, mesh=mesh)
    lead = trainer.rank == 0
    ckpt_path = resolve_ckpt(args.ckpt, args.root,
                             "checkpoint not found ({}); evaluating fresh init",
                             args.dataset, args.model)
    if ckpt_path:
        trainer.load(ckpt_path)
        if lead:
            print(f"loaded checkpoint: {ckpt_path}")
    test_loss, preds, gts = trainer.eval_epoch(test_loader, collect=True)
    results = None
    if lead:
        evaluator = SimplifiedEvaluator(seq_len=to, value_scale=90, thresholds=thresholds,
                                        device=trainer.device)
        evaluator.evaluate(preds, gts)  # reference orientation (validate.py:117)
        results = evaluator.done()
        print_metrics(results, pod=True)
    return {"metrics": results, "test_loss": test_loss, "preds": preds, "gts": gts,
            "trainer": trainer}


if __name__ == "__main__":
    main()
