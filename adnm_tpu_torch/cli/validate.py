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
"""

from __future__ import annotations

import argparse

from adnm_tpu_torch.cli.common import add_common_args, build, resolve_ckpt, single_card
from adnm_tpu_torch.metrics import SimplifiedEvaluator, print_metrics


def main(argv=None) -> dict:
    """Returns the evaluator's results ("metrics"), the test loss, the
    collected predictions and ground truths ((N, T_out, S, S) arrays) and
    the trainer."""
    p = argparse.ArgumentParser("adnm-torch-validate")
    add_common_args(p)
    p.add_argument("--ckpt", default=None, help="checkpoint file (default: the best under --root)")
    args = p.parse_args(argv)

    single_card(args, "validate")
    trainer, (_, _, test_loader), (_, to, _, thresholds) = build(args)
    ckpt_path = resolve_ckpt(args.ckpt, args.root,
                             "checkpoint not found ({}); evaluating fresh init",
                             args.dataset, args.model)
    if ckpt_path:
        trainer.load(ckpt_path)
        print(f"loaded checkpoint: {ckpt_path}")
    test_loss, preds, gts = trainer.eval_epoch(test_loader, collect=True)
    evaluator = SimplifiedEvaluator(seq_len=to, value_scale=90, thresholds=thresholds,
                                    device=trainer.device)
    evaluator.evaluate(preds, gts)  # reference orientation (validate.py:117)
    results = evaluator.done()
    print_metrics(results, pod=True)
    return {"metrics": results, "test_loss": test_loss, "preds": preds, "gts": gts,
            "trainer": trainer}


if __name__ == "__main__":
    main()
