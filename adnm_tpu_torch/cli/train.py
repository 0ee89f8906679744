"""Train a nowcasting model (counterpart of adnm_tpu/cli/train.py;
reference: train.py).

    python -m adnm_tpu_torch.cli.train --synthetic --epochs 1 [--model NAME] [--dataset LAPS] [--device cpu] [--bf16]

Trains ``--model`` (default ADNMUnet, ``create_adnm_unet(5, 20, 6)``, or
``create_adnm_unet(5, 3, 60)`` for LAPS; or the baselines SmaATUnet,
ConvLSTM, TrajGRU, LPTQPN, TransUnet and SwinUnet) on the Shanghai or
LAPS task with the model's preset: ADNMUnet with en_rainfall loss, adaptive
gradient clipping and AdamW; ConvLSTM and TrajGRU with weighted MSE+MAE
and Adam on a multistep LR; LPTQPN with MSE+MAE and AdamW on a cosine LR;
SmaATUnet with MSE+MAE and SGD with momentum on a poly LR (none of the
baselines clips; their best checkpoint is saved from epoch 1).
Checkpoints go to {root}/model_params/{dataset}/{model}/{model}_best and
per-epoch metrics to {root}/results/{dataset}/{model}_train.jsonl. Ends
with the reference's final protocol (train.py:209-250): reload the best
checkpoint, run the test split, and print CSI/HSS per threshold and
FAR/RMSE/SSIM/LPIPS; for LAPS, ``laps_evaluate``'s CSI/POD/HSS/FAR per
threshold on the flattened predictions (train.py:233-235). ``--device``
defaults to cuda and raises when CUDA is absent. ``--bf16`` trains with
bf16 activations and fp32 parameters and optimizer state; its checkpoints
are the same fp32 files.
"""

from __future__ import annotations

import argparse
import contextlib
import os

from adnm_tpu_torch.cli.common import add_common_args, build
from adnm_tpu_torch.data.laps import laps_evaluate
from adnm_tpu_torch.metrics import SimplifiedEvaluator, print_metrics
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
from adnm_tpu_torch.utils.profiling import profile_trace


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("adnm-torch-train")
    add_common_args(p)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--no-final-eval", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="restore the full train state (params, optimizer, step) from the "
                        "best checkpoint before training")
    p.add_argument("--save-every", type=int, default=None,
                   help="also write rotating epoch snapshots every N epochs")
    p.add_argument("--accum-steps", type=int, default=1, metavar="M",
                   help="gradient accumulation: split each batch into M equal microbatches, "
                        "one optimizer step on the averaged gradients (batch-size %% M == 0)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the training run with torch.profiler into DIR/trace.json "
                        "(Chrome trace; utils.profiling.profile_trace)")
    return p


def main(argv=None) -> dict:
    """Runs the training; returns the trainer, the epoch logs, the best
    checkpoint's test loss and its evaluator results ("metrics";
    ``laps_evaluate``'s dict for LAPS); the last two are None with
    --no-final-eval."""
    args = make_parser().parse_args(argv)
    trainer, (train_loader, val_loader, test_loader), (_, to, _, thresholds) = build(args)
    ckpt_path = best_ckpt_dir(args.root, args.dataset, args.model)
    if args.resume and os.path.exists(ckpt_path):
        trainer.load(ckpt_path)
        print(f"resumed from {ckpt_path} (step {trainer.step})")
    print(f"model {args.model}  params {sum(p.numel() for p in trainer.params):,}  "
          f"device {trainer.device}")
    metrics_path = os.path.join(args.root, "results", args.dataset, f"{args.model}_train.jsonl")
    prof = profile_trace(args.profile) if args.profile else contextlib.nullcontext()
    with prof:
        logs = trainer.fit(train_loader, val_loader, test_loader, epochs=args.epochs,
                           ckpt_path=ckpt_path, metrics_path=metrics_path,
                           save_every=args.save_every)
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    result = {"trainer": trainer, "logs": logs, "test_loss": None, "metrics": None}
    if args.no_final_eval:
        return result
    print("-----------------test best-----------------")
    if os.path.exists(ckpt_path):
        trainer.load(ckpt_path)
    result["test_loss"], preds, gts = trainer.eval_epoch(test_loader, collect=True)
    print(f"best-checkpoint test loss: {result['test_loss']}")
    if args.dataset == "LAPS":  # reference orientation (train.py:235)
        result["metrics"] = laps_evaluate(preds, gts, thresholds)
        return result
    evaluator = SimplifiedEvaluator(seq_len=to, value_scale=90, thresholds=thresholds,
                                    device=trainer.device)
    evaluator.evaluate(preds, gts)  # reference orientation (train.py:241)
    result["metrics"] = evaluator.done()
    print_metrics(result["metrics"])
    return result


if __name__ == "__main__":
    main()
