"""Train the ADNM-UNet (counterpart of adnm_tpu/cli/train.py; reference:
train.py).

    python -m adnm_tpu_torch.cli.train --synthetic --epochs 1 [--device cpu]

Trains ``create_adnm_unet(5, 20, 6)`` (the Shanghai task) with the
ADNMUnet preset: en_rainfall loss, adaptive gradient clipping, AdamW.
Checkpoints go to {root}/model_params/{dataset}/{model}/{model}_best and
per-epoch metrics to {root}/results/{dataset}/{model}_train.jsonl. Ends
with the reference's final protocol, reload the best checkpoint and run
the test split, as far as the port has it: the test loss. The
CSI/HSS/FAR table needs the evaluator, which is not ported yet.
``--device`` defaults to cuda and raises when CUDA is absent.
"""

from __future__ import annotations

import argparse
import os

from adnm_tpu_torch.cli.common import add_common_args, build
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir


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
    return p


def main(argv=None) -> dict:
    """Runs the training; returns the trainer, the epoch logs and the
    best checkpoint's test loss (None with --no-final-eval)."""
    args = make_parser().parse_args(argv)
    trainer, (train_loader, val_loader, test_loader) = build(args)
    ckpt_path = best_ckpt_dir(args.root, args.dataset, args.model)
    if args.resume and os.path.exists(ckpt_path):
        trainer.load(ckpt_path)
        print(f"resumed from {ckpt_path} (step {trainer.step})")
    print(f"model {args.model}  params {sum(p.numel() for p in trainer.params):,}  "
          f"device {trainer.device}")
    metrics_path = os.path.join(args.root, "results", args.dataset, f"{args.model}_train.jsonl")
    logs = trainer.fit(train_loader, val_loader, test_loader, epochs=args.epochs,
                       ckpt_path=ckpt_path, metrics_path=metrics_path,
                       save_every=args.save_every)
    result = {"trainer": trainer, "logs": logs, "test_loss": None}
    if args.no_final_eval:
        return result
    print("-----------------test best-----------------")
    if os.path.exists(ckpt_path):
        trainer.load(ckpt_path)
    result["test_loss"], _, _ = trainer.eval_epoch(test_loader)
    print(f"best-checkpoint test loss: {result['test_loss']}")
    print("CSI/HSS/FAR/RMSE/SSIM: not reported, the evaluator is not ported yet")
    return result


if __name__ == "__main__":
    main()
