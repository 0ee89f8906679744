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
are the same fp32 files. ``--scan-steps K`` runs K steps per dispatch: on
the card one CUDA graph replay of K whole steps (the first group eagerly,
captured), the same bits as K steps; validation and the final protocol
replay the eval forward's graph on the card in any case.

Data-parallel training (the JAX package's mesh flags; one rank per card):

    python -m adnm_tpu_torch.cli.train --synthetic --data-parallel            # every visible card
    python -m adnm_tpu_torch.cli.train --synthetic --mesh data=2 --device cpu # 2 CPU ranks, gloo
    python -m adnm_tpu_torch.cli.train --synthetic --mesh data=2,seq=2        # 4 cards: bands
    python -m adnm_tpu_torch.cli.train --synthetic --mesh data=1,model=2 --zero1 --device cpu
    python -m adnm_tpu_torch.cli.train --synthetic --data-parallel \
        --coordinator HOST:PORT --num-processes P --process-id I  # in each of P processes
    torchrun --nproc-per-node 8 -m adnm_tpu_torch.cli.train --synthetic --data-parallel

``--batch-size`` is the global batch under a single launch (split over the
ranks) and each process's rows under ``--coordinator`` or torchrun, as in
JAX; ``--zero1`` shards the optimizer state over the 'data' ranks. A
'seq' axis splits the ADNM-UNet's frame rows in bands over its ranks, a
'model' axis the heads and hidden channels (the other models compute whole
on each 'seq' rank, and split only their FeedForwards over 'model'); at
most two axes are larger than 1, as in JAX. The ranks train the single
process's model on the global batch; rank 0 writes the checkpoints (one
file for any mesh, which one process resumes, and the other way round). Validation and the test split run sharded: each
rank evaluates its rows of every batch; under a single launch rank 0
gathers the predictions and runs the final protocol; a multi-host run
prints the test loss and defers the metrics to ``validate`` on one host.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
from typing import Optional

import torch

from adnm_tpu_torch.cli.common import Launch, add_common_args, build, parallel_launch
from adnm_tpu_torch.data.laps import laps_evaluate
from adnm_tpu_torch.device import resolve_device
from adnm_tpu_torch.metrics import SimplifiedEvaluator, print_metrics
from adnm_tpu_torch.ops import build_kernels
from adnm_tpu_torch.parallel import (finish_multihost, host_barrier, init_multihost, make_mesh,
                                     spawn)
from adnm_tpu_torch.parallel.mesh import NOT_PORTED
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
    p.add_argument("--scan-steps", type=int, default=1, metavar="K",
                   help="run K train steps per device dispatch (one CUDA graph replay over K "
                        "stacked batches on the card): same step math/order (bit for bit), but "
                        "per-step host dispatch stops gating the device - throughput win when "
                        "the host is slow relative to the step (single-process only)")
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
    --no-final-eval. Under ``--data-parallel`` or ``--mesh`` (a single
    launch) it starts one process per rank and returns rank 0's results
    without the trainer."""
    args = make_parser().parse_args(argv)
    launch = parallel_launch(args)
    if launch is None:
        return run(args)
    if args.scan_steps > 1:
        raise SystemExit("--scan-steps > 1 under data-parallel training is not supported: the "
                         "global batch and the first collective are per batch; use "
                         "--scan-steps 1 (the graphed step across ranks is not ported yet, "
                         f"{NOT_PORTED})")
    kernels = torch.device(args.device).type == "cuda" and args.model == "ADNMUnet"
    if launch.multihost:  # this process is one rank
        local = local_rank(args)
        device = resolve_device(args.device, local)
        init_multihost(args.coordinator, args.num_processes, args.process_id, device)
        if kernels and local == 0:
            build_kernels(("rms_norm",))  # once a host; its other ranks wait, then load
        host_barrier("adnm:kernels")
        # A failed rank leaves without the teardown barrier: the others may
        # wait in a collective, and the barrier would only hold this process.
        result = run(args, launch, device)
        finish_multihost()
        return result
    if kernels:
        build_kernels(("rms_norm",))  # here, once, not once a rank
    with tempfile.TemporaryDirectory(prefix="adnm-train-") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        spawn(_rank_main, launch.world, args=(args, launch, out), device=args.device)
        return torch.load(out, weights_only=False)  # written by rank 0 of this run


def local_rank(args) -> int:
    """The card of this process in a multi-host run: LOCAL_RANK where the
    launcher sets it, else the process's rank modulo the visible cards."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = args.process_id if args.process_id is not None else int(os.environ["RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def _rank_main(rank: int, world: int, device: torch.device, args, launch: Launch,
               out: str) -> None:
    result = run(args, launch, resolve_device(args.device, device.index))
    if rank == 0:
        torch.save({k: v for k, v in result.items() if k != "trainer"}, out)


def run(args, launch: Optional[Launch] = None, device=None) -> dict:
    """The training and the final protocol in this process: one process,
    or one rank of ``launch`` (on its ('data', 'seq', 'model') mesh)."""
    ddp = launch is not None
    mesh = None
    if ddp and (launch.seq > 1 or launch.model > 1):
        mesh = make_mesh(launch.world // (launch.seq * launch.model), launch.seq, launch.model,
                         device)
    trainer, (train_loader, val_loader, test_loader), (_, to, _, thresholds) = build(
        args, ddp=ddp, rows=launch.rows if ddp else None, device=device, mesh=mesh)
    lead = trainer.rank == 0
    ckpt_path = best_ckpt_dir(args.root, args.dataset, args.model)
    if args.resume and os.path.exists(ckpt_path):
        trainer.load(ckpt_path)
        if lead:
            print(f"resumed from {ckpt_path} (step {trainer.step})")
    if lead:
        print(f"model {args.model}  params {sum(p.numel() for p in trainer.params):,}  "
              f"device {trainer.device}  ranks {trainer.world}")
    metrics_path = os.path.join(args.root, "results", args.dataset, f"{args.model}_train.jsonl")
    profile = args.profile
    if profile and trainer.world > 1:
        profile = os.path.join(profile, f"rank{trainer.rank}")
    prof = profile_trace(profile) if profile else contextlib.nullcontext()
    with prof:
        logs = trainer.fit(train_loader, val_loader, test_loader, epochs=args.epochs,
                           ckpt_path=ckpt_path, metrics_path=metrics_path,
                           save_every=args.save_every)
    if profile and lead:
        print(f"profiler trace written to {args.profile}")
    result = {"trainer": trainer, "logs": logs, "test_loss": None, "metrics": None}
    if args.no_final_eval:
        return result
    if lead:
        print("-----------------test best-----------------")
    if os.path.exists(ckpt_path):
        trainer.load(ckpt_path)
    if ddp and launch.multihost:
        # prediction collection is a single-card workflow: a multi-host run
        # reports the loss and defers the metrics to validate (as in JAX)
        result["test_loss"] = trainer._agreed(trainer.eval_epoch(test_loader)[0])
        if lead:
            print(f"best-checkpoint test loss: {result['test_loss']}")
            print("multi-host run: metrics need prediction collection - run "
                  "`python -m adnm_tpu_torch.cli.validate` on one card against "
                  f"{ckpt_path}")
        return result
    # every rank evaluates its rows of the test split; rank 0 holds the
    # gathered predictions and runs the evaluator
    result["test_loss"], preds, gts = trainer.eval_epoch(test_loader, collect=True)
    if lead:
        final_protocol(result, preds, gts, args.dataset, to, thresholds, trainer.device)
    host_barrier("adnm:final-eval")
    return result


def final_protocol(result: dict, preds, gts, dataset: str, t_out: int, thresholds,
                   device) -> None:
    """The reference's final protocol (train.py:209-250) on the test split's
    predictions and ground truths, into ``result``."""
    print(f"best-checkpoint test loss: {result['test_loss']}")
    if dataset == "LAPS":  # reference orientation (train.py:235)
        result["metrics"] = laps_evaluate(preds, gts, thresholds)
        return
    evaluator = SimplifiedEvaluator(seq_len=t_out, value_scale=90, thresholds=thresholds,
                                    device=device)
    evaluator.evaluate(preds, gts)  # reference orientation (train.py:241)
    result["metrics"] = evaluator.done()
    print_metrics(result["metrics"])


if __name__ == "__main__":
    main()
