"""Eager training-step time of the PyTorch port on one card, across source
trees, to compare two versions of the step in one run.

    python3 scripts/torch_step_time.py [--optimizers] [--ab] [--no-ddp] [--out DIR] ROOT ...

Each ROOT is a checkout of this repo (``.`` for this one; an older commit
unpacked with ``git archive``). For each ROOT, in the order given (parent,
change, change, parent shows a drift of the card's clock), a fresh process
imports that ROOT's ``adnm_tpu_torch``, builds K1 there, and times the
full-width duality ADNM-UNet (``create_adnm_unet(5, 20, 6)``, seeded weights,
the reference init, the ADNMUnet preset, refiner remat as the CLI has it,
synthetic 256^2 clips) through its own ``Trainer``:

* ``train_step`` at batch 1 and 4: median and min of 12 synchronised steps
  after 2, on the host's clock;
* at batch 1, the optimizer step alone (median of 5, after a step left its
  gradients) and the host-side profile of one step: the ops with the most
  self CPU time and the number of kernel launches (with ``--out DIR``, the
  profile's table of 80 ops in ``DIR/profile-<n>.txt``, n the ROOT's
  place in the list);
* the plain ``Trainer`` beside ``Trainer(ddp=True)`` at world size 1 (NCCL
  over ``tcp://localhost``) at batch 2: median and min of 6 steps after 2
  (``--no-ddp`` leaves it out).

With ``--optimizers`` a ROOT whose ``Trainer`` reads its LR from a device
tensor (``Trainer.set_schedule``) also times the batch-1 step and the
optimizer step with the Trainer's AdamW replaced by each form of it: foreach
at a float LR, foreach ``capturable`` at the tensor LR, and fused at the
tensor LR. With ``--ab`` such a ROOT also times, in one process and in
turns (4 steps of one, 4 of the other, 5 times), its ``train_step``
against the step as it was before the device-tensor LR and clip
(``clip_grad_norm_`` at a float threshold, then a foreach AdamW at a float
LR) on a second Trainer of the same weights, at batch 1. Each line starts
with the ROOT. Needs CUDA.
"""

from __future__ import annotations

import argparse
import os
import socket
import statistics
import subprocess
import sys
import time

IMG = 256
LR, CLIP = 1e-3, 0.025


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def host_ms(torch, run, n: int, warm: int) -> list:
    """Host-clock ms of ``n`` synchronised calls of ``run``, after ``warm``."""
    for _ in range(warm):
        run()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def summary(times: list) -> str:
    return f"median {statistics.median(times):.2f} ms, min {min(times):.2f} ms"


def child(root: str, label: str, optimizers: bool, ab: bool, ddp: bool, out_file: str) -> None:
    """The measurements of one ROOT, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from adnm_tpu_torch.cli.common import TASKS
    from adnm_tpu_torch.data.shanghai import _synthetic_clip
    from adnm_tpu_torch.device import resolve_device
    from adnm_tpu_torch.models.adnm_unet import apply_reference_init, create_adnm_unet
    from adnm_tpu_torch.ops import build_kernels
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset

    import adnm_tpu_torch

    if not os.path.abspath(adnm_tpu_torch.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"{label}: imported {adnm_tpu_torch.__file__}, not {root}'s")
    build_kernels(["rms_norm"])
    device = resolve_device("cuda")
    t_in, t_out, interval, _ = TASKS["Shanghai"]

    def trainer(**kwargs):
        torch.cuda.empty_cache()
        return Trainer(create_adnm_unet(t_in, t_out, interval),
                       get_preset("ADNMUnet", t_in, t_out, interval, "Shanghai"), t_in, device,
                       seed=0, param_transform=apply_reference_init, **kwargs)

    def batch(b: int):
        clips = np.stack([_synthetic_clip(np.random.default_rng(i), 25, IMG) for i in range(b)])
        return torch.from_numpy(clips[:, :, None]).to(device)

    def out(what: str) -> None:
        print(f"[{label}] {what}", flush=True)

    t = trainer()
    for b in (1, 4):
        x = batch(b)
        out(f"eager train_step batch {b}: "
            f"{summary(host_ms(torch, lambda: t.train_step(x, LR, CLIP), 12, 2))}")
    x = batch(1)
    t.train_step(x, LR, CLIP)
    out(f"optimizer.step alone (batch 1's gradients): "
        f"{summary(host_ms(torch, t.optimizer.step, 5, 1))}")
    profile_step(torch, lambda: t.train_step(x, LR, CLIP), out, out_file)

    if optimizers and hasattr(t, "set_schedule"):
        adamw = dict(betas=(0.9, 0.999), eps=t.preset.adam_eps,
                     weight_decay=t.optimizer.param_groups[0]["weight_decay"])
        forms = {"foreach, float LR": dict(lr=LR, foreach=True),
                 "foreach capturable, tensor LR": dict(lr=t.lr, foreach=True, capturable=True),
                 "fused, tensor LR": dict(lr=t.lr, fused=True)}
        for form, kwargs in forms.items():
            t = None
            t = trainer()
            t.optimizer = torch.optim.AdamW(t.params, **adamw, **kwargs)
            step = host_ms(torch, lambda: t.train_step(x, LR, CLIP), 8, 2)
            opt = host_ms(torch, t.optimizer.step, 5, 1)
            out(f"AdamW {form}: train_step batch 1 {summary(step)}; optimizer.step alone "
                f"{summary(opt)}")
    t = None

    if ab and hasattr(Trainer, "set_schedule"):
        in_turns(torch, trainer, x, out)

    if ddp:
        import torch.distributed as dist

        dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
        x = batch(2)
        for name, kwargs in (("plain", {}), ("DDP, NCCL, world size 1", {"ddp": True})):
            t = None
            t = trainer(**kwargs)
            out(f"train_step batch 2, {name}: "
                f"{summary(host_ms(torch, lambda: t.train_step(x, LR, CLIP), 6, 2))}")
        t = None
        dist.destroy_process_group()


def in_turns(torch, trainer, x, out) -> None:
    """``--ab``: the shipped step against the float-LR step, in turns."""
    shipped, before = trainer(), trainer()
    before.optimizer = torch.optim.AdamW(
        before.params, lr=LR, betas=(0.9, 0.999), eps=before.preset.adam_eps,
        weight_decay=before.optimizer.param_groups[0]["weight_decay"], foreach=True)

    def float_lr_step():
        before._backward(x, before._seeds()[0])
        torch.nn.utils.clip_grad_norm_(before.params, CLIP)
        before.optimizer.step()
        before.step += 1

    runs = {"shipped": lambda: shipped.train_step(x, LR, CLIP), "float LR": float_lr_step}
    times = {name: [] for name in runs}
    for run in runs.values():
        host_ms(torch, run, 0, 2)
    for _ in range(5):
        for name, run in runs.items():
            times[name] += host_ms(torch, run, 4, 0)
    out("in turns, batch 1: " + "; ".join(f"{name} {summary(t)}" for name, t in times.items()))


def profile_step(torch, run, out, out_file: str) -> None:
    """The host-side profile of one call of ``run``."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    launches = sum(r.count for r in rows if r.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                       "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    top = sorted(rows, key=lambda r: -r.self_cpu_time_total)[:14]
    out(f"profiled step batch 1: {launches} kernel launches; self CPU ms (calls): " + ", ".join(
        f"{r.key} {r.self_cpu_time_total / 1e3:.2f} ({r.count})" for r in top))
    if out_file:
        with open(out_file, "w") as f:
            f.write(rows.table(sort_by="self_cpu_time_total", row_limit=80))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--optimizers", action="store_true")
    p.add_argument("--ab", action="store_true")
    p.add_argument("--no-ddp", action="store_true")
    p.add_argument("--out", default="")
    p.add_argument("--out-file", default="", help=argparse.SUPPRESS)
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        (root,) = args.roots
        child(root, root, args.optimizers, args.ab, not args.no_ddp, args.out_file)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_step_time: CUDA is not available")
    print(f"card: {card_line()}; torch {torch.__version__}", flush=True)
    flags = [f for f, on in (("--optimizers", args.optimizers), ("--ab", args.ab),
                             ("--no-ddp", args.no_ddp)) if on]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failed = []
    for n, root in enumerate(args.roots):
        t0 = time.perf_counter()
        out_file = os.path.join(args.out, f"profile-{n}.txt") if args.out else ""
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", *flags,
                             "--out-file", out_file, root]).returncode
        print(f"[{root}] {time.perf_counter() - t0:.1f} s, exit {rc}", flush=True)
        if rc:
            failed.append(root)
    if failed:
        raise SystemExit(f"torch_step_time: failed for {failed}")


if __name__ == "__main__":
    main()
