"""The training loop (counterpart of adnm_tpu/train/loop.py; reference:
train.py:107-250), on one device.

One step per batch: forward, loss, backward (with gradient accumulation
over ``accum_steps`` microbatches), the global fp32 gradient norm, the
preset's clip (ADNMUnet's adaptive one; the baselines do not clip), the
epoch's LR and the preset's optimizer step (AdamW, Adam or SGD). With
``compute_dtype`` bfloat16 (the JAX package's ``--bf16``) the activations
run in bf16 while the parameters, their gradients and the optimizer state
stay fp32, and the loss is computed in fp32. The model is in train mode
for a step and in eval mode for evaluation, so BatchNorm normalises with
the batch's statistics and advances its running statistics (once per
microbatch) in a step, and uses the running statistics in evaluation.
Dropout and DropPath (TransUnet, SwinUnet) draw their masks from the
trainer's own generator on the device, seeded from (seed, step,
microbatch) at the start of each training forward, so a step is a function
of the state and the step number; under whole-forward remat the recompute
re-seeds it and draws the same masks. The backward runs with cuDNN held to its
deterministic algorithms, so two steps of one batch give the same bits on
the card. LR and clip threshold are
host-side scalars set per epoch, as in the reference's per-epoch Python
schedules (train.py:122-130,186-191). Losses and gradient norms stay on
the device until the epoch ends, so the host never waits for a step.

As in the JAX package, validation consumes the val batches (the
reference re-evaluates the last training batch, train.py:159-160).

Data parallelism (``ddp=True``, inside a process group; JAX: a 'data'
mesh): every rank steps on its rows of one global batch. The model runs
under ``DistributedDataParallel``, which averages the gradients over the
ranks (micro-batches before the last run under ``no_sync``); the loss is
all-reduced to the global batch's; BatchNorm takes the global batch's
statistics and Dropout and DropPath keep each rank's rows of the global
batch's masks, so a step on N ranks is the single process's step on the
global batch, up to the order of the sums. The ADNM-UNet carries gates
that its forward never reads; DDP's reducer would wait for their gradients
for ever, so they are found once, from the autograd graph of a batch-1
forward at the first step, and left out of its buckets: every rank gives
them the same zero gradient. With ``zero1`` the optimizer state is sharded
over the ranks (``ZeroRedundancyOptimizer``). Evaluation runs the whole
val and test sets on every rank (the JAX package's multi-host choice:
every rank then holds the same losses, with the single process's batches
and tails), and every decision of ``fit`` (best checkpoint, early stop,
the next epoch's clip threshold) comes from values that are the same on
every rank: rank 0's val and test losses, broadcast, and the gradient norm
of the averaged gradients. Rank 0 alone writes checkpoints and metrics.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import inspect
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from adnm_tpu_torch.core.layers import seeded_init_, sync_batch_norm
from adnm_tpu_torch.core.stochastic import attach_generator, step_seed
from adnm_tpu_torch.data.loader import device_prefetch, to_device
from adnm_tpu_torch.device import deterministic_cudnn
from adnm_tpu_torch.parallel.multihost import host_barrier
from adnm_tpu_torch.train import checkpoint as ckpt
from adnm_tpu_torch.train.presets import TrainPreset
from adnm_tpu_torch.utils.logging import MetricsLogger


@dataclasses.dataclass
class EpochLog:
    epoch: int
    train_loss: float
    val_loss: float
    test_loss: float
    lr: float
    grad_norm_avg: float
    clip_threshold: float
    clip_ratio: float
    seconds: float


# DDP broadcasts no buffers before a forward: BatchNorm's running statistics
# move alike on every rank (its statistics are the global batch's). Newer
# torch names the switch forward_sync_buffers and deprecates the old name.
NO_BUFFER_SYNC = ({"forward_sync_buffers": False}
                  if "forward_sync_buffers" in inspect.signature(DistributedDataParallel).parameters
                  else {"broadcast_buffers": False})


class TrainForward(nn.Module):
    """The training forward of one micro-batch: the Dropout and DropPath
    generator seeded first, and under ``remat`` the whole forward
    recomputed in the backward (``torch.utils.checkpoint``), re-seeding it.
    The module that DDP wraps, so that the recompute runs inside DDP's
    forward and not through it again."""

    def __init__(self, model: nn.Module, generator: torch.Generator, remat: bool):
        super().__init__()
        self.model = model
        self.generator = generator
        self.remat = remat

    def forward(self, x: torch.Tensor, seed: int) -> torch.Tensor:
        def run(x):
            self.generator.manual_seed(seed)
            return self.model(x)

        if self.remat and torch.is_grad_enabled():
            return checkpoint(run, x, use_reentrant=False)
        return run(x)


def unreached_parameters(net: nn.Module, *inputs) -> list:
    """The names of ``net``'s parameters that its output does not depend
    on: those with no AccumulateGrad node in the autograd graph of an
    eval-mode forward of ``inputs``. The mode is restored after."""
    was_training = net.training
    net.eval()
    try:
        with torch.enable_grad():
            out = net(*inputs)
        reached, seen, stack = set(), set(), [out.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            if hasattr(fn, "variable"):
                reached.add(id(fn.variable))
            stack.extend(f for f, _ in fn.next_functions)
    finally:
        net.train(was_training)
    return [name for name, p in net.named_parameters() if id(p) not in reached]


class Trainer:
    def __init__(self, model: nn.Module, preset: TrainPreset, input_frames: int,
                 device: torch.device, seed: int = 0,
                 param_transform: Optional[Callable[[nn.Module, torch.Generator], nn.Module]] = None,
                 remat_forward: bool = False, accum_steps: int = 1,
                 compute_dtype: torch.dtype = torch.float32, ddp: bool = False,
                 zero1: bool = False):
        """The model's weights come from the init seeded with ``seed``
        (``seeded_init_``, on the CPU), then ``param_transform(model,
        generator seeded with seed + 1)`` (``apply_reference_init`` for
        ADNMUnet); then the model moves to ``device``.

        ``remat_forward=True`` runs the whole training forward under
        ``torch.utils.checkpoint``: the backward recomputes it instead of
        keeping activations; the gradients are the same. Ignored for a
        model with BatchNorm, as in JAX: the recompute would advance its
        running statistics a second time.

        ``accum_steps=m`` (m > 1) splits each batch into m equal
        microbatches, runs them one after another and averages their
        gradients before one optimizer step: activation memory drops about
        m-fold. Exact for the reference losses, which are elementwise
        means. Needs batch % accum_steps == 0.

        ``compute_dtype`` is the activations' dtype (float32, or bfloat16
        as the JAX ``--bf16``); a model configuration that cannot compute in
        it (``check_compute_dtype``) raises here, before any work.

        ``ddp=True`` trains data-parallel over the default process group
        (``parallel.init_multihost``): each rank passes its rows of every
        global batch (``BatchLoader(row_shard=...)``), all ranks as many,
        and builds the Trainer from the same seed. ``zero1`` then shards
        the optimizer state over the ranks (ZeRO-1; no effect on one
        rank). The Trainer's ``rank`` and ``world`` are 0 and 1 without
        ``ddp``."""
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        check = getattr(model, "check_compute_dtype", None)
        if check is not None:
            check(compute_dtype)
        self.compute_dtype = compute_dtype
        self.model = model
        self.preset = preset
        self.input_frames = input_frames
        self.device = device
        self.has_batch_stats = any(getattr(m, "batch_stats", ()) for m in model.modules())
        self.remat_forward = remat_forward and not self.has_batch_stats
        self.accum_steps = int(accum_steps)
        seeded_init_(model, seed)
        if param_transform is not None:
            param_transform(model, torch.Generator().manual_seed(seed + 1))
        model.to(device)
        self.seed = seed
        self.ddp = ddp
        if ddp and not dist.is_initialized():
            raise RuntimeError("Trainer(ddp=True) needs a process group: "
                               "adnm_tpu_torch.parallel.init_multihost first")
        self.rank, self.world = (dist.get_rank(), dist.get_world_size()) if ddp else (0, 1)
        self.generator = torch.Generator(device=device)  # Dropout and DropPath masks
        attach_generator(model, self.generator, (self.rank, self.world) if ddp else None)
        if ddp:
            sync_batch_norm(model)
        self.forward_net = TrainForward(model, self.generator, self.remat_forward)
        self._ddp_net = None  # built at the first step (unreached_parameters needs a batch)
        self.unreached = None  # names of the parameters the loss does not reach, under ddp
        self.params = list(model.parameters())
        self.zero1 = zero1 and ddp and self.world > 1  # ZeRO-1 shards nothing on one rank
        self.optimizer = preset.make_optimizer(self.params, zero1=self.zero1)
        self.step = 0

    # ---- one batch ----------------------------------------------------

    def _split_batch(self, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(imgs, targets) from a (B, T_in+T_out, 1, S, S) batch, in one of
        two wire formats: float (already in [0, 1]) or uint8 (round(x*255),
        brought back to [0, 1] on the device). The images come in the
        compute dtype, the targets in fp32, with JAX's arithmetic: uint8
        images are cast and then multiplied by 1/255 rounded to the compute
        dtype."""
        t, cdt = self.input_frames, self.compute_dtype
        if batch.is_floating_point():
            return batch[:, :t].to(cdt), batch[:, t:]
        scale = float(torch.tensor(1.0 / 255.0, dtype=cdt))  # 1/255 in cdt
        return batch[:, :t].to(cdt) * scale, batch[:, t:].to(torch.float32) * (1.0 / 255.0)

    def _forward(self, imgs: torch.Tensor, micro: int = 0) -> torch.Tensor:
        """The training forward of microbatch ``micro`` of this step, its
        masks drawn from the generator seeded at its start (again in the
        remat's recompute); through DDP under ``ddp``."""
        net = self._net(imgs) if self.ddp else self.forward_net
        return net(imgs, step_seed(self.seed, self.step, micro))

    def _net(self, imgs: torch.Tensor) -> DistributedDataParallel:
        """The DDP module, built at the first step: the parameters that a
        batch-1 forward of ``imgs`` does not reach stay out of its buckets.
        Its construction broadcasts rank 0's parameters (already equal:
        the same seed or checkpoint on every rank)."""
        if self._ddp_net is None:
            self.unreached = unreached_parameters(self.forward_net, imgs[:1], 0)
            DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
                self.forward_net, self.unreached)
            # each gradient is copied into the all-reduce's bucket and then
            # becomes a view of it: no copy back out of the bucket a step
            self._ddp_net = DistributedDataParallel(
                self.forward_net, device_ids=[self.device] if self.device.type == "cuda" else None,
                gradient_as_bucket_view=True, **NO_BUFFER_SYNC)
        return self._ddp_net

    def _backward(self, batch: torch.Tensor) -> torch.Tensor:
        """The batch's loss, with its gradients in the parameters' ``grad``
        (the mean over the microbatches, and under ``ddp`` over the ranks:
        the global batch's). A parameter the loss does not reach gets a
        zero gradient, as in JAX, so AdamW still decays it. Runs the model
        in train mode."""
        self.model.train()
        imgs, targets = self._split_batch(batch)
        m = self.accum_steps
        if imgs.shape[0] % m:
            raise ValueError(f"batch {imgs.shape[0]} not divisible by accum_steps {m}")
        for p in self.params:
            p.grad = None
        loss = torch.zeros((), device=imgs.device)
        for i, (im, tg) in enumerate(zip(imgs.chunk(m), targets.chunk(m))):
            # the gradients are averaged over the ranks after the last micro-batch
            sync = not self.ddp or i == m - 1
            with contextlib.nullcontext() if sync else self._net(im).no_sync():
                part = self.preset.loss_fn(self._forward(im, i).float(), tg)
                with deterministic_cudnn():  # the convolutions' dgrad and wgrad
                    part.backward()
            loss = loss + part.detach()
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            elif m > 1:
                p.grad.div_(m)
        loss = loss / m
        if self.ddp:  # the global batch's loss, the same on every rank
            dist.all_reduce(loss)
            loss = loss / self.world
        return loss

    def grads(self, batch: np.ndarray) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {parameter name: gradient}) of one host batch, with no
        optimizer step."""
        loss = self._backward(to_device(batch, self.device))
        # copies: under DDP the gradients are views of its buckets, which the
        # next step overwrites
        return loss, {name: p.grad.clone() for name, p in self.model.named_parameters()}

    def train_step(self, batch: torch.Tensor, lr: float,
                   clip_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, global gradient norm) on the device, after one step: under
        the preset's ``norm_clip`` the gradients scaled by min(1, clip_norm
        / (norm + 1e-6)), then the optimizer at ``lr``. Without it the
        gradients are not scaled (the norm is still computed, for the
        log)."""
        loss = self._backward(batch)
        # the same scale: clip_grad_norm_ multiplies by clamp(max_norm /
        # (norm + 1e-6), max=1), which is exactly 1 at max_norm = inf
        max_norm = clip_norm if self.preset.norm_clip else float("inf")
        gnorm = nn.utils.clip_grad_norm_(self.params, max_norm)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        return loss, gnorm

    @torch.no_grad()
    def eval_step(self, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, predictions) in eval mode."""
        self.model.eval()
        imgs, targets = self._split_batch(batch)
        out = self.model(imgs).float()
        return self.preset.loss_fn(out, targets), out

    # ---- loops ----------------------------------------------------------

    def train_epoch(self, loader, lr: float, clip_norm: float) -> Dict[str, float]:
        losses, gnorms = [], []
        for batch in device_prefetch(loader, self.device):
            loss, gnorm = self.train_step(batch, lr, clip_norm)
            losses.append(loss)
            gnorms.append(gnorm)
        losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        gnorms = torch.stack(gnorms).cpu().numpy() if gnorms else np.zeros(0, np.float32)
        n = int(losses.size)
        clip_count = int(np.sum(gnorms > clip_norm)) if self.preset.norm_clip else 0
        return {
            "loss": float(losses.sum()),
            "avg_grad_norm": float(gnorms.mean()) if n else 0.0,
            "clip_ratio": clip_count / max(n, 1),
            "steps": n,
        }

    def predict(self, batch: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, predictions) for one host batch."""
        return self.eval_step(to_device(batch, self.device))

    def eval_epoch(self, loader, collect: bool = False):
        """(summed loss, predictions, ground truths); the last two are None
        unless ``collect``, else (N, T_out, S, S) fp32 arrays, the ground
        truths in [0, 1]."""
        losses, preds, gts = [], [], []
        for batch in device_prefetch(loader, self.device):
            loss, out = self.eval_step(batch)
            losses.append(loss)
            if collect:
                preds.append(out[:, :, 0].cpu().numpy())
                g = batch[:, self.input_frames:, 0].cpu().numpy()
                if np.issubdtype(g.dtype, np.integer):
                    # uint8 wire: back to [0, 1] with the JAX package's
                    # arithmetic (a division, not the step's product with
                    # 1/255, which can differ in the last bit and so put
                    # floor(x * 90) across a threshold)
                    g = g.astype(np.float32) / 255.0
                gts.append(g)
        total = float(torch.stack(losses).sum().cpu()) if losses else 0.0
        if not collect:
            return total, None, None
        if not preds:
            return total, np.zeros((0,)), np.zeros((0,))
        return total, np.concatenate(preds), np.concatenate(gts)

    def fit(self, train_loader, val_loader, test_loader=None, epochs: Optional[int] = None,
            ckpt_path: Optional[str] = None, metrics_path: Optional[str] = None,
            save_every: Optional[int] = None):
        """The reference's epochs: LR (``preset.lr``) and clip threshold (0
        when the preset does not clip) from the preset, train, validate,
        save the best checkpoint (past the save-epoch gate where the preset
        has one), early stop where the preset does; the test loss every
        epoch when there is a test loader. ``save_every=N`` also writes
        {ckpt_path}_epoch{E} every N epochs, keeping the last two."""
        preset = self.preset
        epochs = epochs or preset.epochs
        lead = self.rank == 0  # prints, and writes the metrics
        jsonl = MetricsLogger(metrics_path, echo=False) if metrics_path and lead else None
        best = float("inf")
        prev_avg_grad_norm = 0.0
        early_stop_count = 0
        logs = []
        for epoch in range(1, epochs + 1):
            t0 = time.time()
            lr = preset.lr(epoch, epochs)
            clip_norm = (preset.clip_schedule.threshold(epoch, prev_avg_grad_norm)
                         if preset.norm_clip else 0.0)
            tr = self.train_epoch(train_loader, lr, clip_norm)
            prev_avg_grad_norm = tr["avg_grad_norm"]

            val_loss = self._agreed(self.eval_epoch(val_loader)[0])
            save_gate = not preset.save_epoch_gated or epoch > preset.save_epoch
            if save_gate and val_loss < best:
                best = val_loss
                early_stop_count = 0
                if ckpt_path:
                    self.save(ckpt_path)
                if lead:
                    print(f"epoch {epoch}: best_val_loss {val_loss:.6f} (saved)")
            else:
                if preset.if_early_stop and save_gate:
                    early_stop_count += 1
                if lead:
                    print(f"epoch {epoch}: val_loss {val_loss:.6f}")

            if save_every and ckpt_path and epoch % save_every == 0:
                self.save(f"{ckpt_path}_epoch{epoch}")
                if lead:
                    snaps = sorted(glob.glob(f"{ckpt_path}_epoch*"),
                                   key=lambda p: int(p.rsplit("epoch", 1)[1]))
                    for old in snaps[:-2]:
                        os.remove(old)

            test_loss = 0.0
            if test_loader is not None:
                test_loss = self._agreed(self.eval_epoch(test_loader)[0])

            dt = time.time() - t0
            logs.append(EpochLog(epoch, tr["loss"], val_loss, test_loss, lr, tr["avg_grad_norm"],
                                 clip_norm, tr["clip_ratio"], dt))
            if jsonl is not None:
                jsonl.log(epoch=epoch, train_loss=tr["loss"], val_loss=val_loss,
                          test_loss=test_loss, lr=lr, grad_norm=tr["avg_grad_norm"],
                          clip_threshold=clip_norm, clip_ratio=tr["clip_ratio"],
                          steps=tr["steps"], seconds=dt)
            if lead:
                print(f"epoch {epoch}: train_loss {tr['loss']:.6f} test_loss {test_loss:.6f} "
                      f"lr {lr:.2e} grad_norm {tr['avg_grad_norm']:.4f} "
                      f"clip_thr {clip_norm:.4f} clip_ratio {tr['clip_ratio']:.3f} ({dt:.1f}s)")
            if preset.if_early_stop and preset.early_stop and \
                    early_stop_count >= preset.early_stop:
                if lead:
                    print(f"early stop at epoch {epoch}")
                break
        return logs

    def _agreed(self, value: float) -> float:
        """``value`` as rank 0 holds it, on every rank (under ``ddp``): a
        decision taken from it is then the same everywhere, as the next
        collective needs."""
        if not self.ddp:
            return value
        t = torch.tensor([value], dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return float(t.item())

    # ---- state ----------------------------------------------------------

    def state_dict(self) -> dict:
        """The model's state (its own keys, without DDP's), the optimizer's
        and the step. Under ZeRO-1 only rank 0 can give it, after every rank
        has called ``optimizer.consolidate_state_dict(to=0)`` (``save``
        does both); it then has the layout of the plain optimizer's."""
        return {"params": self.model.state_dict(), "opt_state": self.optimizer.state_dict(),
                "step": self.step}

    def save(self, path: str) -> None:
        """Write the checkpoint at ``path``. Under ``ddp`` every rank calls
        it: ZeRO-1 first gathers the optimizer state on rank 0, rank 0
        writes, and the others wait for the file. One file for any world
        size, with or without ZeRO-1."""
        if self.zero1:
            self.optimizer.consolidate_state_dict(to=0)
        if self.rank == 0:
            ckpt.save_state(path, self.state_dict())
        host_barrier(f"adnm:saved:{path}")

    def load(self, ckpt_path: str) -> None:
        """Restore parameters (with BatchNorm's running statistics),
        optimizer state and step from a checkpoint, written at any world
        size, with or without ZeRO-1; under ``ddp`` every rank reads it
        (under ZeRO-1 each keeps its share of the optimizer state)."""
        state = ckpt.restore_state(ckpt_path, {"params": self.model.state_dict(),
                                               "opt_state": None, "step": self.step})
        ckpt.load_model_state(self.model, state["params"], ckpt_path)
        if state["opt_state"] is not None:
            self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
