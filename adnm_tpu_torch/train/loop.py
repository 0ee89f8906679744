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
the card. LR and clip threshold are set per epoch, as in the reference's
per-epoch Python schedules (train.py:122-130,186-191), into two fp32
device tensors that the optimizer and the clip read on the device (Adam
and AdamW fused and ``capturable`` on the card, SGD as
``presets.TensorLRSGD``), so no step reads a host value. Losses and
gradient norms stay on the device until the epoch ends, so the host never
waits for a step.

Single dispatch (JAX: ``jax.jit`` of every step and forward, and
``scan_steps``' ``lax.scan``): with ``scan_steps=K`` the epoch stacks K
batches into one (K, B, ...) group (``data.loader.grouped``, one
host-to-device copy) and runs its K steps (forward, loss, backward with
the accumulation, the global norm, the clip, the optimizer) as one CUDA
graph replay on the card (``utils.graphs``): the first group of a shape
runs its K steps eagerly and captures them, every later one replays. The
stragglers of an epoch run one step at a time; on the CPU the same K
steps run eagerly. A replay draws the Dropout and DropPath masks of its
steps (and of their recompute under remat) from generator states seeded
with ``step_seed`` before it, so a graphed step gives the eager step's
bits. The eval forward (``eval_step``, ``predict``, ``eval_epoch``)
replays one graph per (batch shape, its dtype, compute dtype) on the card
likewise. A step's graph is also keyed by the compute dtype, the remat and
the accumulation, so a Trainer whose settings change captures anew. Graphs
are the default on a card and off on the CPU; under data parallelism
``scan_steps`` > 1 raises (as JAX's does under multi-host) and each rank
replays its own graph of the eval forward, which has no collective there;
on a 'seq' or 'model' axis larger than 1 the eval forward runs eagerly
(its collectives run over gloo between ranks that share a card, which a
CUDA graph cannot capture).

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
over the ranks (``ZeroRedundancyOptimizer``). Every decision of ``fit``
(best checkpoint, early stop, the next epoch's clip threshold) comes from
values that are the same on every rank: rank 0's val and test losses,
broadcast, and the gradient norm of the averaged gradients. Rank 0 alone
writes checkpoints and metrics.

Evaluation on a mesh (``mesh``, a ``parallel.make_mesh``; under ``ddp`` the
('data', 'model') = (ranks, 1) mesh; JAX: the Trainer's mesh and its
``_mesh_ctx``): every rank reads the single process's batches, each
'data' position runs its rows of a batch (a tail that does not divide
leaves some positions fewer rows, or none: those ranks still join every
collective), the ranks of one position run the same rows with the heads
and hidden channels split over 'model' (``parallel/tensor.py``), and the
predictions are gathered in order: by ``eval_step`` and ``predict`` on
every rank, by ``eval_epoch(collect=True)`` on rank 0 alone, which alone
holds the split's predictions and ground truths. Those predictions, and
each batch's loss on every rank, the mean over the whole batch (each
position's loss weighted by its rows), are the single process's up to the
order of the sums. On a 'seq' axis the ranks of a position run the same
rows, each its band of every frame (``models/adnm_unet.py``), and the
ADNM-UNet gathers its prediction over 'seq' before it returns, so the
loss and the gathers over 'data' see whole frames on every rank.

Training on a mesh (``ddp=True`` with ``mesh``; JAX: the Trainer on a
('data', 'seq') or ('data', 'model') mesh): the training forward, its
remat recompute and the backward run under the mesh, every rank a
'data' position's rows of the global batch (``data_rank``,
``data_world``), its 'seq' and 'model' ranks the same rows. Each rank
back-propagates its own loss, the collectives' backwards being their
exact adjoints (``parallel/tensor.py``): the gradients that the S M ranks
of one 'data' position hold sum to S M times the position's gradient, and
DistributedDataParallel's average over all D S M ranks gives the global
batch's mean gradient for every parameter, split or replicated. The loss
is averaged over 'data' alone; BatchNorm's statistics, the Dropout and
DropPath masks' rows and ZeRO-1's shards are the 'data' group's, so the
'seq' and 'model' ranks of a position stay replicas. On the CPU the ranks
are gloo processes (``parallel.spawn``); on the card, a card a rank over
NCCL, or gloo ranks sharing one card. A mesh with three axes larger than
1 trains nowhere, as in JAX (``parallel.mesh.TRAINING_AXES``), and such
training runs eagerly: ``scan_steps`` > 1 there raises
(``parallel.mesh.NOT_PORTED``).
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
from adnm_tpu_torch.data.loader import device_prefetch, grouped, to_device
from adnm_tpu_torch.device import deterministic_cudnn
from adnm_tpu_torch.parallel.mesh import NOT_PORTED, check_training_mesh, make_mesh
from adnm_tpu_torch.parallel.multihost import host_barrier
from adnm_tpu_torch.parallel.tensor import (axis_rank, axis_size, data_rows, gather_data,
                                            in_mesh_state, sum_data, use_mesh)
from adnm_tpu_torch.train import checkpoint as ckpt
from adnm_tpu_torch.train.presets import CARD_ADAM, TrainPreset
from adnm_tpu_torch.utils.graphs import GraphSet
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
    forward and not through it again.

    ``seed`` is the generator's seed (an int, set on the host), or, in a
    CUDA graph's capture, the (forward, recompute) pair of generator states
    that the graph registers and the Trainer seeds with that int before
    each replay: the generator is pointed at the first for the forward and
    at the second for the recompute, each drawing from offset 0 as after
    ``manual_seed``."""

    def __init__(self, model: nn.Module, generator: torch.Generator, remat: bool, mesh=None):
        super().__init__()
        self.model = model
        self.generator = generator
        self.remat = remat
        self.mesh = mesh  # active around the forward and its recompute

    def forward(self, x: torch.Tensor, seed) -> torch.Tensor:
        states = iter(seed) if isinstance(seed, tuple) else None

        def run(x):
            if states is None:
                self.generator.manual_seed(seed)
            else:
                self.generator.graphsafe_set_state(next(states))
            return self.model(x)

        with use_mesh(self.mesh):
            if self.remat and torch.is_grad_enabled():
                # preserve_rng_state=False: the masks come from the Trainer's
                # own generator, which ``run`` seeds again, and nothing draws
                # from the default generators; stashing their states would
                # read the card's on the host, which a CUDA graph capture
                # refuses. The recompute runs under the forward's mesh.
                return checkpoint(in_mesh_state(run), x, use_reentrant=False,
                                  preserve_rng_state=False)
            return run(x)


def portable_optimizer_state(state: dict) -> dict:
    """An optimizer's state dict in the checkpoints' one form, whichever
    device and mode it comes from: each group's LR a float and its
    ``capturable`` and ``fused`` flags at their defaults (where the
    optimizer has them), Adam's step counts on the CPU: the form of an eager
    Trainer's AdamW on the CPU. A ``Trainer`` adopts it into its own mode
    (``load``), so a file written on the card, after graphed steps or not,
    loads into a Trainer on the CPU, and the other way round."""
    groups = [{**g, "lr": float(g["lr"]),
               **{k: v for k, v in (("capturable", False), ("fused", None)) if k in g}}
              for g in state["param_groups"]]
    per_param = {i: {k: v.cpu() if k == "step" else v for k, v in st.items()}
                 for i, st in state["state"].items()}
    return {**state, "state": per_param, "param_groups": groups}


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
                 zero1: bool = False, scan_steps: int = 1, mesh=None):
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
        ``ddp``.

        ``scan_steps=k`` (k > 1) runs k steps per dispatch (JAX's
        ``scan_steps``): ``train_epoch`` stacks k batches into a group and
        ``train_steps`` runs its k steps as one CUDA graph replay on the
        card, eagerly on the CPU; the same steps, bit for bit. Not under
        ``ddp``.

        ``mesh`` (a ``parallel.make_mesh`` over the process group) shards
        evaluation over its 'data' axis, the frames' rows over its 'seq'
        axis and the heads and hidden channels over its 'model' axis;
        without ``ddp`` the Trainer then evaluates and predicts but does not
        train; with it, it trains on that mesh (a ('data', 'seq') or
        ('data', 'model') mesh: see the module's docstring). Under ``ddp``
        without one, it runs on the (ranks, 1, 1) mesh."""
        if accum_steps < 1 or scan_steps < 1:
            raise ValueError("scan_steps and accum_steps must be >= 1")
        if ddp:
            check_training_mesh(mesh)
        if scan_steps > 1 and (axis_size(mesh, "seq") > 1 or axis_size(mesh, "model") > 1):
            raise NotImplementedError(f"scan_steps > 1 on a 'seq' or 'model' axis larger than 1: "
                                      f"training there runs eagerly (the graphed step across "
                                      f"ranks is not ported yet, {NOT_PORTED})")
        if scan_steps > 1 and ddp:
            raise NotImplementedError(
                "scan_steps > 1 under data-parallel training is not supported: the "
                "global-batch assembly and the first collective are per batch "
                "(parallel/multihost.py); use scan_steps=1, the per-rank dispatch already "
                "overlaps the collectives there")
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
        self.scan_steps = int(scan_steps)
        seeded_init_(model, seed)
        if param_transform is not None:
            param_transform(model, torch.Generator().manual_seed(seed + 1))
        model.to(device)
        self.seed = seed
        self.ddp = ddp
        if ddp and not dist.is_initialized():
            raise RuntimeError("Trainer(ddp=True) needs a process group: "
                               "adnm_tpu_torch.parallel.init_multihost first")
        if mesh is not None and not dist.is_initialized():
            raise RuntimeError("Trainer(mesh=...) needs a process group: "
                               "adnm_tpu_torch.parallel.init_multihost first")
        self.mesh = (make_mesh(dist.get_world_size(), device=device) if ddp and mesh is None
                     else mesh)
        self.rank, self.world = ((dist.get_rank(), dist.get_world_size())
                                 if ddp or mesh is not None else (0, 1))
        # this rank's 'data' position and their number: its rows of a global batch
        self.data_rank, self.data_world = (axis_rank(self.mesh, "data"),
                                           axis_size(self.mesh, "data"))
        self.generator = torch.Generator(device=device)  # Dropout and DropPath masks
        attach_generator(model, self.generator,
                         (self.data_rank, self.data_world) if ddp else None)
        if ddp:
            sync_batch_norm(model, self.mesh.get_group("data"))
        self.forward_net = TrainForward(model, self.generator, self.remat_forward,
                                        self.mesh if ddp else None)
        self._ddp_net = None  # built at the first step (unreached_parameters needs a batch)
        self.unreached = None  # names of the parameters the loss does not reach, under ddp
        self.params = list(model.parameters())
        # ZeRO-1 over the 'data' ranks; it shards nothing on one
        self.zero1 = zero1 and ddp and self.data_world > 1
        # the epoch's LR and clip threshold, read on the device (``set_schedule``)
        self.lr = torch.zeros((), dtype=torch.float32, device=device)
        self.clip = torch.full((), float("inf"), dtype=torch.float32, device=device)
        self.optimizer = preset.make_optimizer(
            self.params, zero1=self.zero1, lr=self.lr,
            process_group=self.mesh.get_group("data") if self.zero1 else None)
        self.step = 0
        self.graphs = GraphSet(device) if device.type == "cuda" else None
        self._step_states = []  # (forward, recompute) generator states of a group's steps

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

    def _forward(self, imgs: torch.Tensor, seed=None) -> torch.Tensor:
        """The training forward of a microbatch, its masks drawn from the
        generator seeded with ``seed`` (by default this step's first
        microbatch's) at its start, again in the remat's recompute
        (``TrainForward``); through DDP under ``ddp``."""
        net = self._net(imgs) if self.ddp else self.forward_net
        return net(imgs, self._seeds()[0][0] if seed is None else seed)

    def _seeds(self, steps: int = 1) -> list:
        """The generator seeds of the next ``steps`` steps' microbatches."""
        return [[step_seed(self.seed, self.step + i, j) for j in range(self.accum_steps)]
                for i in range(steps)]

    def _net(self, imgs: torch.Tensor) -> DistributedDataParallel:
        """The DDP module, built at the first step: the parameters that a
        batch-1 forward of ``imgs`` does not reach stay out of its buckets.
        Its construction broadcasts rank 0's parameters (already equal:
        the same seed or checkpoint on every rank)."""
        if self._ddp_net is None:
            # under the mesh, whose collectives the forward runs (TrainForward)
            self.unreached = unreached_parameters(self.forward_net, imgs[:1], 0)
            DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
                self.forward_net, self.unreached)
            # each gradient is copied into the all-reduce's bucket and then
            # becomes a view of it: no copy back out of the bucket a step
            self._ddp_net = DistributedDataParallel(
                self.forward_net, device_ids=[self.device] if self.device.type == "cuda" else None,
                gradient_as_bucket_view=True, **NO_BUFFER_SYNC)
        return self._ddp_net

    def _backward(self, batch: torch.Tensor, seeds: list) -> torch.Tensor:
        """The batch's loss, with its gradients in the parameters' ``grad``
        (the mean over the microbatches, and under ``ddp`` over the ranks:
        the global batch's). A parameter the loss does not reach gets a
        zero gradient, as in JAX, so AdamW still decays it. Runs the model
        in train mode; ``seeds`` holds each microbatch's (``_forward``)."""
        if self.mesh is not None and not self.ddp:
            raise RuntimeError("a Trainer on an evaluation mesh (mesh without ddp) does not "
                               "train: its ranks would step apart")
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
                part = self.preset.loss_fn(self._forward(im, seeds[i]).float(), tg)
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
            loss = sum_data(self.mesh, loss) / self.data_world
        return loss

    def grads(self, batch: np.ndarray) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(loss, {parameter name: gradient}) of one host batch, with no
        optimizer step."""
        loss = self._backward(to_device(batch, self.device), self._seeds()[0])
        # copies: under DDP the gradients are views of its buckets, which the
        # next step overwrites
        return loss, {name: p.grad.clone() for name, p in self.model.named_parameters()}

    def set_schedule(self, lr: float, clip_norm: float) -> None:
        """The LR and the clip threshold of the steps that follow, written
        into their device tensors (no wait for the device); the threshold
        is infinite where the preset does not clip."""
        self.lr.fill_(lr)
        self.clip.fill_(clip_norm if self.preset.norm_clip else float("inf"))

    def _step(self, batch: torch.Tensor, seeds: list) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step on the device, reading ``self.lr`` and ``self.clip``
        there: (loss, global gradient norm). The gradients are scaled by
        min(1, clip / (norm + 1e-6)), ``clip_grad_norm_``'s scale, exactly 1
        at an infinite threshold; then the optimizer."""
        loss = self._backward(batch, seeds)
        grads = [p.grad for p in self.params]
        # Under DDP the gradients are views into its buckets, at any offset.
        # The foreach norm sums a 16-byte-aligned tensor in another order
        # than a misaligned one, so the norm reads aligned copies of the
        # misaligned views (their magnitudes, in one foreach call): it then
        # has the single process's bits.
        gnorm = nn.utils.get_total_norm(self._aligned(grads) if self.ddp else grads, 2.0)
        torch._foreach_mul_(grads, torch.clamp(self.clip / (gnorm + 1e-6), max=1.0))
        self.optimizer.step()
        return loss, gnorm

    @staticmethod
    def _aligned(grads: list) -> list:
        """``grads`` with each tensor that does not start on 16 bytes
        replaced by a new tensor of its absolute values."""
        odd = [i for i, g in enumerate(grads) if g.data_ptr() % 16]
        out = list(grads)
        if odd:
            for i, a in zip(odd, torch._foreach_abs([grads[i] for i in odd])):
                out[i] = a
        return out

    def _steps(self, group: torch.Tensor, seeds: list) -> Tuple[torch.Tensor, torch.Tensor]:
        """The steps of the (K, B, ...) ``group``, one after another:
        (losses, norms), each (K,)."""
        out = [self._step(batch, s) for batch, s in zip(group, seeds)]
        return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])

    def train_step(self, batch: torch.Tensor, lr: float,
                   clip_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, global gradient norm) on the device, after one eager
        step: under the preset's ``norm_clip`` the gradients scaled by
        min(1, clip_norm / (norm + 1e-6)), then the optimizer at ``lr``.
        Without it the gradients are not scaled (the norm is still
        computed, for the log)."""
        self.set_schedule(lr, clip_norm)
        loss, gnorm = self._step(batch, self._seeds()[0])
        self.step += 1
        return loss, gnorm

    def train_steps(self, group: torch.Tensor, lr: float,
                    clip_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(losses, global gradient norms), each (K,), after the K steps of
        the (K, B, ...) ``group`` on the device, as K ``train_step`` calls
        give them, bit for bit. On the card one CUDA graph replay holds the
        K steps; the first group of a shape (and the first after ``load``)
        runs them eagerly and captures them. On the CPU they run
        eagerly."""
        self.set_schedule(lr, clip_norm)
        k = group.shape[0]
        if self.graphs is None:
            out = self._steps(group, self._seeds(k))
        else:
            states = self._group_states(k)
            for i, per_micro in enumerate(self._seeds(k)):
                for seed, pair in zip(per_micro, states[i]):
                    for state in pair:
                        state.manual_seed(seed)
            out = self.graphs.run(
                ("steps", tuple(group.shape), group.dtype, self.compute_dtype,
                 self.remat_forward, self.accum_steps),
                lambda g: self._captured_steps(g, states), (group,),
                warmup=lambda: self._steps(group, self._seeds(k)), binding=self._binding,
                states=[s for step in states for pair in step for s in pair],
                label=f"{k} steps of {tuple(group.shape[1:])} {group.dtype}")
        self.step += k
        return out

    def _group_states(self, k: int) -> list:
        """The (forward, recompute) generator states of each microbatch of
        k steps, made once (a replay re-seeds them)."""
        while len(self._step_states) < k:
            self._step_states.append([(self.generator.clone_state(),
                                       self.generator.clone_state())
                                      for _ in range(self.accum_steps)])
        return self._step_states[:k]

    def _captured_steps(self, group: torch.Tensor, states: list):
        """``_steps`` in a capture: each microbatch's masks from its pair of
        generator states; the generator points at its own state after."""
        own = self.generator.graphsafe_get_state()
        try:
            return self._steps(group, states)
        finally:
            self.generator.graphsafe_set_state(own)

    def _binding(self) -> list:
        """What a step reads and writes in place: the parameters, buffers,
        optimizer state, LR and threshold."""
        state = [v for st in self.optimizer.state.values() for v in st.values()
                 if isinstance(v, torch.Tensor)]
        return [*self._model_binding(), *state, self.lr, self.clip]

    def _model_binding(self) -> list:
        return [*self.params, *self.model.buffers()]

    def _graphed(self, graphs: Optional[bool]) -> bool:
        """Whether an eval forward replays a CUDA graph: ``graphs``, by
        default on a card on 'seq' and 'model' axes of 1; a graph needs a
        card, and those axes' collectives keep the forward eager."""
        eager_only = axis_size(self.mesh, "model") > 1 or axis_size(self.mesh, "seq") > 1
        if graphs is None:
            return self.graphs is not None and not eager_only
        if graphs and (self.graphs is None or eager_only):
            raise ValueError(f"graphs=True needs a CUDA device, not {self.device}, and 'seq' "
                             f"and 'model' axes of 1")
        return graphs

    @torch.no_grad()
    def _eval(self, batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        self.model.eval()
        imgs, targets = self._split_batch(batch)
        out = self.model(imgs).float()
        return self.preset.loss_fn(out, targets), out

    @torch.no_grad()
    def _local_eval(self, batch: torch.Tensor,
                    graphs: Optional[bool]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, predictions) of ``batch`` in this process, under the mesh's
        'model' axis where there is one."""
        if not self._graphed(graphs):
            with use_mesh(self.mesh):
                return self._eval(batch)
        return self.graphs.run(("eval", tuple(batch.shape), batch.dtype, self.compute_dtype),
                               self._eval, (batch,),
                               binding=self._model_binding,
                               label=f"eval forward of {tuple(batch.shape)} {batch.dtype}")

    @torch.no_grad()
    def _shard_eval(self, rows: torch.Tensor, n: int, graphs: Optional[bool], gather: bool,
                    first: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """On the mesh: (this position's share of the batch's loss, the
        batch's predictions, gathered over 'data' if ``gather`` (with
        ``first``, on data position 0 alone), else None) for ``rows``, this
        rank's ``data_rows`` of an ``n``-row batch. The share is its rows'
        mean loss times rows / n: the shares sum to the whole batch's mean."""
        if rows.shape[0]:
            loss, out = self._local_eval(rows, graphs)
            share = loss * (rows.shape[0] / n)
        else:
            share, out = torch.zeros((), device=self.device), None
        return share, gather_data(self.mesh, out, n, first) if gather else None

    @torch.no_grad()
    def eval_step(self, batch: torch.Tensor,
                  graphs: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, predictions) in eval mode; with ``graphs`` (the default on
        a card) one CUDA graph replay per (batch shape, its dtype, compute
        dtype), the first batch of a shape run eagerly and captured. On a
        mesh every rank passes the whole batch and gets the whole batch's
        loss and predictions."""
        if self.mesh is None:
            return self._local_eval(batch, graphs)
        n = batch.shape[0]
        share, out = self._shard_eval(batch[data_rows(self.mesh, n)], n, graphs, True)
        return sum_data(self.mesh, share), out

    # ---- loops ----------------------------------------------------------

    def train_epoch(self, loader, lr: float, clip_norm: float) -> Dict[str, float]:
        """One epoch at ``lr`` and ``clip_norm``: groups of ``scan_steps``
        batches through ``train_steps``, the epoch's stragglers (and every
        batch at ``scan_steps=1``) through ``train_step``."""
        losses, gnorms = [], []
        for batch in device_prefetch(grouped(loader, self.scan_steps), self.device):
            step = self.train_steps if batch.dim() == 6 else self.train_step
            loss, gnorm = step(batch, lr, clip_norm)
            losses.append(loss.reshape(-1))
            gnorms.append(gnorm.reshape(-1))
        # flatten: a group's entries carry its K steps' values (JAX:
        # adnm_tpu/train/loop.py:483-490)
        losses = torch.cat(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        gnorms = torch.cat(gnorms).cpu().numpy() if gnorms else np.zeros(0, np.float32)
        n = int(losses.size)
        clip_count = int(np.sum(gnorms > clip_norm)) if self.preset.norm_clip else 0
        return {
            "loss": float(losses.sum()),
            "avg_grad_norm": float(gnorms.mean()) if n else 0.0,
            "clip_ratio": clip_count / max(n, 1),
            "steps": n,
        }

    def predict(self, batch: np.ndarray,
                graphs: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, predictions) for one host batch (``eval_step``)."""
        return self.eval_step(to_device(batch, self.device), graphs)

    def eval_epoch(self, loader, collect: bool = False, graphs: Optional[bool] = None):
        """(summed loss, predictions, ground truths); the last two are None
        unless ``collect``, else (N, T_out, S, S) fp32 arrays, the ground
        truths in [0, 1]. Each batch through ``eval_step(graphs=...)``; on a
        mesh each rank's rows of it, the batches' losses summed over 'data'
        once at the end, and with ``collect`` the predictions gathered on
        rank 0 alone, which alone returns the arrays (None on the others)."""
        keep = collect and self.rank == 0  # rank 0 is mesh position (0, 0, 0)
        # rank 0's 'data' group: 'seq' and 'model' position 0
        gather = collect and axis_rank(self.mesh, "model") == axis_rank(self.mesh, "seq") == 0
        losses, preds, gts = [], [], []
        for batch in device_prefetch(loader, self.device):
            if self.mesh is None:
                loss, out = self.eval_step(batch, graphs)
            else:
                n = batch.shape[0]
                loss, out = self._shard_eval(batch[data_rows(self.mesh, n)], n, graphs, gather,
                                             first=True)
            losses.append(loss)
            if keep:
                preds.append(out[:, :, 0].cpu().numpy())
                g = batch[:, self.input_frames:, 0].cpu().numpy()
                if np.issubdtype(g.dtype, np.integer):
                    # uint8 wire: back to [0, 1] with the JAX package's
                    # arithmetic (a division, not the step's product with
                    # 1/255, which can differ in the last bit and so put
                    # floor(x * 90) across a threshold)
                    g = g.astype(np.float32) / 255.0
                gts.append(g)
        if self.mesh is not None and losses:  # each batch's loss: the shares' sum
            losses = list(sum_data(self.mesh, torch.stack(losses)))
        total = float(torch.stack(losses).sum().cpu()) if losses else 0.0
        if not keep:
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
        (``portable_optimizer_state``) and the step. Under ZeRO-1 only rank
        0 can give it, after every rank has called
        ``optimizer.consolidate_state_dict(to=0)`` (``save`` does both); it
        then has the layout of the plain optimizer's."""
        return {"params": self.model.state_dict(),
                "opt_state": portable_optimizer_state(self.optimizer.state_dict()),
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
            self._adopt_optimizer_state()
        self.step = int(state["step"])
        if self.graphs is not None:  # they read the optimizer state that was replaced
            self.graphs.clear()

    def _adopt_optimizer_state(self) -> None:
        """After ``load_state_dict`` of a portable state: every group's LR is
        ``self.lr`` again (holding the file's value) and, on a card, Adam's
        and AdamW's flags are this Trainer's (``presets.CARD_ADAM``), their
        step counts on the device (for ZeRO-1 in the optimizer it wraps
        too, which keeps them on the CPU)."""
        self.lr.fill_(float(self.optimizer.param_groups[0]["lr"]))
        inner = getattr(self.optimizer, "optim", self.optimizer)
        for opt in dict.fromkeys((self.optimizer, inner)):
            card_adam = self.lr.is_cuda and isinstance(opt, (torch.optim.Adam, torch.optim.AdamW))
            for group in opt.param_groups:
                group["lr"] = self.lr
                if card_adam:
                    group.update(CARD_ADAM)
            if card_adam:
                for p, st in opt.state.items():
                    if isinstance(st, dict) and isinstance(st.get("step"), torch.Tensor):
                        st["step"] = st["step"].to(p.device, torch.float32)
