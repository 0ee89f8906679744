"""Per-model training presets (counterpart of adnm_tpu/train/presets.py;
reference: train_untils.py:22-130 + train.py:78-94).

A preset bundles the optimizer family and its constants, the base LR, the
loss, the LR schedule (computed on the host per epoch, like the
reference's per-epoch scheduler.step(); None means the loop's poly decay),
early stop, the gradient clip and the save-epoch gate. The ADNMUnet preset
clips adaptively (``ClipSchedule``) and gates the best checkpoint to
epochs past the clip's save epoch; the baselines' presets do neither.
TransUnet and SwinUnet share SmaAt-UNet's SGD preset without its early
stop.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch

from adnm_tpu_torch.losses.rainfall import get_loss


@dataclasses.dataclass
class ClipSchedule:
    """Adaptive gradient-clip schedule (reference: train.py:78-94,122-130)."""

    warmup_epoch: int
    save_epoch: int
    norm_ratio: float
    norm_max: float
    norm_initial: float
    grad_epoch_excursion: int

    def threshold(self, epoch: int, prev_avg_grad_norm: float) -> float:
        if epoch <= self.warmup_epoch + 1:
            return self.norm_max
        span = self.save_epoch - self.warmup_epoch + self.grad_epoch_excursion
        if epoch <= span:
            alpha = self.norm_initial + (1 - self.norm_initial) * (epoch - self.warmup_epoch) / span
            return alpha * self.norm_ratio * prev_avg_grad_norm
        return self.norm_ratio * prev_avg_grad_norm


class TensorLRSGD(torch.optim.SGD):
    """``torch.optim.SGD`` with momentum, weight decay added to the
    gradient and no dampening, Nesterov or maximize, whose LR may be a
    device tensor that the device reads: torch's own SGD turns a tensor LR
    into a host number (a synchronisation, which a CUDA graph cannot
    hold). The update is optax's chain, add_decayed_weights -> trace ->
    scale by -lr: ``p + buf * (-lr)``, the momentum buffer starting at the
    first gradient. The state and its dict are torch's SGD's."""

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TensorLRSGD takes no closure")
        for group in self.param_groups:
            if group["dampening"] or group["nesterov"] or group["maximize"]:
                raise ValueError("TensorLRSGD has no dampening, Nesterov or maximize")
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params, alpha=group["weight_decay"])
            if group["momentum"]:
                bufs = [self.state[p].get("momentum_buffer") for p in params]
                kept = [i for i, b in enumerate(bufs) if b is not None]
                if kept:
                    torch._foreach_mul_([bufs[i] for i in kept], group["momentum"])
                    torch._foreach_add_([bufs[i] for i in kept], [grads[i] for i in kept])
                for i, b in enumerate(bufs):
                    if b is None:  # a parameter's first step: its buffer starts at d_p
                        bufs[i] = self.state[params[i]]["momentum_buffer"] = grads[i].clone()
                grads = bufs
            lr = group["lr"]
            neg_lr = -lr if isinstance(lr, torch.Tensor) else -float(lr)
            torch._foreach_add_(params, torch._foreach_mul(grads, neg_lr))
        return None


# Adam's and AdamW's flags on a card (``make_optimizer``)
CARD_ADAM = {"fused": True, "capturable": True}


@dataclasses.dataclass
class TrainPreset:
    opt_family: str  # "adamw" | "adam" | "sgd"
    base_lr: float
    loss_fn: Callable
    # (epoch, 1-indexed; total epochs) -> lr; None: the loop's poly decay
    lr_at_epoch: Optional[Callable[[int, int], float]]
    if_early_stop: bool
    early_stop: Optional[int]  # epochs past the save gate without a better val loss
    norm_clip: bool  # clip the gradients by the global norm (clip_schedule)
    save_epoch_gated: bool  # save the best checkpoint only past ``save_epoch``
    epochs: int
    clip_schedule: Optional[ClipSchedule] = None
    save_epoch: int = 0
    weight_decay: float = 0.0
    momentum: float = 0.0
    adam_eps: float = 1e-8

    def make_optimizer(self, params: Iterable[torch.nn.Parameter], zero1: bool = False,
                       lr: Optional[torch.Tensor] = None,
                       process_group=None) -> torch.optim.Optimizer:
        """The optimizer with the update of the JAX preset's optax one; the
        loop sets the LR of the param group every epoch.

        * adamw: ``optax.adamw`` (decoupled weight decay, eps added outside
          the square root) is ``torch.optim.AdamW``;
        * adam: ``optax.adam`` with its defaults is ``torch.optim.Adam``;
        * sgd: the chain add_decayed_weights -> trace(momentum) -> scale by
          -lr is ``TensorLRSGD``, torch's SGD without dampening or
          Nesterov: the decay is added to the gradient, the momentum buffer
          starts at the first gradient.

        ``lr``, a one-element tensor on the parameters' device, is the LR
        of every group (the ``Trainer`` fills it in place each epoch). On a
        card Adam and AdamW then take their fused form (``fused``: one
        kernel per chunk of parameters, the step counts on the device), and
        ``capturable``, which a CUDA graph capture of ``step`` asks for: no
        update reads a host value. It is also the cheapest eager step of
        the three forms (``scripts/torch_step_time.py --optimizers``).

        ``zero1`` gives ZeRO-1 (the JAX ``--zero1``):
        ``ZeroRedundancyOptimizer`` around the same class and settings, each
        rank holding and updating the state of its share of the parameters
        and broadcasting them after the step. The caller asks for it only
        inside a process group of two or more ranks (``Trainer``: on one
        rank the plain optimizer, as JAX shards nothing over a 'data' axis
        of 1, adnm_tpu/train/loop.py:126-130). ``process_group`` is the
        group the state is sharded over (the default group when None): the
        mesh's 'data' group, as JAX's ``P('data')`` moments, so that on a
        'seq' or 'model' axis each of their positions holds a whole sharded
        state over its 'data' ranks."""
        cls, settings = self._optimizer()
        if lr is not None:
            settings["lr"] = lr
            if lr.is_cuda and cls is not TensorLRSGD:
                settings.update(CARD_ADAM)
        params = list(params)
        if zero1:
            # imported here: the module scripts functional optimizers with torch.jit
            from torch.distributed.optim import ZeroRedundancyOptimizer

            return ZeroRedundancyOptimizer(params, optimizer_class=cls,
                                           process_group=process_group, **settings)
        return cls(params, **settings)

    def _optimizer(self) -> tuple:
        """(optimizer class, its settings) of the preset's family."""
        if self.opt_family == "adamw":
            return torch.optim.AdamW, dict(lr=self.base_lr, betas=(0.9, 0.999),
                                           eps=self.adam_eps, weight_decay=self.weight_decay)
        if self.opt_family == "adam":
            return torch.optim.Adam, dict(lr=self.base_lr, betas=(0.9, 0.999), eps=1e-8)
        if self.opt_family == "sgd":
            return TensorLRSGD, dict(lr=self.base_lr, momentum=self.momentum,
                                         weight_decay=self.weight_decay, dampening=0.0,
                                         nesterov=False)
        raise ValueError(f"unknown optimizer family {self.opt_family!r}")

    def lr(self, epoch: int, total: int) -> float:
        """The LR of 1-indexed ``epoch``: the schedule's, else poly decay,
        stepped at epoch end in the reference (train.py:188-191), so epoch e
        trains at the value after e - 1 steps."""
        if self.lr_at_epoch is not None:
            return self.lr_at_epoch(epoch, total)
        return self.base_lr * (1.0 - (epoch - 1) / total) ** 0.9


def _cosine(base_lr: float, eta_min: float, t_max: int):
    def lr(t: int) -> float:
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / t_max)) / 2
    return lr


def _multistep(base_lr: float, milestones, gamma: float):
    def lr(t: int) -> float:
        return base_lr * gamma ** sum(1 for m in milestones if t >= m)
    return lr


def get_preset(model_name: str, input_frames: int, output_frames: int, frame_interval: int,
               dataset: str) -> TrainPreset:
    thresholds = (0.1, 0.3, 0.5, 0.7, 0.8) if dataset == "LAPS" else (20, 30, 35, 40)

    if model_name == "ADNMUnet":
        base_lr, eta_min, warmup_epoch = 1e-3, 5e-7, 3
        cos = _cosine(base_lr, eta_min, 50)

        def lr_at_epoch(epoch: int, total: int) -> float:
            # torch LinearLR(start_factor=0.01, total_iters=3), then a
            # SequentialLR switch to CosineAnnealingLR(T=50) at epoch 3
            # (train_untils.py:44-46); scheduler.step() runs after the epoch,
            # so epoch e trains with schedule state e-1.
            t = epoch - 1
            if t < warmup_epoch:
                return base_lr * (0.01 + (1.0 - 0.01) * t / warmup_epoch)
            return cos(t - warmup_epoch)

        instance_norm = frame_interval < 120 / input_frames
        clip = (ClipSchedule(3, 34, 1.75, 0.025, 0.175, 1) if instance_norm
                else ClipSchedule(3, 20, 3.0, 0.035, 0.065, 0))
        return TrainPreset(
            opt_family="adamw", base_lr=base_lr,
            loss_fn=get_loss("en_rainfall", omega_t=0.57, alpha=0.25, gamma=0.0),
            lr_at_epoch=lr_at_epoch, if_early_stop=True, early_stop=3 if instance_norm else 5,
            norm_clip=True, save_epoch_gated=True, epochs=40, clip_schedule=clip,
            save_epoch=clip.save_epoch, weight_decay=1e-2, adam_eps=1e-9,
        )

    if model_name in ("ConvLSTM", "TrajGRU"):
        ms = _multistep(1e-4, (15000, 30000), 0.1)
        return TrainPreset(
            opt_family="adam", base_lr=1e-4,
            loss_fn=get_loss("weighted_mse_mae", thresholds=thresholds),
            lr_at_epoch=lambda e, total: ms(e - 1), if_early_stop=False, early_stop=None,
            norm_clip=False, save_epoch_gated=False, epochs=60,
        )

    if model_name == "LPTQPN":
        cos = _cosine(1e-3, 1e-9, 30)
        return TrainPreset(
            opt_family="adamw", base_lr=1e-3, loss_fn=get_loss("rain"),
            lr_at_epoch=lambda e, total: cos(e - 1), if_early_stop=True, early_stop=10,
            norm_clip=False, save_epoch_gated=False, epochs=60, weight_decay=1e-2,
        )

    if model_name in ("SmaATUnet", "TransUnet", "SwinUnet"):
        early = model_name == "SmaATUnet"  # TransUnet and SwinUnet train all 60 epochs
        return TrainPreset(
            opt_family="sgd", base_lr=1e-2, loss_fn=get_loss("rain"),
            lr_at_epoch=None,  # poly decay (train.py:188-191)
            if_early_stop=early, early_stop=30 if early else None, norm_clip=False,
            save_epoch_gated=False, epochs=60, momentum=0.9, weight_decay=1e-4,
        )

    raise ValueError(f"unknown model {model_name!r}")
