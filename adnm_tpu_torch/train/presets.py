"""Per-model training presets (counterpart of adnm_tpu/train/presets.py;
reference: train_untils.py:22-130 + train.py:78-94).

A preset bundles the optimizer's constants, base LR, loss, LR schedule
(computed on the host per epoch, like the reference's per-epoch
scheduler.step()), early stop, and the ADNMUnet adaptive clip, whose
save epoch also gates the best checkpoint. Only the ADNMUnet preset is
ported, so AdamW, the clip, the save gate and early stop are always on;
the JAX presets' switches for them come with the baselines.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

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


@dataclasses.dataclass
class TrainPreset:
    base_lr: float
    loss_fn: Callable
    lr_at_epoch: Callable[[int, int], float]  # (epoch, 1-indexed; total epochs) -> lr
    early_stop: int  # epochs past the save gate without a better val loss
    epochs: int
    clip_schedule: ClipSchedule
    weight_decay: float
    adam_eps: float

    def make_optimizer(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
        """AdamW with the update of ``optax.adamw``: decoupled weight decay
        and eps added outside the square root. The loop sets the LR of the
        param group every epoch."""
        return torch.optim.AdamW(params, lr=self.base_lr, betas=(0.9, 0.999),
                                 eps=self.adam_eps, weight_decay=self.weight_decay)


def _cosine(base_lr: float, eta_min: float, t_max: int):
    def lr(t: int) -> float:
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t / t_max)) / 2
    return lr


def get_preset(model_name: str, input_frames: int, output_frames: int, frame_interval: int,
               dataset: str) -> TrainPreset:
    if model_name != "ADNMUnet":
        raise NotImplementedError(f"the {model_name!r} preset is not ported (only ADNMUnet)")
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
        base_lr=base_lr, loss_fn=get_loss("en_rainfall", omega_t=0.57, alpha=0.25, gamma=0.0),
        lr_at_epoch=lr_at_epoch, early_stop=3 if instance_norm else 5, epochs=40,
        clip_schedule=clip, weight_decay=1e-2, adam_eps=1e-9,
    )
