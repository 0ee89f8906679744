"""Rainfall losses on torch tensors (counterpart of
adnm_tpu/losses/rainfall.py; reference: models/loss.py).

All four reference criteria, value for value. Signatures are
``loss(pred, target) -> 0-d tensor``; thresholds and weights are bound by
``get_loss``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch


def rainfall_loss(pred: torch.Tensor, target: torch.Tensor, omega_t: float = 0.57,
                  alpha: float = 0.25) -> torch.Tensor:
    """Dynamic quantile-weighted L1 (reference: models/loss.py:11-27).

    Quirk preserved: the base quantile weight uses the hard-coded
    w0 = 0.57, not omega_t (loss.py:18)."""
    w0 = 0.57
    diff = (pred - target).abs()
    ge = (pred >= target).to(pred.dtype)
    lt = 1.0 - ge
    loss_overall = (ge * (1 - w0) * diff).sum() + (lt * w0 * diff).sum()
    wi = alpha * torch.exp(target)
    high = (target >= 0.7).to(pred.dtype)
    loss_greater = (ge * high * (1 - omega_t) * wi * diff).sum()
    loss_less = (lt * high * omega_t * wi * diff).sum()
    n = pred.numel()
    return loss_overall / n + (loss_greater + loss_less) / n


def en_rainfall_loss(pred: torch.Tensor, target: torch.Tensor, omega_t: float = 0.57,
                     alpha: float = 0.25, gamma: float = 0.1) -> torch.Tensor:
    """DQWL + exponential false-negative penalty
    (reference: models/loss.py:30-57, enRainfallLoss)."""
    diff = (pred - target).abs()
    ge = (pred >= target).to(pred.dtype)
    lt = 1.0 - ge
    loss_overall = (ge * (1 - omega_t) * diff).sum() + (lt * omega_t * diff).sum()
    wi = alpha * torch.exp(target)
    high = (target >= 0.7).to(pred.dtype)
    loss_greater = (ge * high * (1 - omega_t) * wi * diff).sum()
    loss_less = (lt * high * omega_t * wi * diff).sum()
    fn_penalty = (high * lt * gamma * (torch.exp(alpha * (target - pred)) - 1.0)).sum()
    return (loss_overall + loss_greater + loss_less + fn_penalty) / pred.numel()


def rain_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE + MAE (reference: models/loss.py:61-69, RAINlOSS)."""
    return (pred - target).square().mean() + (pred - target).abs().mean()


def weighted_mse_mae(pred: torch.Tensor, target: torch.Tensor,
                     thresholds: Sequence[float] = (), mse_weight: float = 1.0,
                     mae_weight: float = 1.0, global_scale: float = 0.00005,
                     lam: Optional[float] = None) -> torch.Tensor:
    """Threshold-banded weighted MSE+MAE
    (reference: models/loss.py:73-100, Weighted_mse_mae).

    pred/target: (B, T, C, H, W); summed per (T, B) over (C, H, W), as the
    reference does after transposing to seq-first."""
    balancing = (1.0, 1.0, 2.0, 5.0, 10.0, 30.0)
    weights = torch.full_like(pred, balancing[0])
    for i, thr in enumerate(thresholds):
        weights = weights + (balancing[i + 1] - balancing[i]) * (target >= thr).to(pred.dtype)
    mse = (weights * (pred - target).square()).sum(dim=(2, 3, 4)).T
    mae = (weights * (pred - target).abs()).sum(dim=(2, 3, 4)).T
    if lam is not None:
        w = 1.0 + lam * torch.arange(mse.shape[0], dtype=pred.dtype, device=pred.device)[:, None]
        mse = mse * w
        mae = mae * w
    return global_scale * (mse_weight * mse.mean() + mae_weight * mae.mean())


_LOSSES: dict[str, Callable] = {
    "rainfall": rainfall_loss,
    "en_rainfall": en_rainfall_loss,
    "rain": rain_loss,
    "weighted_mse_mae": weighted_mse_mae,
}


def get_loss(name: str, **kwargs) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    fn = _LOSSES[name]
    return functools.partial(fn, **kwargs) if kwargs else fn
