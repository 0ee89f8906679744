"""Dropout and DropPath whose masks come from an explicit generator
(counterparts of flax's ``nn.Dropout`` and adnm_tpu/models/swin_unet.py's
``DropPath``).

In train mode a layer keeps each element (``Dropout``) or each sample's
whole tensor (``DropPath``, a (B, 1, ...) mask) with probability 1 - p and
scales what it keeps by 1 / (1 - p), as flax does; in eval mode, or at
p = 0, it is the identity. The masks are drawn from the ``torch.Generator``
that ``attach_generator`` gives the model's layers (the ``Trainer`` owns
one on the model's device), never from the global RNG: a train-mode
forward with p > 0 and no generator raises. The ``Trainer`` seeds it from
(seed, step, micro-batch) with ``step_seed`` at the start of every
training forward, inside the function that whole-forward remat recomputes,
so the recompute draws the masks again, bit for bit; the JAX trainer folds
the step (and the micro-batch) into its dropout key likewise.

Under data parallelism every rank holds its rows of one global batch and
the same generator state. ``attach_generator(..., rows=(rank, world))``
makes each layer draw the mask of the GLOBAL batch (a leading dimension
world times the rank's, whose rows lie in rank order) and keep its own
rows of it, so the ranks' masks together are the single process's mask on
the global batch, and no two ranks drop the same pattern for different
samples. On a mesh ``rows`` is the rank's 'data' position and the size of
'data' (the ``Trainer``'s ``data_rank``, ``data_world``): the 'seq' and
'model' ranks of one position hold the same rows and draw the same masks,
so their replicas of the model stay equal.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class _Stochastic(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None  # set by attach_generator
        self.rows = None  # (rank, world) under data parallelism, set by attach_generator

    def extra_repr(self) -> str:
        return f"rate={self.rate}"

    def _keep_mask(self, shape, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__}(rate={self.rate}) in train mode needs a "
                               f"generator: attach_generator(model, generator)")
        if self.rows is None:
            u = torch.rand(shape, generator=self.generator, device=x.device, dtype=torch.float32)
        else:  # this rank's rows of the global batch's mask
            rank, world = self.rows
            u = torch.rand((shape[0] * world, *shape[1:]), generator=self.generator,
                           device=x.device, dtype=torch.float32)[rank * shape[0]:
                                                                  (rank + 1) * shape[0]]
        return u < 1.0 - self.rate


class Dropout(_Stochastic):
    """Elementwise dropout: ``where(mask, x / (1 - p), 0)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        return torch.where(self._keep_mask(x.shape, x), x / keep, torch.zeros_like(x))


class DropPath(_Stochastic):
    """Per-sample stochastic depth: ``x * mask / (1 - p)`` with one mask
    value per sample."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        mask = self._keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), x)
        return x * mask.to(x.dtype) / keep


def stochastic_layers(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, _Stochastic)]


def attach_generator(model: nn.Module, generator: torch.Generator,
                     rows: tuple[int, int] | None = None) -> int:
    """Give every Dropout and DropPath of ``model`` the ``generator`` (on the
    device of the tensors they will see) and, under data parallelism, the
    ``rows=(rank, world)`` of the global batch that this rank holds;
    returns how many there are."""
    layers = stochastic_layers(model)
    for m in layers:
        m.generator = generator
        m.rows = rows
    return len(layers)


def zero_rates(model: nn.Module) -> nn.Module:
    """Set every Dropout and DropPath rate of ``model`` to 0: train mode
    then draws no mask (for comparisons across devices, whose generators
    draw different masks)."""
    for m in stochastic_layers(model):
        m.rate = 0.0
    return model


def step_seed(seed: int, step: int, micro: int = 0) -> int:
    """The generator's seed for micro-batch ``micro`` of optimizer step
    ``step`` of a run seeded with ``seed``."""
    return int(np.random.SeedSequence([seed, step, micro]).generate_state(1, np.uint64)[0])
