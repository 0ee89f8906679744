"""Haar (db1) wavelet transforms and WTConv2d on NCHW tensors
(counterpart of adnm_tpu/core/wavelet.py).

``haar_dwt`` stacks the four subbands on a new axis 2 after the channel
axis, so flattening (C, 4) gives channel ``ch*4 + s``: the per-channel
block order of the reference's filter stack, which is also the order of
the JAX package's wavelet kernel and scale parameters. No permutation is
needed anywhere. Subbands: 0=LL, 1=HL (high along H), 2=LH (high along
W), 3=HH.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import Conv2d, _NormalizedLayer, channel_scale


def haar_dwt(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 4, H/2, W/2); H and W must be even."""
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    return torch.stack(
        [(a + b + c + d) * 0.5, (a + b - c - d) * 0.5,
         (a - b + c - d) * 0.5, (a - b - c + d) * 0.5],
        dim=2,
    )


def haar_idwt(y: torch.Tensor) -> torch.Tensor:
    """(B, C, 4, H/2, W/2) -> (B, C, H, W): the exact inverse of haar_dwt."""
    ll, hl, lh, hh = y.unbind(2)
    a = (ll + hl + lh + hh) * 0.5
    b = (ll + hl - lh - hh) * 0.5
    c = (ll - hl + lh - hh) * 0.5
    d = (ll - hl - lh + hh) * 0.5
    top = torch.stack([a, b], dim=-1)  # (B, C, H/2, W/2, 2): even rows
    bot = torch.stack([c, d], dim=-1)  # odd rows
    out = torch.stack([top, bot], dim=-3)  # (B, C, H/2, 2, W/2, 2)
    n, ch, h2, _, w2, _ = out.shape
    return out.reshape(n, ch, h2 * 2, w2 * 2)


class WTConv2d(nn.Module):
    """Multi-level wavelet depthwise conv: per level a Haar DWT, a depthwise
    k x k conv over the 4*C subband channels and a per-channel scale (init
    0.1), the LL band recursing; reconstruction by IDWT level by level,
    plus a parallel depthwise ``base_conv`` with ``base_scale``. Odd sizes
    are padded at the bottom/right before a DWT and cropped after the
    IDWT. Runs in the input's dtype: the Haar steps are adds in it, the
    depthwise kernels and the scales are cast to it (JAX: ``astype`` and
    ``gate_cast``). (The JAX module's ``stride`` is always 1 and is not
    ported.)"""

    def __init__(self, channels: int, kernel_size: int = 5, use_bias: bool = True,
                 wt_levels: int = 2):
        super().__init__()
        c = channels
        self.wt_levels = wt_levels
        self.base_conv = Conv2d(c, c, kernel_size, padding="same", groups=c, bias=use_bias)
        self.base_scale = nn.Parameter(torch.ones(c))
        for lvl in range(wt_levels):
            self.add_module(f"wavelet_conv{lvl}", Conv2d(
                4 * c, 4 * c, kernel_size, padding="same", groups=4 * c, bias=False))
            self.register_parameter(f"wavelet_scale{lvl}", nn.Parameter(torch.full((4 * c,), 0.1)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lls, highs, sizes = [], [], []
        cur = x
        for lvl in range(self.wt_levels):
            sizes.append(cur.shape[2:])
            ph, pw = cur.shape[2] % 2, cur.shape[3] % 2
            if ph or pw:
                cur = F.pad(cur, (0, pw, 0, ph))
            sub = haar_dwt(cur)  # (B, C, 4, h, w)
            cur = sub[:, :, 0]
            b, c, _, h, w = sub.shape
            flat = getattr(self, f"wavelet_conv{lvl}")(sub.reshape(b, 4 * c, h, w))
            flat = channel_scale(flat, getattr(self, f"wavelet_scale{lvl}"))
            flat = flat.reshape(b, c, 4, h, w)
            lls.append(flat[:, :, 0])
            highs.append(flat[:, :, 1:])

        next_ll = 0.0
        for lvl in range(self.wt_levels - 1, -1, -1):
            ll = lls[lvl] + next_ll
            next_ll = haar_idwt(torch.cat([ll[:, :, None], highs[lvl]], dim=2))
            sh, sw = sizes[lvl]
            next_ll = next_ll[:, :, :sh, :sw]

        base = self.base_conv(x)
        return channel_scale(base, self.base_scale) + next_ll


class WTConvLayer(_NormalizedLayer):
    """WTConv2d -> scale*norm+shift -> act."""

    def __init__(self, channels: int, kernel_size: int = 3, wt_levels: int = 2,
                 use_bias: bool = True, norm: Optional[str] = None, act: Optional[str] = None):
        super().__init__()
        self.conv = WTConv2d(channels, kernel_size, use_bias, wt_levels)
        self._init_tail(channels, norm, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._tail(self.conv(x))
