"""Composite blocks of the ADNM-UNet on NCHW tensors
(counterpart of adnm_tpu/core/blocks.py). Each computes in its input's
dtype, its gates cast to it where the JAX module casts them
(``gate_cast``); ``ChannelAttBridge`` returns fp32 maps, as in JAX.

On a band of a frame split over the mesh's 'seq' axis the blocks need
nothing of their own: their convolutions and norms take their halos and
frame statistics (``core/layers.py``), the 2x2 max pool is local on an
even band, and ``ChannelAttBridge`` pools a split skip over the frame
(``frame_mean``). ``EncoderToDecoder`` runs on whole skips, as JAX pins
it replicated."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import (
    ConvFFD,
    ConvLayer,
    DeConvLayer,
    FeedForward,
    IntensityGate,
    Linear,
    Mlp,
    channel_scale,
    gate_cast,
    make_norm,
    scalar_param,
)
from adnm_tpu_torch.core.wavelet import WTConvLayer
from adnm_tpu_torch.parallel.tensor import seq_size, sum_seq


def norm_kind(instance_norm: bool, groups: int = 4) -> str:
    return "instance" if instance_norm else f"group{groups}"


class PatchEmbed(nn.Module):
    """WTConv residual -> 3x3 conv to embed_dim -> WTConv+norm residual, with
    alpha/beta mixing and a gamma channel scale. Takes the (B, T_in, H, W)
    frame stack and also returns its last frame (B, H, W), the global
    output residual."""

    def __init__(self, in_channels: int, embed_dim: int, kernel: int = 6, wt_levels: int = 2,
                 instance_norm: bool = True):
        super().__init__()
        for name in ("alpha1", "beta1", "alpha2", "beta2"):
            setattr(self, name, scalar_param(1.0))
        self.conv1 = WTConvLayer(in_channels, kernel, wt_levels, use_bias=False, act="gelu")
        self.conv2 = ConvLayer(in_channels, embed_dim, 3, 1, 1, use_bias=False, act="gelu")
        self.conv3 = WTConvLayer(embed_dim, kernel, wt_levels, use_bias=False,
                                 norm=norm_kind(instance_norm))
        self.gamma = nn.Parameter(torch.ones(embed_dim))  # layer scale, init 1.0

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        res = x[:, -1]
        alpha1, beta1, alpha2, beta2 = gate_cast(x, self.alpha1, self.beta1, self.alpha2,
                                                 self.beta2)
        x = alpha1 * self.conv1(x) + beta1 * x
        shortcut = self.conv2(x)
        x = alpha2 * self.conv3(shortcut) + beta2 * shortcut
        return channel_scale(x, self.gamma), res


class SimplePatchEmbed(nn.Module):
    """The one-conv patch embed (JAX: ``SimplePatchEmbed``; reference:
    models/model_untils.py:318-355): a kernel x kernel conv to embed_dim
    with padding (kernel - 1) // 2, no bias, then the norm. Returns the
    frame stack's last frame too, as ``PatchEmbed``."""

    def __init__(self, in_channels: int, embed_dim: int, kernel: int = 6,
                 instance_norm: bool = True):
        super().__init__()
        self.conv = ConvLayer(in_channels, embed_dim, kernel, 1, (kernel - 1) // 2,
                              use_bias=False, norm=norm_kind(instance_norm))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.conv(x), x[:, -1]


class WTLayer(nn.Module):
    """Optional gated skip-concat, WTConv alpha/beta residual, Mlp, gamma
    scale, 3x3 conv to next_dim. ``this_dim`` is the width after the
    concat. The JAX module's ``features`` input counts only without a
    residual, and no caller passes it there, so it is not ported (its
    gate ``gama3`` is carried and never read)."""

    def __init__(self, this_dim: int, next_dim: int, kernel: int = 5, wt_levels: int = 2,
                 use_bias: bool = True, if_res: bool = False, instance_norm: bool = True):
        super().__init__()
        d = this_dim
        for name in ("gama1", "gama2", "gama3", "alpha", "beta"):
            setattr(self, name, scalar_param(1.0))
        self.wtconv = WTConvLayer(d, kernel, wt_levels, use_bias,
                                  norm=norm_kind(instance_norm, 8 if if_res else 4))
        self.mlp = Mlp(d)
        self.gamma = nn.Parameter(torch.ones(d))  # layer scale, init 1.0
        self.conv = ConvLayer(d, next_dim, 3, 1, 1, use_bias=True, act="gelu")

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is not None:
            gama1, gama2 = gate_cast(x, self.gama1, self.gama2)
            x = torch.cat([gama1 * x, gama2 * residual.to(x.dtype)], dim=1)
        alpha, beta = gate_cast(x, self.alpha, self.beta)
        x = self.mlp(alpha * self.wtconv(x) + beta * x)
        return self.conv(channel_scale(x, self.gamma))


class LayerToLayer(nn.Module):
    """The plain-conv variant of WTLayer (JAX: ``LayerToLayer``; reference:
    models/model_untils.py:429-465), exported and wired into no model in
    JAX either: the gated skip-concat (or, without a residual, the gated
    features added), then a 3x3 conv with norm and GELU. ``this_dim`` is
    the width after the concat."""

    def __init__(self, this_dim: int, next_dim: int, use_bias: bool = True,
                 if_res: bool = False, instance_norm: bool = True):
        super().__init__()
        for name in ("gama1", "gama2", "gama3"):
            setattr(self, name, scalar_param(1.0))
        self.conv = ConvLayer(this_dim, next_dim, 3, 1, 1, use_bias=use_bias,
                              norm=norm_kind(instance_norm, 8 if if_res else 4), act="gelu")

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                features: Optional[torch.Tensor] = None) -> torch.Tensor:
        gama1, gama2, gama3 = gate_cast(x, self.gama1, self.gama2, self.gama3)
        if residual is not None:
            x = torch.cat([gama1 * x, gama2 * residual.to(x.dtype)], dim=1)
        elif features is not None:
            x = x + gama3 * features.to(x.dtype)
        return self.conv(x)


class DownSample(nn.Module):
    """MaxPool2d(ratio)."""

    def __init__(self, ratio: int = 2):
        super().__init__()
        self.ratio = ratio

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, self.ratio, self.ratio)


class UpSample(nn.Module):
    """Transposed-conv upsample by ``ratio`` (DeConvLayer padding math)."""

    def __init__(self, in_channels: int, dim: int, kernel: int = 3, ratio: int = 2,
                 use_bias: bool = True):
        super().__init__()
        self.trans_conv = DeConvLayer(in_channels, dim, ratio, (kernel, kernel), use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trans_conv(x)


class ChannelAttBridge(nn.Module):
    """Global channel attention over all skip levels: per-level average pool
    -> concat -> shared conv1d (k=3, pad 1) -> per-level Linear ->
    IntensityGate. Returns one (B, C_i, 1, 1) map per level."""

    def __init__(self, c_list: Sequence[int]):
        super().__init__()
        self.get_all_att_kernel = nn.Parameter(torch.zeros(3))
        self.get_all_att_bias = nn.Parameter(torch.zeros(1))
        self.sigmoid1 = IntensityGate()
        total = sum(c_list)
        for i, c in enumerate(c_list):
            self.add_module(f"att{i + 1}", Linear(total, c))
        self.n = len(c_list)

    def reset_random_(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(3.0)
        self.get_all_att_kernel.uniform_(-bound, bound, generator=gen)
        self.get_all_att_bias.uniform_(-bound, bound, generator=gen)

    def forward(self, skips: Sequence[torch.Tensor],
                split: Sequence[bool] = ()) -> Tuple[torch.Tensor, ...]:
        """``split[i]``: skip i is this rank's band of its frame over 'seq'
        (its average pool is the bands' sums over the frame's H * W)."""
        att = torch.cat([frame_mean(s) if i < len(split) and split[i] else s.mean(dim=(2, 3))
                         for i, s in enumerate(skips)], dim=1)  # (B, sum C)
        w = self.get_all_att_kernel
        # JAX multiplies the pooled skips by the fp32 taps w[i] uncast, which
        # promotes them to fp32 there; the maps stay fp32 from here on.
        p = F.pad(att.float(), (1, 1))
        att = p[:, :-2] * w[0] + p[:, 1:-1] * w[1] + p[:, 2:] * w[2] + self.get_all_att_bias
        return tuple(
            self.sigmoid1(getattr(self, f"att{i + 1}")(att))[:, :, None, None]
            for i in range(self.n)
        )


def frame_mean(s: torch.Tensor) -> torch.Tensor:
    """The (B, C) mean over H and W of the frame whose band over 'seq' is
    ``s``: the bands' fp32 sums, summed over the ranks, in ``s``'s dtype."""
    total = sum_seq(s.float().sum(dim=(2, 3)))
    return (total / (s.shape[2] * seq_size() * s.shape[3])).to(s.dtype)


def _pool_pair(v: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """Stride-1 "same" max pool (padded with -inf) plus average pool
    (count_include_pad=True) over a wh x ww window."""
    pad = (wh // 2, ww // 2)
    return (F.max_pool2d(v, (wh, ww), 1, pad)
            + F.avg_pool2d(v, (wh, ww), 1, pad, count_include_pad=True))


class EncoderToDecoder(nn.Module):
    """Multi-scale spatial attention on one skip connection: three pooling
    branches (3x1 / 1x3 / 3x3 max+avg pool -> grouped conv -> gate), an
    alpha-weighted sum, gamma, FeedForward and ConvFFD. Branch 2 reuses
    ``ffd13``/``act_func13``, as the reference does."""

    def __init__(self, embed_dim: int, instance_norm: bool = True):
        super().__init__()
        d = embed_dim
        self.gama = scalar_param(1.0)
        self.scale = scalar_param(1.0)
        self.shift = scalar_param(0.0)
        self.act = IntensityGate()
        n = make_norm(norm_kind(instance_norm), d)
        self.norm_name = f"{type(n).__name__}_0"  # flax's automatic name
        self.add_module(self.norm_name, n)
        self.ffd13 = ConvLayer(d, d, 1, 1, 0, groups=d)
        self.act_func13 = IntensityGate()
        self.conv13pool = ConvLayer(d, d, (1, 3), 1, (0, 1), groups=d // 4, act="gelu")
        self.conv31pool = ConvLayer(d, d, (3, 1), 1, (1, 0), groups=d // 4, act="gelu")
        self.conv33pool = ConvLayer(d, d, (3, 3), 1, (1, 1), groups=d // 4, act="gelu")
        self.ffd33 = ConvLayer(d, d, 1, 1, 0, groups=d)
        self.act_func33 = IntensityGate()
        self.alpha1 = scalar_param(0.33)
        self.alpha2 = scalar_param(0.33)
        self.alpha3 = scalar_param(0.33)
        self.gamma = nn.Parameter(torch.ones(d))
        self.ffd = FeedForward(d)
        self.mlp = ConvFFD(d)

    def forward(self, x: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
        gama, scale, shift = gate_cast(x, self.gama, self.scale, self.shift)
        x = self.act(x + gama * att.to(x.dtype))
        x = scale * getattr(self, self.norm_name)(x) + shift
        x1 = self.act_func13(self.ffd13(x * self.conv13pool(_pool_pair(x, 3, 1))))
        x2 = self.act_func13(self.ffd13(x * self.conv31pool(_pool_pair(x, 1, 3))))
        x3 = self.act_func33(self.ffd33(x * self.conv33pool(_pool_pair(x, 3, 3))))
        alpha1, alpha2, alpha3 = gate_cast(x1, self.alpha1, self.alpha2, self.alpha3)
        x = alpha1 * x1 + alpha2 * x2 + alpha3 * x3
        x = channel_scale(x, self.gamma)
        return self.mlp(self.ffd(x))


class OutProj(nn.Module):
    """Prediction head: WTConv residual stage (kernel 5, 3 levels) -> 3x3
    expand conv -> 1x1 to num_frames -> plus the alpha-weighted last input
    frame broadcast over the frames -> 3x3 conv with a learnable Swish."""

    def __init__(self, num_frames: int, embed_dim: int, out_expand: int = 2,
                 instance_norm: bool = True):
        super().__init__()
        d = embed_dim
        self.alpha = scalar_param(1.0)
        self.beta = scalar_param(1.0)
        self.wtconv = WTConvLayer(d, 5, 3, use_bias=False, act="gelu",
                                  norm=norm_kind(instance_norm))
        self.gamma = nn.Parameter(torch.ones(d))
        self.conv_expand = ConvLayer(d, d * out_expand, 3, 1, 1, use_bias=False, act="gelu")
        self.conv_frames = ConvLayer(d * out_expand, num_frames, 1, 1, 0, use_bias=False,
                                     act="gelu")
        self.alpha1 = scalar_param(1.0)
        self.alpha2 = scalar_param(1.0)
        self.conv2 = ConvLayer(num_frames, num_frames, 3, 1, 1, use_bias=False, swish=True)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        alpha, beta = gate_cast(x, self.alpha, self.beta)
        x = alpha * self.wtconv(x) + beta * x
        x = channel_scale(x, self.gamma)
        x = self.conv_frames(self.conv_expand(x))
        alpha1, alpha2 = gate_cast(x, self.alpha1, self.alpha2)
        x = alpha1 * x + alpha2 * residual.to(x.dtype)[:, None]
        return self.conv2(x)
