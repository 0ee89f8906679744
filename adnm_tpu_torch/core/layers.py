"""Primitive layers on NCHW tensors (counterpart of adnm_tpu/core/layers.py).

Parameter names mirror the JAX module's, so ``adnm_tpu_torch.convert``
maps a JAX parameter path onto the port's module path one to one. JAX's
Dense is ``Linear``; its conv kernels become ``Conv2d`` /
``ConvTranspose2d`` weights. Scalar gates are 0-d fp32 parameters, as in
the JAX package. Channels are axis 1 everywhere: ``channel_linear``
applies a ``Linear`` over that axis.

Compute dtype (the JAX package's ``--bf16``): parameters stay fp32 and a
layer computes in its input's dtype. ``Conv2d``, ``ConvTranspose2d``,
``Linear`` and ``channel_linear`` cast their weight and bias to it at use,
and every learnable gate is cast to it before its multiply or add
(``gate_cast``), where JAX casts them; the norms take fp32 statistics and
return the input's dtype. The port follows JAX's dtype at each module
boundary by these explicit casts, never by torch's promotion rules, which
keep a bf16 tensor bf16 against a 0-d fp32 tensor where JAX promotes.

On a band of a frame split over the mesh's 'seq' axis
(``parallel.tensor.banded``): a convolution taller than one row takes the
rows beyond its band from the neighbouring ranks (``halo``: (k - 1) // 2
above and k // 2 below, as torch's "same" padding splits an even kernel)
and pads only the columns; the transposed convolution takes the rows its
stride and padding reach below (and above) the band; InstanceNorm and
GroupNorm take the mean and then the variance about it over the whole
frame (``sum_seq`` of the bands' sums: two passes, as ``_stats``). The
per-token layers need nothing. Outside a band every layer computes what it
computes in one process. Each of these collectives has its exact adjoint
as its backward (the reverse halo-add, the sum of the incoming gradients),
so the layers train on a band as they do whole.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.device import deterministic_cudnn
from adnm_tpu_torch.parallel.multihost import all_reduce_sum
from adnm_tpu_torch.parallel.tensor import (banded, halo, model_slice, reduce_model, seq_size,
                                            sum_seq)
from adnm_tpu_torch.ops.rms_norm import gated_rms_norm, rms_norm

IntPair = Union[int, Tuple[int, int]]


def scalar_param(value: float) -> nn.Parameter:
    """A learnable 0-d fp32 scalar (JAX: ``scalar_param``)."""
    return nn.Parameter(torch.tensor(float(value)))


def channel_view(p: torch.Tensor, ndim: int) -> torch.Tensor:
    """A (C,) parameter shaped to broadcast over axis 1 of an ndim tensor."""
    return p.view(1, -1, *([1] * (ndim - 2)))


def gate_cast(x: torch.Tensor, *ps: torch.Tensor):
    """The fp32 gate parameters ``ps`` cast to ``x``'s dtype for their
    multiply or add sites (JAX: ``gate_cast``): under bf16 compute a gate is
    rounded to bf16 first, as in JAX; under fp32 the cast returns the
    parameter itself. One tensor for one gate, else a tuple."""
    out = tuple(p.to(x.dtype) for p in ps)
    return out if len(out) > 1 else out[0]


def channel_scale(x: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``x`` times a (C,) fp32 gate over axis 1, cast to ``x``'s dtype so a
    bf16 activation is not promoted to fp32 (JAX: ``gate_cast``)."""
    return x * channel_view(gate.to(x.dtype), x.dim())


def _cast(p: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    return None if p is None else p.to(x.dtype)


def _same_split(k: int, padding) -> Tuple[int, int]:
    """(before, after) zero rows or columns of a stride-1 convolution of
    ``k`` taps with ``padding`` ("same" or an int), which must keep the
    size: "same" puts (k - 1) // 2 before, as torch does."""
    if padding == "same":
        return (k - 1) // 2, k // 2
    if 2 * padding != k - 1:
        raise ValueError(f"a band needs a size-keeping convolution: {k} taps, padding {padding}")
    return padding, padding


def conv2d(conv: nn.Conv2d, x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor], groups: int) -> torch.Tensor:
    """``F.conv2d`` of ``x`` with ``weight``, ``bias`` and ``groups`` at
    ``conv``'s stride, padding and dilation. On a band of a split frame
    (``banded``) a kernel taller than one row reads the neighbouring
    ranks' rows (``halo``) where it would read zero padding past the band,
    and pads only the columns; elsewhere, and for one-row kernels, it is
    the one-process call."""
    kh, kw = weight.shape[2:]
    if kh == 1 or not banded():
        return F.conv2d(x, weight, bias, conv.stride, conv.padding, conv.dilation, groups)
    if conv.stride != (1, 1) or conv.dilation != (1, 1):
        raise ValueError(f"a band takes stride-1, undilated convolutions, got stride "
                         f"{conv.stride}, dilation {conv.dilation}")
    pad = conv.padding
    top, bottom = _same_split(kh, pad if pad == "same" else pad[0])
    left, right = _same_split(kw, pad if pad == "same" else pad[1])
    x = halo(x, top, bottom)
    if left != right:
        return F.conv2d(F.pad(x, (left, right)), weight, bias, 1, 0, 1, groups)
    return F.conv2d(x, weight, bias, 1, (0, left), 1, groups)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` in its input's dtype: the fp32 weight and bias are cast
    at use (JAX: ``Conv2d``'s ``astype``); their gradients reach the fp32
    parameters as fp32. On a band of a split frame, ``conv2d``'s halo."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(self, x, self.weight.to(x.dtype), _cast(self.bias, x), self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` in its input's dtype, as ``Conv2d`` (no
    ``output_size``: the padding is fixed at construction), on cuDNN's
    deterministic algorithms: its default choice for a transposed conv may
    be nondeterministic, and two forwards of one input then differ (6e-8
    at the ADNM-UNet's ``decoder.up_sample2`` on an H100, up to 3e-4 at the
    model's output). On a band of a split frame the input rows the band's
    output rows read beyond the band come from the neighbouring ranks
    (``halo``): with stride s, padding p and k taps, (k - 1 - p) // s above
    and (s - 1 + p) // s below (the model's s 2, p 1, k 3: one below, whose
    zero rows at the frame's bottom give the output_padding row)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), _cast(self.bias, x)
        with deterministic_cudnn():
            if not banded():
                return F.conv_transpose2d(x, w, b, self.stride, self.padding,
                                          self.output_padding, self.groups, self.dilation)
            (s, sw), (p, pw), k = self.stride, self.padding, self.kernel_size[0]
            if self.dilation != (1, 1):
                raise ValueError("a band takes undilated transposed convolutions")
            top, bottom, n = max(0, (k - 1 - p) // s), (s - 1 + p) // s, x.shape[2]
            # output row o of the halo'd input is band row o - (top s + p)
            y = F.conv_transpose2d(halo(x, top, bottom), w, b, (s, sw), (0, pw),
                                   (0, self.output_padding[1]), self.groups)
            return y[:, :, top * s + p:top * s + p + s * n]


class Linear(nn.Linear):
    """``nn.Linear`` in its input's dtype, as ``Conv2d`` (JAX: ``Dense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x))


def rows_of(t: Optional[torch.Tensor], rows) -> Optional[torch.Tensor]:
    """The rows of ``t`` in the (start, stop) ranges ``rows``, in order:
    ``t`` itself where they cover it in order, or where ``rows`` is None
    (None stays None)."""
    if t is None or rows is None:
        return t
    merged = []
    for a, b in rows:
        if merged and merged[-1][1] == a:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    if merged == [(0, t.shape[0])]:
        return t
    return torch.cat([t[a:b] for a, b in merged])


def channel_linear(lin: nn.Linear, x: torch.Tensor, rows=None) -> torch.Tensor:
    """``lin`` over the channel axis 1 of a (B, C, H, W) tensor (a 1x1 conv),
    in ``x``'s dtype; with ``rows``, its outputs in those ranges alone
    (``rows_of``)."""
    return F.conv2d(x, rows_of(lin.weight, rows).to(x.dtype)[:, :, None, None],
                    _cast(rows_of(lin.bias, rows), x))


def conv_rows(conv: nn.Conv2d, x: torch.Tensor, rows) -> torch.Tensor:
    """``conv`` (dense, or depthwise over ``x``'s channels) for its output
    channels in the ranges ``rows`` alone (``rows_of``), in ``x``'s dtype:
    ``conv`` itself where they cover it."""
    weight = rows_of(conv.weight, rows)
    if weight is conv.weight:
        return conv(x)
    return conv2d(conv, x, weight.to(x.dtype), _cast(rows_of(conv.bias, rows), x),
                  1 if conv.groups == 1 else x.shape[1])


def _stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 (biased variance, mean) over ``dims`` (jnp.var is biased)."""
    return torch.var_mean(x.float(), dim=dims, keepdim=True, correction=0)


def _frame_stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_stats`` over ``dims``, which hold the rows of a frame; on a band
    of a split frame (``banded``), over the whole frame: the mean from the
    bands' sums, then the variance from their sums of squared deviations
    about it (two passes: E[x^2] - E[x]^2 cancels at 256^2)."""
    if not banded():
        return _stats(x, dims)
    xf = x.float()
    count = math.prod(x.shape[d] for d in dims) * seq_size()
    mu = sum_seq(xf.sum(dim=dims, keepdim=True)) / count
    var = sum_seq((xf - mu).square().sum(dim=dims, keepdim=True)) / count
    return var, mu


class BiasFreeLayerNorm(nn.Module):
    """LayerNorm over the channel axis with weight, no bias, eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mu = _stats(x, 1)
        out = (x.float() - mu) * torch.rsqrt(var + self.eps) * channel_view(self.weight, x.dim())
        return out.to(x.dtype)


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: ``scale`` and ``bias``
    (its parameter names), eps 1e-6 by default; the transformers of
    TransUnet and SwinUnet normalise (B, L, C) tokens with it. As flax's
    with ``dtype=None``, it returns the promoted type of the input and the
    fp32 parameters: a bf16 input comes out fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, self.scale.dtype))
        return F.layer_norm(x, self.scale.shape, self.scale, self.bias, self.eps)


class RMSNorm(nn.Module):
    """RMS norm over ``axis`` (the Block norms use axis 1, the channels of
    NCHW): kernel K1 on CUDA tensors, its plain version on CPU tensors."""

    def __init__(self, dim: int, eps: float = 1e-6, axis: int = -1):
        super().__init__()
        self.eps = eps
        self.axis = axis
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps, self.axis)


class GatedRMSNorm(nn.Module):
    """``RMSNorm(x * silu(z)) * weight`` over ``axis``, the norm after the
    gate, as the JAX module's code and the Pallas kernel compute it (its
    docstring, ``RMSNorm(x) * silu(z)``, says otherwise): kernel K3 on CUDA
    tensors, its plain version on CPU tensors. Differentiable over the last
    axis, the JAX module's, through K3's backward kernel (its plain version
    on the CPU); the backward raises on any other axis."""

    def __init__(self, dim: int, eps: float = 1e-6, axis: int = -1):
        super().__init__()
        self.eps = eps
        self.axis = axis
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return gated_rms_norm(x, z, self.weight, self.eps, self.axis)


class InstanceNorm(nn.Module):
    """Per-(sample, channel) normalisation over H, W; no affine, eps 1e-5."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mu = _frame_stats(x, (2, 3))
        return ((x.float() - mu) * torch.rsqrt(var + self.eps)).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with affine weight and bias, eps 1e-5."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xg = x.float().reshape(b, self.groups, c // self.groups, h, w)
        var, mu = _frame_stats(xg, (2, 3, 4))
        xn = ((xg - mu) * torch.rsqrt(var + self.eps)).reshape(b, c, h, w)
        return (xn * channel_view(self.weight, 4) + channel_view(self.bias, 4)).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over (B, H, W) of NCHW, eps 1e-5, momentum 0.1 (JAX:
    ``BatchNorm``, torch's defaults). In train mode it normalises with the
    batch's biased variance and moves the running statistics towards the
    batch's mean and unbiased variance; in eval mode it normalises with the
    running statistics. The variance is taken about the mean
    (``torch.var_mean``): JAX's E[x^2] - E[x]^2 loses the digits that
    mean^2 / variance costs, which SmaAt-UNet's BatchNorms reach hundreds
    of times in training (``scripts/torch_baseline_precision.py`` measures
    the fp32 step against fp64). The running statistics are the buffers ``mean`` and ``var``, the leaves of the JAX
    ``batch_stats`` tree, so they land in ``state_dict()`` and in the
    port's checkpoints. Statistics in fp32; the output in the input's
    dtype.

    Under data parallelism (``process_group`` set, by ``sync_batch_norm``,
    to a group of two or more ranks) a train-mode forward takes the
    statistics of the global batch, as JAX's BatchNorm does over a 'data'
    mesh: the mean from the per-channel sums all-reduced over the ranks,
    then the variance about that mean by a second all-reduce, over the
    global count (every rank holds as many rows, as the loader's
    ``row_shard`` gives). Both reductions are differentiable, so the
    gradient is the single process's on the global batch, and the running
    statistics move alike on every rank. Eval mode is unchanged."""

    batch_stats = ("mean", "var")  # the buffers ``convert`` carries

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.process_group = None  # set by sync_batch_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            n = x.numel() // x.shape[1]
            group = self.process_group
            if group is not None and dist.get_world_size(group) > 1:
                world = dist.get_world_size(group)
                mu = all_reduce_sum(xf.sum(dim=(0, 2, 3)), group) / (n * world)
                var = all_reduce_sum((xf - channel_view(mu, 4)).square().sum(dim=(0, 2, 3)),
                                     group) / (n * world)
                n *= world
            else:
                var, mu = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_((1 - m) * self.mean + m * mu)
                self.var.copy_((1 - m) * self.var + m * (var * n / max(n - 1, 1)))
        else:
            mu, var = self.mean, self.var
        out = (xf - channel_view(mu, 4)) * torch.rsqrt(channel_view(var, 4) + self.eps)
        return (out * channel_view(self.weight, 4) + channel_view(self.bias, 4)).to(x.dtype)


def sync_batch_norm(model: nn.Module, group=None) -> int:
    """Give every BatchNorm of ``model`` the process ``group`` (the default
    group when None) over which its train-mode statistics are taken: the
    mesh's 'data' group (the ``Trainer``), since the 'seq' and 'model' ranks
    of a position hold the same rows and would change the count; returns
    how many there are."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.process_group = dist.group.WORLD if group is None else group
    return len(norms)


def make_norm(kind: str, dim: int) -> nn.Module:
    return {
        "instance": lambda: InstanceNorm(),
        "group4": lambda: GroupNorm(4, dim),
        "group8": lambda: GroupNorm(8, dim),
    }[kind]()


ACTS = {
    None: None,
    "gelu": functools.partial(F.gelu, approximate="tanh"),  # jax.nn.gelu is the tanh form
}


class Swish(nn.Module):
    """x * sigmoid(beta * x) with a learnable beta."""

    def __init__(self, beta_init: float = 1.0):
        super().__init__()
        self.beta = scalar_param(beta_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(gate_cast(x, self.beta) * x)


class IntensityGate(nn.Module):
    """silu(enhance * (x - threshold)) with learnable threshold and enhance."""

    def __init__(self, threshold_init: float = 0.0):
        super().__init__()
        self.threshold = scalar_param(threshold_init)
        self.enhance = scalar_param(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        threshold, enhance = gate_cast(x, self.threshold, self.enhance)
        return F.silu(enhance * (x - threshold))


class _NormalizedLayer(nn.Module):
    """``scale * norm(x) + shift`` then an activation, after ``self.conv``
    (the tail shared by ConvLayer and WTConvLayer). The norm
    module is registered under the name flax gives it automatically
    (``InstanceNorm_0``, ``GroupNorm_0``), so the parameter paths match."""

    def _init_tail(self, features: int, norm: Optional[str], act: Optional[str]):
        self.norm_name = None
        if norm is not None:
            n = make_norm(norm, features)
            self.norm_name = f"{type(n).__name__}_0"
            self.add_module(self.norm_name, n)
            self.scale = scalar_param(1.0)
            self.shift = scalar_param(0.0)
        self.act = ACTS[act]

    def _tail(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_name is not None:
            scale, shift = gate_cast(x, self.scale, self.shift)
            x = scale * getattr(self, self.norm_name)(x) + shift
        return self.act(x) if self.act is not None else x


class ConvLayer(_NormalizedLayer):
    """conv -> scale*norm(x)+shift -> act. ``padding`` is an int, a pair or
    "same"; ``swish`` puts a learnable Swish (``swish_act``) in place of
    ``act``."""

    def __init__(self, in_channels: int, features: int, kernel_size: IntPair = 3,
                 stride: IntPair = 1, padding: Union[str, IntPair] = 1, groups: int = 1,
                 use_bias: bool = True, norm: Optional[str] = None,
                 act: Optional[str] = None, swish: bool = False):
        super().__init__()
        self.conv = Conv2d(in_channels, features, kernel_size, stride, padding,
                           groups=groups, bias=use_bias)
        self._init_tail(features, norm, None if swish else act)
        if swish:
            self.swish_act = Swish()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._tail(self.conv(x))
        return self.swish_act(x) if hasattr(self, "swish_act") else x


class DeConvLayer(nn.Module):
    """Transposed-conv upsampling by ``ratio`` with the reference's padding
    math (no caller uses the JAX layer's norm and act, so they are not
    ported). The JAX ConvTranspose2d stores the HWIO kernel of the
    equivalent forward conv and flips it itself; torch's ConvTranspose2d
    weight (cin, cout, kh, kw) is that kernel transposed, unflipped
    (``convert`` maps it)."""

    def __init__(self, in_channels: int, features: int, ratio: int = 4,
                 kernel_size: Tuple[int, int] = (3, 3), use_bias: bool = True):
        super().__init__()
        k = kernel_size[1]
        padding = max(0, (k - ratio + 1) // 2)
        output_padding = ratio - k + 2 * padding
        self.trans_conv = ConvTranspose2d(
            in_channels, features, kernel_size, stride=ratio, padding=padding,
            output_padding=output_padding, bias=use_bias,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trans_conv(x)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 over the channel axis."""

    def __init__(self, dim: int, hidden: Optional[int] = None, out: Optional[int] = None):
        super().__init__()
        hidden = hidden or dim * 2
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, out or dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_linear(self.fc2, ACTS["gelu"](channel_linear(self.fc1, x)))


class FeedForward(nn.Module):
    """1x1 expand (2*hidden) -> dw 3x3 -> gelu(x1)*sigmoid(x2) -> 1x1. On a
    mesh's 'model' axis each rank takes its part of the hidden channels
    (JAX: the 'model' annotation of the expanded channels, Megatron-style,
    adnm_tpu/core/layers.py:713-760); on a band over 'seq' the dw 3x3
    takes its one-row halo (``conv2d``)."""

    def __init__(self, dim: int, expansion: int = 2):
        super().__init__()
        hidden = int(dim * expansion)
        self.hidden = hidden
        self.project_in = ConvLayer(dim, hidden * 2, 1, 1, 0)
        self.dwconv = ConvLayer(hidden * 2, hidden * 2, 3, 1, 1, groups=hidden * 2)
        self.project_out = ConvLayer(hidden, dim, 1, 1, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        part = model_slice(self.hidden)
        s, e = (0, self.hidden) if part is None else (part.start, part.stop)
        rows = [(s, e), (self.hidden + s, self.hidden + e)]  # of x1 and of x2
        y = conv_rows(self.dwconv.conv, conv_rows(self.project_in.conv, x, rows), rows)
        x1, x2 = y.chunk(2, dim=1)
        y = ACTS["gelu"](x1) * torch.sigmoid(x2)
        if part is None:
            return self.project_out(y)
        # this rank's columns of project_out; the partial outputs summed,
        # then the bias added once
        pout = self.project_out.conv
        out = reduce_model(F.conv2d(y, pout.weight[:, part].to(y.dtype)))
        return out if pout.bias is None else out + channel_view(pout.bias.to(y.dtype), 4)


class ConvFFD(nn.Module):
    """linear expand -> dw 3x3 conv -> GELU -> linear project."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj = Linear(dim, dim * 2)
        self.dw_conv = ConvLayer(dim * 2, dim * 2, 3, 1, 1, groups=dim * 2)
        self.out_proj = Linear(dim * 2, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ACTS["gelu"](self.dw_conv(channel_linear(self.in_proj, x)))
        return channel_linear(self.out_proj, x)


def _fan_in(weight: torch.Tensor) -> int:
    # (out, in/groups, kh, kw) for Conv2d and Linear; (in, out/groups, kh,
    # kw) for ConvTranspose2d, where the JAX init also takes out/groups.
    return weight.shape[1] * math.prod(weight.shape[2:])


def seeded_init_(model: nn.Module, seed: int) -> nn.Module:
    """Draw every random parameter from a ``torch.Generator`` seeded with
    ``seed``, with the JAX package's init distributions: kaiming-uniform
    (a=sqrt(5)) kernels and fan-in-uniform biases, both U(+-1/sqrt(fan_in));
    modules with other random parameters define ``reset_random_(gen)``.
    Constant inits (gates, norm weights) are set at construction. Run on
    CPU parameters, so the weights do not depend on the device."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                bound = 1.0 / math.sqrt(_fan_in(m.weight))
                m.weight.uniform_(-bound, bound, generator=gen)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=gen)
            elif hasattr(m, "reset_random_"):
                m.reset_random_(gen)
    return model
