"""SmaAt-UNet: a depthwise-separable U-Net with CBAM attention on its
skips (counterpart of adnm_tpu/models/smaat_unet.py; reference:
models/SmaAt_UNet.py:302-354).

(B, T_in, 1, H, W) -> (B, n_classes, 1, H, W): the input frames are the
channels (SmaAt_UNet.py:337,353). H and W must be multiples of 16. The
align_corners=True bilinear 2x upsample is two products with the
interpolation matrices, as in JAX: the same function as
``F.interpolate(scale_factor=2, mode="bilinear", align_corners=True)``,
but its backward is a matrix product, where ``F.interpolate``'s sums with
atomics on CUDA in an order that changes from run to run. BatchNorm keeps
running statistics (``core.layers.BatchNorm``, fp32 statistics in any
compute dtype). In bf16 compute the down path is bf16 and the up path fp32
from the first upsample on, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import BatchNorm, Conv2d, Linear


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_in: int, factor: int) -> np.ndarray:
    """(n_out, n_in) align_corners=True bilinear interpolation matrix."""
    n_out = n_in * factor
    m = np.zeros((n_out, n_in), np.float32)
    if n_out == 1:
        m[0, 0] = 1.0
        return m
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        w = src - lo
        m[i, lo] += 1.0 - w
        m[i, hi] += w
    return m


@functools.lru_cache(maxsize=64)
def _interp_tensor(n_in: int, factor: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """The matrix on ``device``, made once: a copy from host memory at each
    call would wait for the device. Made outside inference mode, so that
    a model served under ``torch.inference_mode`` still trains."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix(n_in, factor)).to(device, dtype)


def upsample_bilinear_align_corners(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """NCHW bilinear upsample by ``factor`` with align_corners=True: rows,
    then columns, each a product with its interpolation matrix. The
    matrices are fp32, as JAX's, and promote a bf16 ``x``: the result is
    fp32 (JAX: the einsum of an fp32 matrix and a bf16 activation)."""
    _, _, h, w = x.shape
    dtype = torch.promote_types(x.dtype, torch.float32)
    x = x.to(dtype)
    mh = _interp_tensor(h, factor, x.device, dtype)
    mw = _interp_tensor(w, factor, x.device, dtype)
    return torch.matmul(torch.matmul(mh, x), mw.T)


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3x3 with a depth multiplier, then a pointwise 1x1
    (reference: SmaAt_UNet.py:32-48)."""

    def __init__(self, in_channels: int, features: int, kernels_per_layer: int = 1):
        super().__init__()
        self.depthwise = Conv2d(in_channels, in_channels * kernels_per_layer, 3, 1, 1,
                                groups=in_channels)
        self.pointwise = Conv2d(in_channels * kernels_per_layer, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class DoubleConvDS(nn.Module):
    """(dsconv -> BatchNorm -> ReLU) x 2 (reference: SmaAt_UNet.py:144-173)."""

    def __init__(self, in_channels: int, features: int, mid: Optional[int] = None,
                 kernels_per_layer: int = 1):
        super().__init__()
        mid = mid or features
        self.conv1 = DepthwiseSeparableConv(in_channels, mid, kernels_per_layer)
        self.bn1 = BatchNorm(mid)
        self.conv2 = DepthwiseSeparableConv(mid, features, kernels_per_layer)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class ChannelAttention(nn.Module):
    """CBAM channel attention (reference: SmaAt_UNet.py:88-109)."""

    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        hidden = channels // reduction_ratio
        self.fc1 = Linear(channels, hidden)
        self.fc2 = Linear(hidden, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(v):
            return self.fc2(F.relu(self.fc1(v)))

        gate = mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3)))
        return x * torch.sigmoid(gate)[:, :, None, None]


class SpatialAttention(nn.Module):
    """CBAM spatial attention (reference: SmaAt_UNet.py:112-127)."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        pad = 3 if kernel_size == 7 else 1
        self.conv = Conv2d(2, 1, kernel_size, 1, pad, bias=False)
        self.bn = BatchNorm(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.bn(self.conv(out)))


class CBAM(nn.Module):
    def __init__(self, channels: int, reduction_ratio: int = 16):
        super().__init__()
        self.channel_att = ChannelAttention(channels, reduction_ratio)
        self.spatial_att = SpatialAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial_att(self.channel_att(x))


class SmaAtUNet(nn.Module):
    """Reference: SmaAt_UNet.py:302-354."""

    def __init__(self, n_channels: int, n_classes: int, kernels_per_layer: int = 2,
                 reduction_ratio: int = 16):
        super().__init__()
        kpl, rr = kernels_per_layer, reduction_ratio
        self.inc = DoubleConvDS(n_channels, 64, kernels_per_layer=kpl)
        self.cbam1 = CBAM(64, rr)
        widths = (64, 128, 256, 512, 512)
        for i in range(1, 5):
            self.add_module(f"down{i}", DoubleConvDS(widths[i - 1], widths[i],
                                                     kernels_per_layer=kpl))
            self.add_module(f"cbam{i + 1}", CBAM(widths[i], rr))
        # (skip + upsampled channels, features, mid) of up1..up4
        for i, (cin, feats, mid) in enumerate(((1024, 256, 512), (512, 128, 256),
                                               (256, 64, 128), (128, 64, None)), 1):
            self.add_module(f"up{i}", DoubleConvDS(cin, feats, mid, kpl))
        self.outc = Conv2d(64, n_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, 0]  # the frames as channels
        x = self.inc(x)
        skips = [self.cbam1(x)]
        for i in range(1, 5):
            x = getattr(self, f"down{i}")(F.max_pool2d(x, 2))
            skips.append(getattr(self, f"cbam{i + 1}")(x))
        y = skips.pop()
        for i in range(1, 5):
            y = torch.cat([skips.pop(), upsample_bilinear_align_corners(y)], dim=1)
            y = getattr(self, f"up{i}")(y)
        return self.outc(y)[:, :, None]  # (B, T_out, 1, H, W)
