"""TransUnet: an R50+ViT-B/16 hybrid encoder with a cascaded upsampler, on
NCHW tensors (counterpart of adnm_tpu/models/trans_unet.py; reference:
models/TransUnet.py).

(B, T_in, 1, H, W) -> (B, n_classes, 1, H, W): the input frames are the
channels (three copies of a single frame). A weight-standardised ResNetV2
root and three pre-activation bottleneck stages (3, 4, 9 units) with
GroupNorm; a 1x1 patch embedding of its (H/16)^2 grid into ``hidden``
tokens with learnt position embeddings; ``num_layers`` pre-norm ViT blocks
(tanh GELU, as ``jax.nn.gelu``) with dropout at four sites; the
DecoderCup's Conv-BatchNorm-ReLU stages with three skips and bilinear 2x
upsamples (the fixed-order interpolation-matrix products of
``smaat_unet.upsample_bilinear_align_corners``); a 3x3 segmentation head.
The max pool after the root is 3x3, stride 2, unpadded (128 -> 63 at
256^2); the reference zero-pads the 63^2 stage-1 feature to 64^2 for its
skip alone, and the body goes on unpadded. BatchNorm keeps running
statistics; Dropout draws its masks from the ``Trainer``'s generator
(``core.stochastic``). In bf16 compute the ResNetV2 and the patch
embedding are bf16; the fp32 position embeddings promote the tokens, so
the ViT and the decoder are fp32, as in JAX.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import ACTS, BatchNorm, Conv2d, GroupNorm, LayerNorm, Linear
from adnm_tpu_torch.core.stochastic import Dropout
from adnm_tpu_torch.models.smaat_unet import upsample_bilinear_align_corners


class StdConv2d(nn.Conv2d):
    """Weight-standardised conv: each output filter standardised over
    (cin, kh, kw) with the population variance and eps 1e-5 at use, in
    fp32, then cast to the input's dtype (reference: TransUnet.py:28-35;
    JAX: ``w.astype(x.dtype)``)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(in_channels, features, kernel_size, stride, padding, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mu = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True, correction=0)
        w = (self.weight - mu) * torch.rsqrt(var + 1e-5)
        return F.conv2d(x, w.to(x.dtype), None, self.stride, self.padding)


class PreActBottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 weight-standardised convs with GroupNorm
    (32 groups, eps 1e-6) and ReLU, plus a projection shortcut (1x1 conv,
    GroupNorm with one group per channel) where the stride or the width
    changes (reference: TransUnet.py:48-84)."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.downsample = self.gn_proj = None
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride)
            self.gn_proj = GroupNorm(cout, cout)
        self.conv1 = StdConv2d(cin, cmid, 1)
        self.gn1 = GroupNorm(32, cmid, 1e-6)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride, 1)
        self.gn2 = GroupNorm(32, cmid, 1e-6)
        self.conv3 = StdConv2d(cmid, cout, 1)
        self.gn3 = GroupNorm(32, cout, 1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        return F.relu(residual + self.gn3(self.conv3(y)))


class ResNetV2(nn.Module):
    """The hybrid encoder's CNN (reference: TransUnet.py:122-170). Returns
    the stage-3 feature map and the skips, deepest first: stage 2, stage 1
    (zero-padded to H/4 where the pool left it short) and the root."""

    def __init__(self, in_channels: int, block_units: Sequence[int] = (3, 4, 9),
                 width_factor: int = 1):
        super().__init__()
        width = int(64 * width_factor)
        self.block_units = tuple(block_units)
        self.root_conv = StdConv2d(in_channels, width, 7, 2, 3)
        self.root_gn = GroupNorm(32, width, 1e-6)
        cin = width
        for bi, (cmid, cout, stride) in enumerate(
                [(width, width * 4, 1), (width * 2, width * 8, 2), (width * 4, width * 16, 2)]):
            for ui in range(self.block_units[bi]):
                self.add_module(f"block{bi + 1}_unit{ui + 1}",
                                PreActBottleneck(cin, cout, cmid, stride if ui == 0 else 1))
                cin = cout

    def forward(self, x: torch.Tensor):
        in_size = x.shape[2]
        x = F.relu(self.root_gn(self.root_conv(x)))
        features = [x]
        x = F.max_pool2d(x, 3, 2)
        for bi, units in enumerate(self.block_units):
            for ui in range(units):
                x = getattr(self, f"block{bi + 1}_unit{ui + 1}")(x)
            if bi < 2:
                pad = in_size // 4 // (bi + 1) - x.shape[2]
                features.append(F.pad(x, (0, pad, 0, pad)) if pad else x)
        return x, features[::-1]


class ViTBlock(nn.Module):
    """Pre-norm multi-head attention and MLP on (B, L, hidden) tokens, each
    residual branch through dropout (reference: TransUnet.py:491-510)."""

    def __init__(self, hidden: int = 768, heads: int = 12, mlp_dim: int = 3072,
                 dropout: float = 0.1):
        super().__init__()
        self.heads = heads
        self.attention_norm = LayerNorm(hidden, 1e-6)
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        self.out = Linear(hidden, hidden)
        self.ffn_norm = LayerNorm(hidden, 1e-6)
        self.fc1 = Linear(hidden, mlp_dim)
        self.fc2 = Linear(mlp_dim, hidden)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, hidden = x.shape
        hd = hidden // self.heads
        y = self.attention_norm(x)

        def split_heads(t):
            return t.reshape(b, l, self.heads, hd).transpose(1, 2)

        q, k, v = (split_heads(lin(y)) for lin in (self.query, self.key, self.value))
        attn = (torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)).softmax(dim=-1)
        o = torch.matmul(attn, v).transpose(1, 2).reshape(b, l, hidden)
        x = x + self.dropout(self.out(o))
        y = self.dropout(ACTS["gelu"](self.fc1(self.ffn_norm(x))))
        return x + self.dropout(self.fc2(y))


class Conv2dReLU(nn.Module):
    """conv (no bias) -> BatchNorm -> ReLU (reference: TransUnet.py:582-604)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3, padding: int = 1):
        super().__init__()
        self.conv = Conv2d(cin, features, kernel_size, 1, padding, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class TransUnet(nn.Module):
    """Reference: TransUnet.py:693-716 (VisionTransformer). ``in_channels``
    is the number of input frames (3 for a single frame, which is
    repeated); ``img_size`` fixes the position embeddings' grid."""

    def __init__(self, n_classes: int, img_size: int = 256, in_channels: int = 5,
                 hidden: int = 768, num_layers: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 dropout: float = 0.1, decoder_channels: Sequence[int] = (256, 128, 64, 16),
                 n_skip: int = 3):
        super().__init__()
        self.n_skip = n_skip
        self.num_layers = num_layers
        self.hybrid_model = ResNetV2(in_channels)
        self.patch_embeddings = Conv2d(1024, hidden, 1, 1, 0)
        self.position_embeddings = nn.Parameter(torch.zeros(1, (img_size // 16) ** 2, hidden))
        self.dropout = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"block_{i}", ViTBlock(hidden, heads, mlp_dim, dropout))
        self.encoder_norm = LayerNorm(hidden, 1e-6)
        self.conv_more = Conv2dReLU(hidden, 512)
        skip_channels = (512, 256, 64)  # stage 2, stage 1, root of ResNetV2
        cin = 512
        for i, ch in enumerate(decoder_channels):
            skip = skip_channels[i] if i < n_skip else 0
            self.add_module(f"dec{i}_conv1", Conv2dReLU(cin + skip, ch))
            self.add_module(f"dec{i}_conv2", Conv2dReLU(ch, ch))
            cin = ch
        self.n_decoder = len(decoder_channels)
        self.segmentation_head = Conv2d(cin, n_classes, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, :, 0]
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        feat, skips = self.hybrid_model(x)
        y = self.patch_embeddings(feat)
        b, hidden, gh, gw = y.shape
        y = self.dropout(y.flatten(2).transpose(1, 2) + self.position_embeddings)
        for i in range(self.num_layers):
            y = getattr(self, f"block_{i}")(y)
        y = self.encoder_norm(y).transpose(1, 2).reshape(b, hidden, gh, gw)
        y = self.conv_more(y)
        for i in range(self.n_decoder):
            y = upsample_bilinear_align_corners(y, 2)
            if i < self.n_skip:
                y = torch.cat([y, skips[i]], dim=1)
            y = getattr(self, f"dec{i}_conv2")(getattr(self, f"dec{i}_conv1")(y))
        return self.segmentation_head(y)[:, :, None]


def create_trans_unet(output_frames: int, img_size: int = 256,
                      input_frames: int = 5) -> TransUnet:
    """Reference: TransUnet.py:798-799 (create_TransUnet)."""
    return TransUnet(n_classes=output_frames, img_size=img_size,
                     in_channels=3 if input_frames == 1 else input_frames)
