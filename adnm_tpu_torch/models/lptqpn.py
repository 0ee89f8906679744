"""LPTQPN: a Restormer-style U-Net with transposed ("squared") channel
attention (counterpart of adnm_tpu/models/lptqpn.py; reference:
models/LPTQPN.py).

The reference's quirks are kept, as in JAX: its layer norm subtracts the
mean, divides by the biased standard deviation (eps 1e-5) and ends in a
sigmoid (LPTQPN.py:35); attention is a sigmoid of q·k times a per-head
temperature, with q and k divided by their norm + 1e-12 (LPTQPN.py:96-98);
the FFN's GELU is ``jax.nn.gelu``'s tanh form; the ConvectionDiffusionLoss
heads (LPTQPN.py:257-262) are dead in the reference forward and are not
built. (B, T_in, 1, H, W) -> (B, out_channels, 1, H, W), H and W multiples
of 8. In bf16 compute the model is fp32 from its first attention's
temperature on, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import ACTS, Conv2d, Swish, channel_view


class SigmoidLayerNorm(nn.Module):
    """sigmoid(LayerNorm over channels with weight, no bias)
    (reference: LPTQPN.py:17-35)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mu = torch.var_mean(x.float(), dim=1, keepdim=True, correction=0)
        out = (x.float() - mu) * torch.rsqrt(var + 1e-5) * channel_view(self.weight, x.dim())
        return torch.sigmoid(out).to(x.dtype)


class SquaredAttention(nn.Module):
    """Transposed channel attention, sigmoid-activated
    (reference: LPTQPN.py:71-105)."""

    def __init__(self, dim: int, num_heads: int, use_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads))
        self.qkv = Conv2d(dim, dim * 3, 1, bias=use_bias)
        self.qkv_dwconv = Conv2d(dim * 3, dim * 3, 3, 1, 1, groups=dim * 3, bias=use_bias)
        self.project_out = Conv2d(dim, dim, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape

        def heads(t):  # (B, C, H, W) -> (B, heads, C / heads, H*W), unit rows
            t = t.reshape(b, self.num_heads, c // self.num_heads, h * w)
            return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)

        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        attn = torch.matmul(heads(q), heads(k).transpose(-1, -2))
        # the fp32 temperature promotes a bf16 product, and v with it (JAX)
        attn = torch.sigmoid(attn * self.temperature[None, :, None, None])
        v = v.reshape(b, self.num_heads, c // self.num_heads, h * w).to(attn.dtype)
        out = torch.matmul(attn, v)
        return self.project_out(out.reshape(b, c, h, w))


class GatedFFN(nn.Module):
    """1x1 expand -> depthwise 3x3 -> gelu(x1) * sigmoid(x2) -> 1x1
    (reference: LPTQPN.py:49-66)."""

    def __init__(self, dim: int, expansion: float = 2.66, use_bias: bool = False):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = Conv2d(dim, hidden * 2, 1, bias=use_bias)
        self.dwconv = Conv2d(hidden * 2, hidden * 2, 3, 1, 1, groups=hidden * 2, bias=use_bias)
        self.project_out = Conv2d(hidden, dim, 1, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(ACTS["gelu"](x1) * torch.sigmoid(x2))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, expansion: float = 2.66,
                 use_bias: bool = False):
        super().__init__()
        self.norm1 = SigmoidLayerNorm(dim)
        self.attn = SquaredAttention(dim, num_heads, use_bias)
        self.norm2 = SigmoidLayerNorm(dim)
        self.ffn = GatedFFN(dim, expansion, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class LPTQPN(nn.Module):
    """Reference: LPTQPN.py:205-313. Module names follow the JAX model's:
    ``enc{1,2,3}_i``, ``central_i``, ``dec{3,2,1}_i``, ``refine_i``,
    ``down{1,2,3}``, ``up{3,2,1}``."""

    def __init__(self, inp_channels: int = 5, out_channels: int = 20, dim: int = 20,
                 num_blocks: Sequence[int] = (4, 6, 6, 8), num_refinement_blocks: int = 2,
                 heads: Sequence[int] = (1, 2, 4, 8), expansion: float = 2.66,
                 use_bias: bool = False):
        super().__init__()
        d = dim

        def blocks(name, width, n, nh):
            for i in range(n):
                self.add_module(f"{name}_{i}", TransformerBlock(width, nh, expansion, use_bias))
            return [f"{name}_{i}" for i in range(n)]

        self.patch_embed = Conv2d(inp_channels, d, 3, 1, 1, bias=False)
        self.stages = {}
        self.stages["enc1"] = blocks("enc1", d, num_blocks[0], heads[0])
        self.down1 = Conv2d(d, d // 2, 3, 1, 1, bias=False)
        self.stages["enc2"] = blocks("enc2", d * 2, num_blocks[1], heads[1])
        self.down2 = Conv2d(d * 2, d, 3, 1, 1, bias=False)
        self.stages["enc3"] = blocks("enc3", d * 4, num_blocks[2], heads[2])
        self.down3 = Conv2d(d * 4, d * 2, 3, 1, 1, bias=False)
        self.stages["central"] = blocks("central", d * 8, num_blocks[3], heads[3])
        self.up3 = Conv2d(d * 8, d * 16, 3, 1, 1, bias=False)
        self.reduce_chan_level3 = Conv2d(d * 8, d * 4, 1, bias=use_bias)
        self.stages["dec3"] = blocks("dec3", d * 4, num_blocks[2], heads[2])
        self.up2 = Conv2d(d * 4, d * 8, 3, 1, 1, bias=False)
        self.reduce_chan_level2 = Conv2d(d * 4, d * 2, 1, bias=use_bias)
        self.stages["dec2"] = blocks("dec2", d * 2, num_blocks[1], heads[1])
        self.up1 = Conv2d(d * 2, d * 4, 3, 1, 1, bias=False)
        self.stages["dec1"] = blocks("dec1", d * 2, num_blocks[0], heads[0])
        self.stages["refine"] = blocks("refine", d * 2, num_refinement_blocks, heads[0])
        self.output = Conv2d(d * 2, out_channels, 3, 1, 1, bias=use_bias)
        self.last_conv = Conv2d(out_channels, out_channels, 3, 1, 1)
        self.last_swish = Swish()

    def _run(self, stage: str, x: torch.Tensor) -> torch.Tensor:
        for name in self.stages[stage]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x[:, :, 0]  # the frames as channels
        e1 = self._run("enc1", self.patch_embed(inp))
        e2 = self._run("enc2", F.pixel_unshuffle(self.down1(e1), 2))
        e3 = self._run("enc3", F.pixel_unshuffle(self.down2(e2), 2))
        central = self._run("central", F.pixel_unshuffle(self.down3(e3), 2))

        d3 = torch.cat([F.pixel_shuffle(self.up3(central), 2), e3], dim=1)
        d3 = self._run("dec3", self.reduce_chan_level3(d3))
        d2 = torch.cat([F.pixel_shuffle(self.up2(d3), 2), e2], dim=1)
        d2 = self._run("dec2", self.reduce_chan_level2(d2))
        d1 = torch.cat([F.pixel_shuffle(self.up1(d2), 2), e1], dim=1)
        d1 = self._run("refine", self._run("dec1", d1))

        out = self.output(d1) + inp[:, -1:]  # the last input frame, over every output
        return self.last_swish(self.last_conv(out))[:, :, None]
