"""Softmax multi-head attention on NCHW tensors
(counterpart of adnm_tpu/mixers/attention.py::StandardAttention)."""

from __future__ import annotations

import torch
from torch import nn

from adnm_tpu_torch.core.layers import Linear, channel_linear


class StandardAttention(nn.Module):
    """Softmax MHA over the H*W tokens of a (B, dim, H, W) tensor, in plain
    matrix products. The qkv channels are [q | k | v], each head-major
    (head * dim_head + i), as in the JAX module. In the input's dtype: the
    logits and the softmax too, as JAX gives them."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.to_qkv = Linear(dim, inner * 3, bias=False)
        self.to_out = Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        qkv = channel_linear(self.to_qkv, x).reshape(b, 3, self.heads, self.dim_head, h * w)
        q, k, v = qkv.unbind(1)  # (B, heads, dim_head, L)
        logits = torch.einsum("bhdi,bhdj->bhij", q, k) * self.dim_head ** -0.5
        out = torch.einsum("bhij,bhdj->bhdi", logits.softmax(dim=-1), v)
        return channel_linear(self.to_out, out.reshape(b, -1, h, w))
