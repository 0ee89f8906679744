"""Attention mixers (counterpart of adnm_tpu/mixers/attention.py): softmax
multi-head attention on NCHW tensors and DeepSeek-V2's multi-head latent
attention (MLA) on (B, L, D) tokens. On a mesh's 'model' axis the softmax
attention splits its heads (JAX: ``maybe_shard`` of q, k and v, :45-51);
MLA stays replicated, as JAX annotates nothing there."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import Linear, RMSNorm, channel_linear, channel_view
from adnm_tpu_torch.parallel.tensor import model_slice, reduce_model


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
        heads = model_slice(self.heads)  # this rank's heads on the 'model' axis
        s, e = (0, self.heads) if heads is None else (heads.start, heads.stop)
        dh, inner = self.dim_head, self.heads * self.dim_head
        rows = [(part * inner + s * dh, part * inner + e * dh) for part in range(3)]  # q, k, v
        qkv = channel_linear(self.to_qkv, x, rows).reshape(b, 3, e - s, dh, h * w)
        q, k, v = qkv.unbind(1)  # (B, heads, dim_head, L)
        logits = torch.einsum("bhdi,bhdj->bhij", q, k) * self.dim_head ** -0.5
        out = torch.einsum("bhij,bhdj->bhdi", logits.softmax(dim=-1), v).reshape(b, -1, h, w)
        if heads is None:
            return channel_linear(self.to_out, out)
        # this rank's columns of to_out; the partial outputs summed, then
        # the bias added once
        w_out = self.to_out.weight[:, s * dh:e * dh].to(x.dtype)[:, :, None, None]
        return (reduce_model(F.conv2d(out, w_out))
                + channel_view(self.to_out.bias.to(x.dtype), 4))


def _rope_cos_sin(seq_len: int, dim: int, theta: float, dtype=torch.float32, device=None):
    """The rotary tables (seq_len, dim), made in fp32 and cast to ``dtype``."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                                / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    emb = torch.outer(t, inv_freq).repeat(1, 2)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def _apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """DeepSeek-V2's interleaved rope: the channels of each (B, H, S, D)
    tensor are de-interleaved pairwise before the rotation."""

    def de_interleave(t):
        b, h, s, d = t.shape
        return t.reshape(b, h, s, d // 2, 2).transpose(-1, -2).reshape(b, h, s, d)

    q, k = de_interleave(q), de_interleave(k)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


class MLA(nn.Module):
    """Multi-head latent attention on (B, L, hidden) tokens: low-rank q and
    kv projections, each through an RMSNorm over its last axis (kernel K1's
    row path on CUDA tensors), a rope part shared by the heads, softmax
    attention in plain matrix products. Computes in the input's dtype, as
    the JAX module (its Dense layers have no dtype of their own); the norms
    take fp32 statistics."""

    def __init__(self, hidden_size: int, num_heads: int, q_lora_rank: int, kv_lora_rank: int,
                 qk_rope_head_dim: int = 64, qk_nope_head_dim: int = 64,
                 v_head_dim: int = 64, rope_theta: float = 128000.0,
                 attention_bias: bool = False):
        super().__init__()
        self.num_heads, self.kv_lora_rank = num_heads, kv_lora_rank
        self.rope, self.nope, self.v_head_dim = qk_rope_head_dim, qk_nope_head_dim, v_head_dim
        self.rope_theta = rope_theta
        q_head_dim = qk_nope_head_dim + qk_rope_head_dim
        self.q_down_proj = Linear(hidden_size, q_lora_rank, bias=attention_bias)
        self.q_down_norm = RMSNorm(q_lora_rank)
        self.q_up_proj = Linear(q_lora_rank, num_heads * q_head_dim, bias=attention_bias)
        self.kv_down_proj = Linear(hidden_size, kv_lora_rank + qk_rope_head_dim,
                                   bias=attention_bias)
        self.kv_down_norm = RMSNorm(kv_lora_rank)
        self.kv_up_proj = Linear(kv_lora_rank, num_heads * (qk_nope_head_dim + v_head_dim),
                                 bias=attention_bias)
        self.out_proj = Linear(num_heads * v_head_dim, hidden_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        nh = self.num_heads
        q = self.q_up_proj(self.q_down_norm(self.q_down_proj(x)))
        q = q.reshape(b, l, nh, self.nope + self.rope).transpose(1, 2)
        q_nope, q_rope = q.split([self.nope, self.rope], dim=-1)

        ckv, k_rope = self.kv_down_proj(x).split([self.kv_lora_rank, self.rope], dim=-1)
        k_rope = k_rope.reshape(b, l, 1, self.rope).transpose(1, 2)
        kv = self.kv_up_proj(self.kv_down_norm(ckv.contiguous()))  # K1 takes dense rows
        kv = kv.reshape(b, l, nh, self.nope + self.v_head_dim).transpose(1, 2)
        k_nope, v = kv.split([self.nope, self.v_head_dim], dim=-1)

        cos, sin = _rope_cos_sin(l, self.rope, self.rope_theta, x.dtype, x.device)
        q_rope, k_rope = _apply_rope(q_rope, k_rope, cos, sin)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        k_full = torch.cat([k_nope, k_rope.expand(-1, nh, -1, -1)], dim=-1)
        logits = torch.matmul(q_full, k_full.transpose(-1, -2)) / math.sqrt(self.nope + self.rope)
        out = torch.matmul(logits.softmax(dim=-1), v)
        return self.out_proj(out.transpose(1, 2).reshape(b, l, nh * self.v_head_dim))


def generate_mla_config(dim: int, strict: bool = True) -> dict:
    """MLA's widths for a model width ``dim`` (JAX: ``generate_mla_config``;
    reference: models/MLA.py:351-400). ``strict=False`` lifts the
    reference's power-of-two list, for the U-Net's attention sites."""
    if strict and dim not in (16, 32, 64, 128, 256, 512):
        raise ValueError(f"Unsupported dim={dim}")
    num_heads = max(1, dim // 8)
    v_head_dim = dim // num_heads
    return dict(hidden_size=dim, num_heads=num_heads, v_head_dim=v_head_dim,
                qk_rope_head_dim=64, qk_nope_head_dim=v_head_dim,
                q_lora_rank=max(64, dim // 4), kv_lora_rank=max(32, dim // 8),
                rope_theta=128000.0, attention_bias=False)
