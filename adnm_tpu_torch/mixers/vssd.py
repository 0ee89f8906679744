"""VSSD Mamba2 mixer on NCHW tensors (counterpart of
adnm_tpu/mixers/vssd.py::VSSDMixer, the reference's ``Vssd.py``, chosen
with ``mixer_type="vssd"``). Per (B, d_model, H, W) grid:

  1. in_proj -> [z | xBC | dt] over the channels.
  2. One depthwise 3x3 conv over all of xBC, then SiLU; xBC splits into
     x (heads of P channels), B and C, each of two groups of N states.
  3. ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``.
  4. Either the grouped non-causal duality, head i with group i % 2
     (``linear_attn_duality``, the default), or the bimamba halves: heads
     [0, H/2) scan forward with group 0 and heads [H/2, H) scan from the
     last token back with group 1 (kernel K2).
  5. LayerNorm over the channels (eps 1e-5), ``y * z`` (z gets no SiLU
     here, unlike ADN-SSD), out_proj.

Under bf16 compute it follows the JAX module's dtypes: the projection and
the depthwise conv run in bf16, but dt, A and D stay fp32 (JAX casts none
of them), so the duality's products, the LayerNorm and out_proj run in
fp32 and the mixer's output is fp32. The bimamba halves cannot run so in
the JAX package (its chunked scan starts its carry in x's dtype and
``lax.scan`` refuses the fp32 state, ``adnm_tpu/ops/ssd.py:195-197``), and
the port raises there too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import Conv2d, Linear, channel_linear, channel_view
from adnm_tpu_torch.mixers.ssd_mixer import (SCAN_CHUNK, ChannelLayerNorm,
                                             reset_dt_bias_and_a_log_)
from adnm_tpu_torch.ops.ssd import linear_attn_dual_seqminor, ssd_chunked_scan


def check_compute_dtype(linear_attn_duality: bool, dtype: torch.dtype) -> None:
    """Raise for the VSSD bimamba halves in any compute dtype but fp32: the
    JAX package cannot run them so (its chunked scan's carry starts in the
    activations' dtype, and ``lax.scan`` refuses the fp32 state that VSSD's
    fp32 dt, A and D give, ``adnm_tpu/ops/ssd.py:195-197``), and the port
    adds no configuration that the JAX package lacks."""
    if not linear_attn_duality and dtype != torch.float32:
        raise TypeError(f"the VSSD mixer's bimamba scan (linear_attn_duality=False) runs in "
                        f"float32 only, as in the JAX package, whose chunked scan refuses "
                        f"its fp32 state under {dtype} compute; got {dtype}")


class VSSDMixer(nn.Module):
    """(B, d_model, H, W) -> (B, d_model, H, W).

    The JAX module's other settings keep the values every model uses:
    d_conv 3, expand 2, ngroups 2, d_state 16, ssd_positive_dA,
    chunk_size 256, no conv or projection biases. Its ``bimamba`` field is
    never read there and has no counterpart here."""

    D_CONV, EXPAND, NGROUPS, D_STATE = 3, 2, 2, 16

    def __init__(self, d_model: int, headdim: int = 8, linear_attn_duality: bool = True):
        super().__init__()
        d_inner = self.EXPAND * d_model
        nheads = d_inner // headdim
        if d_inner % headdim or nheads % self.NGROUPS:
            raise ValueError(f"d_inner {d_inner} needs an even number of heads of {headdim}")
        self.linear_attn_duality = linear_attn_duality
        self.headdim, self.d_inner, self.nheads = headdim, d_inner, nheads
        self.conv_dim = d_inner + 2 * self.NGROUPS * self.D_STATE
        self.in_proj = Linear(d_model, d_inner + self.conv_dim + nheads, bias=False)
        self.dt_bias = nn.Parameter(torch.zeros(nheads))
        self.A_log = nn.Parameter(torch.zeros(nheads))
        self.D = nn.Parameter(torch.ones(nheads))
        self.conv2d = Conv2d(self.conv_dim, self.conv_dim, self.D_CONV, padding="same",
                             groups=self.conv_dim, bias=False)
        self.norm = ChannelLayerNorm(d_inner)
        self.out_proj = Linear(d_inner, d_model, bias=False)

    def reset_random_(self, gen: torch.Generator):
        reset_dt_bias_and_a_log_(self, gen)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        check_compute_dtype(self.linear_attn_duality, u.dtype)
        b, _, h, w = u.shape
        l = h * w
        d_inner, hh, P = self.d_inner, self.nheads // 2, self.headdim
        g, n = self.NGROUPS, self.D_STATE

        zxbcdt = channel_linear(self.in_proj, u)
        z = zxbcdt[:, :d_inner]
        xBC = F.silu(self.conv2d(zxbcdt[:, d_inner:d_inner + self.conv_dim]))
        dt = F.softplus(zxbcdt[:, d_inner + self.conv_dim:] + channel_view(self.dt_bias, 4))
        dt = dt.reshape(b, self.nheads, l)
        A = -torch.exp(self.A_log)

        x = xBC[:, :d_inner].reshape(b, self.nheads, P, l)
        Bm = xBC[:, d_inner:d_inner + g * n].reshape(b, g, n, l)
        Cm = xBC[:, d_inner + g * n:].reshape(b, g, n, l)
        if self.linear_attn_duality:
            # head i uses group i % 2: heads viewed as (H/2, 2)
            ys = [linear_attn_dual_seqminor(x[:, gi::g], dt[:, gi::g], A[gi::g], Bm[:, gi],
                                            Cm[:, gi], self.D[gi::g]) for gi in range(g)]
            y = torch.stack(ys, dim=2)  # (B, H/2, 2, P, L)
        else:
            # channel slices of xBC, read in place by K2 and its backward
            y1 = ssd_chunked_scan(x[:, :hh], dt[:, :hh], A[:hh], Bm[:, 0], Cm[:, 0],
                                  self.D[:hh], SCAN_CHUNK)
            y2 = ssd_chunked_scan(x[:, hh:], dt[:, hh:], A[hh:], Bm[:, 1], Cm[:, 1],
                                  self.D[hh:], SCAN_CHUNK, reverse=True)
            y = torch.cat([y1, y2], dim=1)
        y = self.norm(y.reshape(b, d_inner, h, w)) * z
        return channel_linear(self.out_proj, y)
