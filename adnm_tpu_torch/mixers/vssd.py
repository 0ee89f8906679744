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

On a mesh's 'model' axis each rank computes its part of the heads (JAX:
``maybe_shard`` of x and dt, adnm_tpu/mixers/vssd.py:64-67), head i still
on group i % 2 in the duality and each half in its direction in the
bimamba form: the duality's heads [2s, 2e) (s and e this rank's part of
the H/2 heads a group holds), the halves' heads [s, e) and [H/2 + s,
H/2 + e). z, B and C are computed whole on every rank, and the heads are
gathered before the LayerNorm over d_inner.

On a band of the frame over the mesh's 'seq' axis its 3x3 ``conv2d``
takes a one-row halo from the neighbouring ranks, the duality sums K^T V
over the ranks and the bimamba halves carry their state from rank to rank
(``ops/ssd.py``), as the ADN-SSD mixer's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import (Conv2d, Linear, channel_linear, channel_view,
                                        conv_rows, rows_of)
from adnm_tpu_torch.mixers.ssd_mixer import (SCAN_CHUNK, ChannelLayerNorm,
                                             reset_dt_bias_and_a_log_)
from adnm_tpu_torch.ops.ssd import linear_attn_dual_seqminor, ssd_chunked_scan
from adnm_tpu_torch.parallel.tensor import gather_model, model_slice


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
        part = model_slice(hh)  # this rank's part of a group's or a half's heads
        s, e = (0, hh) if part is None else (part.start, part.stop)
        heads = [(2 * s, 2 * e)] if self.linear_attn_duality else [(s, e), (hh + s, hh + e)]
        k = 2 * (e - s)  # this rank's heads
        # the rows of in_proj this rank reads: z whole, its heads' x, B and
        # C whole, its heads' dt (at the whole range, all of in_proj in order)
        xbc_rows = [*((a * P, c * P) for a, c in heads), (d_inner, self.conv_dim)]
        dto = d_inner + self.conv_dim
        rows = [(0, d_inner), *((d_inner + a, d_inner + c) for a, c in xbc_rows),
                *((dto + a, dto + c) for a, c in heads)]
        z, xBC, dt = channel_linear(self.in_proj, u, rows).split(
            [d_inner, k * P + 2 * g * n, k], dim=1)
        xBC = F.silu(conv_rows(self.conv2d, xBC, xbc_rows))
        dt = F.softplus(dt + channel_view(rows_of(self.dt_bias, heads), 4))
        dt = dt.reshape(b, k, l)
        A = rows_of(-torch.exp(self.A_log), heads)
        D = rows_of(self.D, heads)

        x = xBC[:, :k * P].reshape(b, k, P, l)
        Bm = xBC[:, k * P:k * P + g * n].reshape(b, g, n, l)
        Cm = xBC[:, k * P + g * n:].reshape(b, g, n, l)
        if self.linear_attn_duality:
            # head i uses group i % 2: heads viewed as (H/2, 2)
            ys = [linear_attn_dual_seqminor(x[:, gi::g], dt[:, gi::g], A[gi::g], Bm[:, gi],
                                            Cm[:, gi], D[gi::g]) for gi in range(g)]
            y = torch.stack(ys, dim=2)  # (B, heads/2, 2, P, L)
            if part is not None:  # every rank's heads, in rank order
                y = gather_model(y, dim=1)
        else:
            # channel slices of xBC, read in place by K2 and its backward
            kh = k // 2
            y1 = ssd_chunked_scan(x[:, :kh], dt[:, :kh], A[:kh], Bm[:, 0], Cm[:, 0], D[:kh],
                                  SCAN_CHUNK)
            y2 = ssd_chunked_scan(x[:, kh:], dt[:, kh:], A[kh:], Bm[:, 1], Cm[:, 1], D[kh:],
                                  SCAN_CHUNK, reverse=True)
            y = torch.stack([y1, y2], dim=1)  # (B, 2, heads/2, P, L): [y1 | y2]
            if part is not None:
                y = gather_model(y, dim=2)
        y = self.norm(y.reshape(b, d_inner, h, w)) * z
        return channel_linear(self.out_proj, y)
