"""ADN-SSD Mamba2 mixer on NCHW tensors
(counterpart of adnm_tpu/mixers/ssd_mixer.py::ADNSSDMixer).

This is the JAX module's channel-major math (``_apply_channel_major``),
which is the port's only layout. Per (B, d_model, H, W) grid:

  1. in_proj -> [z | xBC | dt] over the channels.
  2. xBC splits into two contiguous halves. Path 1: depthwise 3x3 conv +
     SiLU. Path 2: four sub-chunks (x a/b, BC a/b), each through two
     asymmetric depthwise convs (3x1 then 1x3, or the reverse) + SiLU.
  3. ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, both split into
     head halves per path; z gets its own depthwise 3x3 + SiLU.
  4. Each path runs the non-causal duality (``linear_attn_duality``, the
     default) or the bimamba causal chunked scan (kernel K2, chunks of
     ``SCAN_CHUNK`` tokens): path 1 forward, path 2 from the last token
     back.
  5. The two paths merge into the reference's channel order by one static
     gather, then a LayerNorm over the channels, then
     ``[alpha1 * y | alpha1 * z]`` (alpha1 used twice; alpha2 exists in
     the JAX tree and is never read) and out_proj.

Under bf16 compute everything runs in bf16 as in JAX: the projections and
depthwise convs cast their weights, ``softplus(dt + dt_bias)`` is computed
in fp32 and then cast, A, D and alpha1 are cast, the LayerNorm takes fp32
statistics, the duality's products are bf16 ``bmm``, and K2 takes its six
inputs in bf16.

On a mesh's 'model' axis (``parallel/tensor.py``) each rank computes its
part of the scan heads of both paths (JAX: ``maybe_shard`` of the heads,
adnm_tpu/mixers/ssd_mixer.py:321-332,450-451): its in_proj rows of x1, x2
and dt, their depthwise convs, A and D, and the duality or K2 over them;
z, B and C, which every head reads or which follow the merge, are computed
whole on every rank. The heads are gathered before the merge, the
LayerNorm, the gate and out_proj, which every rank then computes whole: no
collective until the channel merge, as in JAX.

On a band of the frame over the mesh's 'seq' axis (the refiner's Blocks,
``parallel.tensor.banded``) L is this rank's segment of the tokens: every
depthwise conv with a vertical extent (``conv2d``, ``conv2d_z`` and the
(3, 1) halves) takes a one-row halo from the neighbouring ranks
(``core/layers.py::conv2d``), the (1, 3) halves, the projections and the
LayerNorm are per token, the duality sums K^T V over the ranks and the
bimamba scans carry their state from rank to rank (``ops/ssd.py``): path 1
from the first band down, path 2 from the last band up. With 'model' the
heads split within the band as above.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from adnm_tpu_torch.core.layers import (Conv2d, Linear, channel_linear, channel_view,
                                        conv_rows, gate_cast, rows_of, scalar_param)
from adnm_tpu_torch.ops.ssd import linear_attn_dual_seqminor, ssd_chunked_scan
from adnm_tpu_torch.parallel.tensor import gather_model, model_slice

SCAN_CHUNK = 256  # the chunked scan's chunk, as every model of the reference sets it


def _depthwise(c: int, kernel) -> Conv2d:
    return Conv2d(c, c, kernel, padding="same", groups=c, bias=False)


def merge_index(d_inner: int, headdim: int) -> list:
    """Output channel j of the merged paths as an index into
    ``cat([y1, y2])``: even j is y1[j // 2]; odd j is the reference's path-2
    channel m = j // 2, which the [a, a, b, b] head assembly holds at
    head k = m // P, slot (m % P) % 2 * P/2 + (m % P) // 2."""
    d2, p = d_inner // 2, headdim
    idx = []
    for j in range(d_inner):
        if j % 2 == 0:
            idx.append(j // 2)
        else:
            k_head, r = divmod(j // 2, p)
            idx.append(d2 + k_head * p + (r % 2) * (p // 2) + r // 2)
    return idx


def reset_dt_bias_and_a_log_(mixer: nn.Module, gen: torch.Generator):
    """The JAX inits of a mixer's dt_bias (log-uniform dt in [1e-3, 0.1],
    floored at 1e-4, stored as inverse softplus) and A_log (log U(1, 16))."""
    h = mixer.A_log.shape[0]
    u = torch.rand(h, generator=gen)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3)).clamp(min=1e-4)
    mixer.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
    mixer.A_log.copy_(torch.log(torch.empty(h).uniform_(1.0, 16.0, generator=gen)))


class ChannelLayerNorm(nn.Module):
    """LayerNorm over axis 1 with ``scale`` and ``bias`` (flax's names), eps 1e-5."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var, mu = torch.var_mean(xf, dim=1, keepdim=True, correction=0)
        out = ((xf - mu) * torch.rsqrt(var + self.eps) * channel_view(self.scale, x.dim())
               + channel_view(self.bias, x.dim()))
        return out.to(x.dtype)


class ADNSSDMixer(nn.Module):
    """(B, d_model, H, W) -> (B, d_model, H, W).

    The JAX module's other settings keep the values every model uses:
    d_conv 3, expand 2, ngroups 2, d_state 16, ssd_positive_dA, bimamba,
    chunk_size 256, no conv or projection biases."""

    D_CONV, EXPAND, NGROUPS, D_STATE = 3, 2, 2, 16

    def __init__(self, d_model: int, headdim: int = 8, linear_attn_duality: bool = True):
        super().__init__()
        self.linear_attn_duality = linear_attn_duality
        d_inner = self.EXPAND * d_model
        nheads = d_inner // headdim
        if d_inner % headdim or nheads % 2:
            raise ValueError(f"d_inner {d_inner} needs an even number of heads of {headdim}")
        gN = self.NGROUPS * self.D_STATE
        conv_dim = d_inner + 2 * gN
        self.headdim = headdim
        self.d_inner, self.gN, self.nheads, self.conv_dim = d_inner, gN, nheads, conv_dim
        qx, qbc = d_inner // 4, gN // 2

        self.in_proj = Linear(d_model, 2 * d_inner + 2 * gN + nheads, bias=False)
        self.dt_bias = nn.Parameter(torch.zeros(nheads))
        self.A_log = nn.Parameter(torch.zeros(nheads))
        self.D = nn.Parameter(torch.ones(nheads))
        self.conv2d = _depthwise(conv_dim // 2, self.D_CONV)
        for name, c, k1, k2 in (
            ("conv_x1", qx, (3, 1), (1, 3)),
            ("conv_x2", qx, (1, 3), (3, 1)),
            ("conv_bc1", qbc, (1, 3), (3, 1)),
            ("conv_bc2", qbc, (3, 1), (1, 3)),
        ):
            self.add_module(f"{name}_a", _depthwise(c, k1))
            self.add_module(f"{name}_b", _depthwise(c, k2))
        self.conv2d_z = _depthwise(d_inner, self.D_CONV)
        self.norm = ChannelLayerNorm(d_inner)
        self.alpha1 = scalar_param(1.0)
        self.out_proj = Linear(2 * d_inner, d_model, bias=False)
        self.register_buffer("merge_index", torch.tensor(merge_index(d_inner, headdim)),
                             persistent=False)

    def reset_random_(self, gen: torch.Generator):
        reset_dt_bias_and_a_log_(self, gen)

    def _sep(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return F.silu(getattr(self, f"{name}_b")(getattr(self, f"{name}_a")(x)))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        b, d, h, w = u.shape
        l = h * w
        d_inner, gN, P = self.d_inner, self.gN, self.headdim
        hh = self.nheads // 2
        half, qx, qbc = self.conv_dim // 2, d_inner // 4, gN // 2
        heads = model_slice(hh)  # this rank's heads of each path on the 'model' axis
        s, e = (0, hh) if heads is None else (heads.start, heads.stop)
        n = e - s
        # The rows of in_proj this rank reads: z whole; of conv2d's channels
        # x1's heads, B1 and C1; of each path-2 x quarter's convs the
        # channels [s P/2, e P/2), since path 2's head k holds x2a's and
        # x2b's channels [k P/2, (k + 1) P/2) (the [a, a, b, b] assembly
        # below); B2 and C2 whole; dt of the heads of both paths. At the
        # whole range of heads they are all of in_proj, in order.
        xo, dto = d_inner, d_inner + self.conv_dim  # offsets of xBC and dt in in_proj
        x1_rows = [(s * P, e * P), (d_inner // 2, half)]
        x2_rows = [(s * P // 2, e * P // 2)]
        dt_rows = [(s, e), (hh + s, hh + e)]
        rows = [(0, d_inner), *((xo + a, xo + c) for a, c in x1_rows),
                *((xo + half + q * qx + a, xo + half + q * qx + c)
                  for q in range(2) for a, c in x2_rows),
                (xo + half + 2 * qx, dto), *((dto + a, dto + c) for a, c in dt_rows)]
        z, xBC1, x2a, x2b, bc2, dt = channel_linear(self.in_proj, u, rows).split(
            [d_inner, n * P + gN, n * P // 2, n * P // 2, gN, 2 * n], dim=1)
        dt = F.softplus(dt + channel_view(rows_of(self.dt_bias, dt_rows), 4))
        dt = dt.to(u.dtype).reshape(b, 2 * n, l)
        A = rows_of((-torch.exp(self.A_log)).to(u.dtype), dt_rows)
        D = rows_of(self.D.to(u.dtype), dt_rows)

        xBC1 = F.silu(conv_rows(self.conv2d, xBC1, x1_rows))
        x2a = F.silu(conv_rows(self.conv_x1_b, conv_rows(self.conv_x1_a, x2a, x2_rows), x2_rows))
        x2b = F.silu(conv_rows(self.conv_x2_b, conv_rows(self.conv_x2_a, x2b, x2_rows), x2_rows))
        bc2a = self._sep(bc2[:, :qbc], "conv_bc1")
        bc2b = self._sep(bc2[:, qbc:], "conv_bc2")

        x1 = xBC1[:, :n * P].reshape(b, n, P, l)
        B1 = xBC1[:, n * P:n * P + gN // 2].reshape(b, -1, l)
        C1 = xBC1[:, n * P + gN // 2:].reshape(b, -1, l)
        # Path 2 heads in [a, a, b, b] order, where the JAX token-minor path
        # interleaves them [a, b, a, b]. Exact for both scans: inside a
        # head every channel p is mixed over L on its own, with the head's
        # dt and A and the shared B and C, so any order of the channels of
        # a head gives the same outputs in that order, and the merge
        # gather restores the reference's. B and C share one permutation
        # of the state axis, which every product contracts (C_t . B_s, and
        # C_t . S for the state carried between chunks) and so never sees.
        x2 = torch.cat([x2a.reshape(b, n, P // 2, l), x2b.reshape(b, n, P // 2, l)], dim=2)
        B2 = torch.cat([bc2a[:, :qbc // 2], bc2b[:, :qbc // 2]], dim=1).reshape(b, -1, l)
        C2 = torch.cat([bc2a[:, qbc // 2:], bc2b[:, qbc // 2:]], dim=1).reshape(b, -1, l)
        z = F.silu(self.conv2d_z(z))

        if self.linear_attn_duality:
            y1 = linear_attn_dual_seqminor(x1, dt[:, :n], A[:n], B1, C1, D[:n])
            y2 = linear_attn_dual_seqminor(x2, dt[:, n:], A[n:], B2, C2, D[n:])
        else:
            # K2 reads these channel slices in place; its backward's dx, ddt,
            # dB and dC flow back through the slices and cats by autograd.
            y1 = ssd_chunked_scan(x1, dt[:, :n], A[:n], B1, C1, D[:n], SCAN_CHUNK)
            y2 = ssd_chunked_scan(x2, dt[:, n:], A[n:], B2, C2, D[n:], SCAN_CHUNK,
                                  reverse=True)
        y = torch.stack([y1, y2], dim=1)  # (B, 2, heads, P, L): [y1 | y2]
        if heads is not None:  # every rank's heads, in rank order
            y = gather_model(y, dim=2)
        y = self.norm(y.reshape(b, d_inner, l).index_select(1, self.merge_index))

        a1 = gate_cast(y, self.alpha1)
        y = torch.cat([a1 * y, a1 * z.reshape(b, d_inner, l).to(y.dtype)], dim=1)
        return channel_linear(self.out_proj, y.reshape(b, 2 * d_inner, h, w))
