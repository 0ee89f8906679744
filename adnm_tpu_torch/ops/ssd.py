"""State-space duality ops (counterpart of adnm_tpu/ops/ssd.py), in the
port's sequence-minor layout: x (B, H, P, L); dt (B, H, L) already
softplus'd; A, D (H,); B, C (B, N, L) shared by the heads.

* ``linear_attn_dual_seqminor``: the non-causal linear-attention dual,
  the mixers' default path. Two batched matrix products, outside any
  kernel in the JAX package too.
* ``ssd_chunked_scan``: the causal chunked SSD scan of the bimamba path.
  A CPU tensor goes to ``ssd_chunked_scan_reference``; a CUDA tensor goes
  to kernel K2, the hand-written Hopper kernel in ``csrc/ssd_scan.cu``
  (the Pallas ``adnm_tpu/ops/pallas/ssd_scan.py::ssd_chunked_scan_pallas``
  rewritten as a state scan over sub-chunks of ``sub_chunk(L)`` tokens),
  or the call raises. Differentiable through ``torch.autograd``: its
  backward, ``ssd_chunked_scan_backward``, takes
  ``ssd_chunked_scan_backward_reference`` for CPU tensors and K2's backward
  kernel (the same source; the Pallas function's ``custom_vjp``
  backward) for CUDA tensors, or raises.
* ``ScanSegment``: K2's carried form, the scan of one segment of a longer
  sequence in two phases around an exchange of segment states: the
  segment's final state and decay from zero, then its outputs from the
  state entering it. ``ssd_chunked_scan(initial_state=...)`` is both
  phases at once; on a band of a frame split over 'seq' the scan carries
  its state from rank to rank through them, and its gradient through K2's
  carried backward (``SegmentBackward``), both in ``_CarriedScan``.
* ``ssd_naive_scan``: the O(L^2) causal oracle for the tests.
* ``ssd_state_update``: one token of the causal scan as a recurrence, in
  the JAX function's layout; plain PyTorch (no model calls it).

The scan takes ``dA = dt * A`` with A < 0 as it is; only the duality
negates it (``ssd_positive_dA``). Its six inputs (and the backward's
``dy``) share one dtype, float32 or bfloat16, or the call raises a
``TypeError``: as in the Pallas kernel, which reads any dtype and computes
in fp32, bf16 inputs are widened to fp32 inside K2, its backward and
their plain versions, and every output is rounded to the input dtype once,
at the end (dA and dD too, which are fp32 sums until then).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from adnm_tpu_torch.ops._build import load_library
from adnm_tpu_torch.parallel.tensor import (banded, exchange, seq_group, seq_position,
                                            sum_seq)

SOURCES = ("ssd_scan.cu",)
MAX_CHUNK = 256  # the Pallas kernel's contract: chunks of at most 256 tokens
KERNEL_N = 16  # K2's state size (d_state of every mixer)
KERNEL_P = 4  # K2's head width (headdim of every model)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}  # the I/O types K2 takes
# The plain version's intra-chunk (B, H, chunks, Q, Q) decay tensor is
# built a group of chunks at a time, about this many bytes per group.
_INTRA_BYTES = 64 << 20


def linear_attn_dual_seqminor(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    D: torch.Tensor,
) -> torch.Tensor:
    """``y = C^T (B (x * dA)^T) + x * D``. Returns (B, H, P, L), in the
    dtype that JAX's einsums give: bf16 where all inputs are bf16, fp32
    where dt, A and D are fp32 and x, B and C bf16 (the VSSD mixer's). On a
    band of a frame split over 'seq' (``parallel.tensor.banded``) the
    tokens are this rank's part of L, and the (N, H P) product over L is
    summed over the ranks (JAX: XLA's psum over 'seq')."""
    b, h, p, l = x.shape
    # A is negative and every reference mixer keeps ssd_positive_dA=True,
    # so dA = -(dt * A) >= 0.
    dA = -(dt * A[None, :, None])
    v = (x * dA[:, :, None, :]).reshape(b, h * p, l)
    kv = torch.bmm(B.to(v.dtype), v.transpose(1, 2))  # (B, N, H*P)
    if banded():  # L is this rank's band of the tokens: K^T V sums over all of them
        kv = sum_seq(kv)
    y = torch.bmm(kv.transpose(1, 2), C.to(kv.dtype)).reshape(b, h, p, l)
    return y + x * D[None, :, None, None]


def ssd_naive_scan(x, dt, A, B, C, D) -> torch.Tensor:
    """``y_t = sum_{s<=t} exp(sum_{r=s+1..t} dA_r) (C_t . B_s) x_s dt_s + D x_t``
    as one (B, H, L, L) product (JAX: ``ops/ssd.py::ssd_naive_scan``)."""
    l = x.shape[-1]
    cum = torch.cumsum(dt * A[None, :, None], dim=-1)  # (B, H, L)
    seg = cum[:, :, :, None] - cum[:, :, None, :]  # (B, H, T, S)
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
    qk = torch.einsum("bnt,bns->bts", C, B)
    y = torch.einsum("bhts,bhps->bhpt", decay * qk[:, None], x * dt[:, :, None])
    return y + x * D[None, :, None, None]


def ssd_state_update(state, x_t, dt_t, A, B_t, C_t, D):
    """One token of the causal scan as a recurrence (JAX:
    ``ops/ssd.py::ssd_state_update``; the counterpart of mamba_ssm's
    ``selective_state_update``), plain PyTorch: no model calls it, in JAX
    either, so it has no kernel. state (B, H, N, P); x_t (B, H, P); dt_t
    (B, H); A, D (H,); B_t, C_t (B, N). Returns (new_state, y_t) with
    ``new_state = state * exp(dt A) + B_t (x_t dt_t)`` and
    ``y_t = C_t . new_state + D x_t``."""
    decay = torch.exp(dt_t * A)  # (B, H)
    xdt = x_t * dt_t[..., None]  # (B, H, P)
    new_state = state * decay[..., None, None] + torch.einsum("bn,bhp->bhnp", B_t, xdt)
    y = torch.einsum("bn,bhnp->bhp", C_t, new_state) + x_t * D[None, :, None]
    return new_state, y


def _widened(*ts):
    """The tensors in fp32 where they are narrower (bf16 I/O is computed in
    fp32), else as they are."""
    return [t.to(torch.promote_types(t.dtype, torch.float32)) for t in ts]


def _chunk(l: int, chunk_size: int) -> int:
    q = min(chunk_size, l)
    if q <= 0 or l % q:
        raise ValueError(f"sequence length {l} is not a multiple of the chunk {q}")
    return q


def ssd_chunked_scan_reference(x, dt, A, B, C, D, chunk_size: int = 256,
                               initial_state=None, return_final_state: bool = False):
    """Plain PyTorch version of K2, the three phases of the JAX
    ``ssd_chunked_scan`` (``adnm_tpu/ops/ssd.py:146-208``): every chunk's
    end state, the sequential carry of the state over chunks, then every
    chunk's output (intra-chunk masked product + carried state + D skip).
    Computes in fp32 from bf16 inputs, and returns y in x's dtype.

    ``initial_state`` (B, H, N, P), the JAX function's argument, is the
    state entering the first chunk (zero without it). With
    ``return_final_state``, returns (y, the fp32 state after the last
    token (B, H, N, P), the fp32 decay across the scan exp(sum dt A)
    (B, H)): what a later segment of the sequence needs."""
    io = x.dtype
    x, dt, A, B, C, D = _widened(x, dt, A, B, C, D)
    b, h, p, l = x.shape
    n = B.shape[1]
    q = _chunk(l, chunk_size)
    nc = l // q
    cum = (dt * A[None, :, None]).reshape(b, h, nc, q).cumsum(-1)  # (B, H, C, Q)
    xd = (x * dt[:, :, None]).reshape(b, h, p, nc, q)
    Bc, Cc = B.reshape(b, n, nc, q), C.reshape(b, n, nc, q)

    # chunk end states S_c = sum_s exp(cum_end - cum_s) B_s (x_s dt_s)
    w = xd * torch.exp(cum[..., -1:] - cum)[:, :, None]
    states = torch.einsum("bncs,bhpcs->bhcnp", Bc, w)  # (B, H, C, N, P)
    decay = torch.exp(cum[..., -1])  # (B, H, C): the decay across a chunk
    s_in = torch.empty_like(states)  # the state entering each chunk
    s = (torch.zeros_like(states[:, :, 0]) if initial_state is None
         else initial_state.to(states.dtype))
    for c in range(nc):
        s_in[:, :, c] = s
        s = s * decay[:, :, c, None, None] + states[:, :, c]

    # inter-chunk: (C_t . S_in) exp(cum_t)
    y = torch.einsum("bnct,bhcnp->bhpct", Cc, s_in) * torch.exp(cum)[:, :, None]
    # intra-chunk, a group of chunks at a time
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    group = max(1, _INTRA_BYTES // (b * h * q * q * x.element_size()))
    for c0 in range(0, nc, group):
        sl = slice(c0, min(c0 + group, nc))
        cs = cum[:, :, sl]
        seg = (cs[..., :, None] - cs[..., None, :]).masked_fill(~causal, float("-inf"))
        qk = torch.einsum("bnct,bncs->bcts", Cc[:, :, sl], Bc[:, :, sl])
        y[:, :, :, sl] += torch.einsum("bhcts,bhpcs->bhpct", torch.exp(seg) * qk[:, None],
                                       xd[:, :, :, sl])
    y = (y.reshape(b, h, p, l) + x * D[None, :, None, None]).to(io)
    if return_final_state:
        return y, s, torch.exp(cum[..., -1].sum(-1))
    return y


def ssd_chunked_scan_backward_reference(x, dt, A, B, C, D, dy, chunk_size: int = 256,
                                        reverse: bool = False, initial_state=None,
                                        final_state_grad=None):
    """Plain PyTorch version of K2's backward: (dx, ddt, dA, dB, dC, dD) of
    ``ssd_chunked_scan`` for the output gradient ``dy``, without autograd
    (which would keep every chunk group's (B, H, chunks, Q, Q) tensors).

    The carried form (K2's carried backward): with ``initial_state`` S0
    (B, H, N, P), the state entering the first token in scan order, and
    ``final_state_grad`` (B, H, N, P), the adjoint of the state after the
    last (what later segments of the sequence hand back), it is the
    gradient of the full recurrence from S0, and returns a seventh value,
    dS0 (B, H, N, P) in fp32: the gradient of the entering state. Either
    argument turns the carried form on; the one left out is zero. The
    decay's gradient then reads <lambda, S0> through dt and A with no
    separate term, since the carried state and adjoint enter every chunk's
    sums.

    With ``G_t`` the adjoint of the state S_t (N x P), G_t = C_t dy_t^T +
    a_{t+1} G_{t+1}, a_t = exp(dt_t A), and u_t = G_t^T B_t:
    dx_t = dt_t u_t + D dy_t, ddt_t = x_t . u_t + A a_t <G_t, S_{t-1}>,
    dA = sum dt_t a_t <G_t, S_{t-1}>, dD = sum x_t . dy_t, dB_t = sum_h
    G_t x_t dt_t, dC_t = sum_h S_t dy_t. Per chunk, as the forward: the
    intra-chunk pairs as masked (Q, Q) products, the state entering each
    chunk from the left and the adjoint entering it from the right carried
    sequentially over chunks. ``a_t <G_t, S_{t-1}>`` sums the pairs (r, s)
    of output and source tokens with s < t <= r, which per chunk is a
    reverse cumulative sum of each token's row minus column sums over the
    intra-chunk pairs, plus the carried states' terms; every sum stays
    within one chunk. Computes in fp32 from bf16 inputs, and returns every
    gradient in x's dtype."""
    io = x.dtype
    x, dt, A, B, C, D, dy = _widened(x, dt, A, B, C, D, dy)
    carried = initial_state is not None or final_state_grad is not None
    if reverse:
        x, dt, B, C, dy = (t.flip(-1) for t in (x, dt, B, C, dy))
        grads = ssd_chunked_scan_backward_reference(x, dt, A, B, C, D, dy, chunk_size,
                                                    initial_state=initial_state,
                                                    final_state_grad=final_state_grad)
        dx, ddt, dA, dB, dC, dD = (g.to(io) for g in grads[:6])
        return (dx.flip(-1), ddt.flip(-1), dA, dB.flip(-1), dC.flip(-1), dD, *grads[6:])
    b, h, p, l = x.shape
    n = B.shape[1]
    q = _chunk(l, chunk_size)
    nc = l // q
    cum = (dt * A[None, :, None]).reshape(b, h, nc, q).cumsum(-1)  # (B, H, C, Q)
    xd = (x * dt[:, :, None]).reshape(b, h, p, nc, q)
    dyc = dy.reshape(b, h, p, nc, q)
    Bc, Cc = B.reshape(b, n, nc, q), C.reshape(b, n, nc, q)
    end = cum[..., -1:]
    decay = torch.exp(end[..., 0])  # (B, H, C): the decay across a chunk

    # chunk end states from zero, E_c = sum_s exp(cum_end - cum_s) B_s xd_s^T,
    # and adjoints at the chunk start from zero, F_c = sum_r exp(cum_r) C_r dy_r^T
    E = torch.einsum("bncs,bhpcs->bhcnp", Bc, xd * torch.exp(end - cum)[:, :, None])
    F = torch.einsum("bncr,bhpcr->bhcnp", Cc, dyc * torch.exp(cum)[:, :, None])
    s_in, r_in = torch.empty_like(E), torch.empty_like(F)
    s = torch.zeros_like(E[:, :, 0]) if initial_state is None else initial_state.to(E.dtype)
    r = torch.zeros_like(F[:, :, 0]) if final_state_grad is None else final_state_grad.to(F.dtype)
    for c in range(nc):
        s_in[:, :, c] = s
        s = s * decay[:, :, c, None, None] + E[:, :, c]
        k = nc - 1 - c
        r_in[:, :, k] = r  # the adjoint reaching chunk k's last token from later chunks
        r = r * decay[:, :, k, None, None] + F[:, :, k]

    # the carried terms per token
    tail = torch.exp(end - cum)  # (B, H, C, Q): decay from after t to the chunk's end
    u = torch.einsum("bncs,bhcnp->bhpcs", Bc, r_in) * tail[:, :, None]  # R^T B_s
    dB = torch.einsum("bhcnp,bhpcs->bncs", r_in, xd * tail[:, :, None])
    dC = torch.einsum("bhcnp,bhpct->bnct", s_in, dyc * torch.exp(cum)[:, :, None])
    y_in = torch.einsum("bnct,bhcnp->bhpct", Cc, s_in) * torch.exp(cum)[:, :, None]
    after = (y_in * dyc).sum(2)  # pairs (r in the chunk, s before it), per r
    before = (u * xd).sum(2)  # pairs (r after the chunk, s in it), per s
    across = decay * (r_in * s_in).sum((-2, -1))  # pairs (r after, s before)
    # pairs within a chunk, a group of chunks at a time
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    group = max(1, _INTRA_BYTES // (b * h * q * q * x.element_size()))
    dcum = torch.empty_like(cum)
    for c0 in range(0, nc, group):
        sl = slice(c0, min(c0 + group, nc))
        cs = cum[:, :, sl]
        L = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(~causal, float("-inf")))
        qk = torch.einsum("bnct,bncs->bcts", Cc[:, :, sl], Bc[:, :, sl])
        u[:, :, :, sl] += torch.einsum("bhcts,bhpct->bhpcs", L * qk[:, None], dyc[:, :, :, sl])
        # M_ts = L_ts (dy_t . xd_s), W_ts = M_ts (C_t . B_s)
        M = L * torch.einsum("bhpct,bhpcs->bhcts", dyc[:, :, :, sl], xd[:, :, :, sl])
        dB[:, :, sl] += torch.einsum("bhcts,bnct->bncs", M, Cc[:, :, sl])
        dC[:, :, sl] += torch.einsum("bhcts,bncs->bnct", M, Bc[:, :, sl])
        W = M * qk[:, None]
        dcum[:, :, sl] = W.sum(-1) - W.sum(-2)  # as output token minus as source token
    # a_k <G_k, S_{k-1}>: pairs (r, s) with s < k <= r
    rev = torch.flip(torch.cumsum(torch.flip(dcum + after, (-1,)), -1), (-1,))
    ddA = rev + torch.cumsum(before, -1) - before + across[..., None]
    ddA = ddA.reshape(b, h, l)
    u = u.reshape(b, h, p, l)
    dx = u * dt[:, :, None] + dy * D[None, :, None, None]
    ddt = (x * u).sum(2) + ddA * A[None, :, None]
    dA = (ddA * dt).sum((0, 2))
    dD = (x * dy).sum((0, 2, 3))
    grads = tuple(g.to(io) for g in (dx, ddt, dA, dB.reshape(b, n, l), dC.reshape(b, n, l), dD))
    return (*grads, r) if carried else grads  # r: the adjoint handed out of chunk 0, a_0 G_0


def ssd_segment_adjoint_reference(x, dt, A, B, C, D, dy, chunk_size: int = 256,
                                  reverse: bool = False):
    """Plain version of the carried backward's first phase: the adjoint
    leaving the segment's first token in scan order (the gradient of the
    state entering it) when none enters its end, from ``dy`` alone, (B, H,
    N, P) fp32. As ``ssd_chunked_scan_backward_reference``'s carry of the
    adjoint over chunks, from the last chunk to the first."""
    dt, A, C, dy = _widened(dt, A, C, dy)
    if reverse:
        dt, C, dy = (t.flip(-1) for t in (dt, C, dy))
    b, h, p, l = dy.shape
    n = C.shape[1]
    q = _chunk(l, chunk_size)
    nc = l // q
    cum = (dt * A[None, :, None]).reshape(b, h, nc, q).cumsum(-1)  # (B, H, C, Q)
    F = torch.einsum("bncr,bhpcr->bhcnp", C.reshape(b, n, nc, q),
                     dy.reshape(b, h, p, nc, q) * torch.exp(cum)[:, :, None])
    decay = torch.exp(cum[..., -1])
    r = torch.zeros_like(F[:, :, 0])
    for k in range(nc - 1, -1, -1):
        r = r * decay[:, :, k, None, None] + F[:, :, k]
    return r


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("ssd_scan", SOURCES)
    lib.adnm_ssd_chunked_scan.argtypes = [
        *(ctypes.c_void_p,) * 9,  # x, dt, A, B, C, D, y, states, decay
        *(ctypes.c_int64,) * 4,  # batch strides of x, dt, B, C (elements)
        *(ctypes.c_int,) * 6,  # batch, heads, P, N, L, Q
        ctypes.c_int,  # reverse
        ctypes.c_int,  # dtype: 0 float32, 1 bfloat16
        ctypes.c_void_p,  # stream
    ]
    lib.adnm_ssd_chunked_scan.restype = ctypes.c_int
    lib.adnm_ssd_scratch_floats.argtypes = [
        *(ctypes.c_int,) * 3,  # batch, heads, L
        *(ctypes.POINTER(ctypes.c_int64),) * 2,  # states, decays (out)
    ]
    lib.adnm_ssd_scratch_floats.restype = ctypes.c_int
    lib.adnm_ssd_chunked_scan_backward.argtypes = [
        *(ctypes.c_void_p,) * 14,  # x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, scratch
        *(ctypes.c_int64,) * 4,  # batch strides of x, dt, B, C (elements)
        *(ctypes.c_int,) * 6,  # batch, heads, P, N, L, Q
        ctypes.c_int,  # reverse
        ctypes.c_int,  # dtype
        ctypes.c_void_p,  # stream
    ]
    lib.adnm_ssd_chunked_scan_backward.restype = ctypes.c_int
    lib.adnm_ssd_backward_scratch_floats.argtypes = [
        *(ctypes.c_int,) * 3,  # batch, heads, L
        ctypes.POINTER(ctypes.c_int64),  # floats (out)
    ]
    lib.adnm_ssd_backward_scratch_floats.restype = ctypes.c_int
    lib.adnm_ssd_segment_scratch_floats.argtypes = lib.adnm_ssd_scratch_floats.argtypes
    lib.adnm_ssd_segment_scratch_floats.restype = ctypes.c_int
    lib.adnm_ssd_scan_segment_states.argtypes = [
        *(ctypes.c_void_p,) * 10,  # x, dt, A, B, C, D, states, decay, final state, final decay
        *(ctypes.c_int64,) * 4,  # batch strides of x, dt, B, C (elements)
        *(ctypes.c_int,) * 6,  # batch, heads, P, N, L, Q
        ctypes.c_int,  # reverse
        ctypes.c_int,  # dtype
        ctypes.c_void_p,  # stream
    ]
    lib.adnm_ssd_scan_segment_states.restype = ctypes.c_int
    lib.adnm_ssd_scan_carried_outputs.argtypes = [
        *(ctypes.c_void_p,) * 10,  # x, dt, A, B, C, D, y, states, decay, initial state
        *(ctypes.c_int64,) * 4,  # batch strides of x, dt, B, C (elements)
        *(ctypes.c_int,) * 6,  # batch, heads, P, N, L, Q
        ctypes.c_int,  # reverse
        ctypes.c_int,  # dtype
        ctypes.c_void_p,  # stream
    ]
    lib.adnm_ssd_scan_carried_outputs.restype = ctypes.c_int
    lib.adnm_ssd_segment_backward_scratch_floats.argtypes = \
        lib.adnm_ssd_backward_scratch_floats.argtypes
    lib.adnm_ssd_segment_backward_scratch_floats.restype = ctypes.c_int
    lib.adnm_ssd_segment_adjoint.argtypes = [
        *(ctypes.c_void_p,) * 10,  # x, dt, A, B, C, D, dy, scratch, final records, final decays
        *(ctypes.c_int64,) * 4,  # batch strides of x, dt, B, C (elements)
        *(ctypes.c_int,) * 6,  # batch, heads, P, N, L, Q
        ctypes.c_int,  # reverse
        ctypes.c_int,  # dtype
        ctypes.c_void_p,  # stream
    ]
    lib.adnm_ssd_segment_adjoint.restype = ctypes.c_int
    lib.adnm_ssd_segment_backward.argtypes = [
        # x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, dS0, scratch, S0, lambda
        *(ctypes.c_void_p,) * 17,
        *(ctypes.c_int64,) * 4,  # batch strides of x, dt, B, C (elements)
        *(ctypes.c_int,) * 6,  # batch, heads, P, N, L, Q
        ctypes.c_int,  # reverse
        ctypes.c_int,  # dtype
        ctypes.c_void_p,  # stream
    ]
    lib.adnm_ssd_segment_backward.restype = ctypes.c_int
    lib.adnm_ssd_sub_chunk.argtypes = [ctypes.c_int]
    lib.adnm_ssd_sub_chunk.restype = ctypes.c_int
    lib.adnm_ssd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.adnm_ssd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def sub_chunk(l: int) -> int:
    """The tokens a K2 walker scans in a scan over ``l`` tokens (the
    kernel's own choice; the result does not depend on it). Builds the
    kernel."""
    return _library().adnm_ssd_sub_chunk(l)


def _batch_stride(name: str, t: torch.Tensor) -> int:
    """The batch stride of ``t``, whose every sample must be contiguous
    (a slice of a larger NCHW tensor along the channels is)."""
    if t.shape[0] and not t[0].is_contiguous():
        raise ValueError(f"ssd_chunked_scan kernel needs each sample of {name} contiguous")
    return t.stride(0)


def _check(x, dt, A, B, C, D, chunk_size: int, *more) -> int:
    """Validate the shapes and that the inputs (and ``more``) share one
    dtype; the chunk."""
    named = dict(zip(("x", "dt", "A", "B", "C", "D", "dy"), (x, dt, A, B, C, D, *more)))
    if len({t.dtype for t in named.values()}) > 1:
        raise TypeError("ssd_chunked_scan takes one dtype for all its inputs (float32 or "
                        "bfloat16), got " + ", ".join(f"{k} {t.dtype}" for k, t in named.items()))
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, P, L), got {tuple(x.shape)}")
    b, h, p, l = x.shape
    n = B.shape[1]
    if (dt.shape != (b, h, l) or A.shape != (h,) or D.shape != (h,)
            or B.shape != (b, n, l) or C.shape != (b, n, l)):
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
                         f"D {tuple(D.shape)}")
    return _chunk(l, chunk_size)


def _kernel_args(what: str, args: dict, q: int) -> list:
    """Check what K2's kernels take; the batch strides of x, dt, B and C."""
    x, B = args["x"], args["B"]
    for name, t in args.items():
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel takes float32 or bfloat16 tensors, got {x.dtype}")
    if B.shape[1] != KERNEL_N or x.shape[2] != KERNEL_P:
        raise ValueError(f"{what} kernel takes N = {KERNEL_N} and P = {KERNEL_P}, "
                         f"got N = {B.shape[1]}, P = {x.shape[2]}")
    if q > MAX_CHUNK:
        raise ValueError(f"{what} kernel takes chunks of at most {MAX_CHUNK}, got {q}")
    if not (args["A"].is_contiguous() and args["D"].is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous A and D")
    return [_batch_stride(name, args[name]) for name in ("x", "dt", "B", "C")]


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.adnm_ssd_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _scan(x, dt, A, B, C, D, q: int, reverse: bool) -> torch.Tensor:
    """The forward on validated inputs: the plain version for CPU tensors,
    else kernel K2."""
    if x.device.type == "cpu":
        if not reverse:
            return ssd_chunked_scan_reference(x, dt, A, B, C, D, q)
        x, dt, B, C = (t.flip(-1) for t in (x, dt, B, C))
        return ssd_chunked_scan_reference(x, dt, A, B, C, D, q).flip(-1)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked_scan runs on CPU or CUDA tensors, got {x.device}")
    b, h, p, l = x.shape
    n = B.shape[1]
    strides = _kernel_args("ssd_chunked_scan", {"x": x, "dt": dt, "A": A, "B": B, "C": C,
                                                 "D": D}, q)
    lib = _library()
    # Scratch of the carry across tiles, sized by the kernel's sub-chunks;
    # none where the tiles fit one thread cluster.
    n_states, n_decay = ctypes.c_int64(), ctypes.c_int64()
    rc = lib.adnm_ssd_scratch_floats(b, h, l, ctypes.byref(n_states), ctypes.byref(n_decay))
    if rc == 0:
        y = torch.empty((b, h, p, l), dtype=x.dtype, device=x.device)
        states = torch.empty(n_states.value, dtype=torch.float32, device=x.device)
        decay = torch.empty(n_decay.value, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.adnm_ssd_chunked_scan(
                x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
                D.data_ptr(), y.data_ptr(), states.data_ptr(), decay.data_ptr(),
                *strides, b, h, p, n, l, q, int(reverse), _DTYPE_CODES[x.dtype], stream)
    _raise_on(lib, rc, "ssd_chunked_scan")
    ssd_chunked_scan.launches += 1
    return y


def _flipped(x, dt, B, C, reverse: bool):
    """The inputs along L in scan order: reversed for a reverse scan."""
    return (x, dt, B, C) if not reverse else tuple(t.flip(-1) for t in (x, dt, B, C))


class ScanSegment:
    """A scan over one segment of a longer sequence, in two phases around
    the exchange of segment states (K2's carried form): made, it has run
    the segment's states from zero and holds ``state``, the fp32 state
    after its last token in scan order (B, H, N, P), and ``decay``, the
    fp32 decay across it, exp(sum dt A) (B, H); ``outputs(initial_state)``
    then gives y with ``initial_state`` (B, H, N, P) entering the
    segment's first token. On the card the first phase is K2's state
    launch and its carry (``adnm_ssd_scan_segment_states``), the second its
    output launch, whose carry-in adds the entering state's decayed part to
    each sub-chunk's state (``adnm_ssd_scan_carried_outputs``); on the CPU
    both are the plain version. Not differentiable itself (an input that
    asks for a gradient raises): ``ssd_chunked_scan`` on a band carries the
    gradient across the ranks (``_CarriedScan``, ``SegmentBackward``)."""

    def __init__(self, x, dt, A, B, C, D, chunk_size: int = 256, reverse: bool = False):
        self.q = _check(x, dt, A, B, C, D, chunk_size)
        if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
            raise RuntimeError("ScanSegment gives no gradient: a differentiable scan on a "
                               "band over 'seq' is ssd_chunked_scan inside split_rows")
        self.inputs, self.reverse = (x, dt, A, B, C, D), reverse
        if x.device.type == "cpu":
            xs, dts, Bs, Cs = _flipped(x, dt, B, C, reverse)
            _, self.state, self.decay = ssd_chunked_scan_reference(
                xs, dts, A, Bs, Cs, D, self.q, return_final_state=True)
            return
        if x.device.type != "cuda":
            raise ValueError(f"ssd_chunked_scan runs on CPU or CUDA tensors, got {x.device}")
        b, h, p, l = x.shape
        n = B.shape[1]
        self.strides = _kernel_args("ssd_chunked_scan", {"x": x, "dt": dt, "A": A, "B": B,
                                                          "C": C, "D": D}, self.q)
        lib = _library()
        n_states, n_decay = ctypes.c_int64(), ctypes.c_int64()
        rc = lib.adnm_ssd_segment_scratch_floats(b, h, l, ctypes.byref(n_states),
                                                 ctypes.byref(n_decay))
        if rc == 0:
            dev = x.device
            self.scratch = (torch.empty(n_states.value, dtype=torch.float32, device=dev),
                            torch.empty(n_decay.value, dtype=torch.float32, device=dev))
            state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
            self.decay = torch.empty((b, h), dtype=torch.float32, device=dev)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.adnm_ssd_scan_segment_states(
                    *(t.data_ptr() for t in (x, dt, A, B, C, D, *self.scratch, state,
                                             self.decay)),
                    *self.strides, b, h, p, n, l, self.q, int(reverse), _DTYPE_CODES[x.dtype],
                    stream)
            self.state = state.transpose(-1, -2)  # the kernel's (P, N) records
        _raise_on(lib, rc, "ssd_chunked_scan")

    def outputs(self, initial_state: torch.Tensor) -> torch.Tensor:
        """y of the segment (x's shape and dtype) with ``initial_state``
        (B, H, N, P) entering it."""
        x, dt, A, B, C, D = self.inputs
        b, h, p, l = x.shape
        n = B.shape[1]
        if initial_state.shape != (b, h, n, p):
            raise ValueError(f"initial_state {tuple(initial_state.shape)} does not fit "
                             f"(B, H, N, P) = {(b, h, n, p)}")
        if x.device.type == "cpu":
            xs, dts, Bs, Cs = _flipped(x, dt, B, C, self.reverse)
            y = ssd_chunked_scan_reference(xs, dts, A, Bs, Cs, D, self.q,
                                           initial_state=initial_state)
            return y.flip(-1) if self.reverse else y
        init = initial_state.to(x.device, torch.float32).transpose(-1, -2).contiguous()
        y = torch.empty((b, h, p, l), dtype=x.dtype, device=x.device)
        lib = _library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.adnm_ssd_scan_carried_outputs(
                *(t.data_ptr() for t in (x, dt, A, B, C, D, y, *self.scratch, init)),
                *self.strides, b, h, p, n, l, self.q, int(self.reverse),
                _DTYPE_CODES[x.dtype], stream)
        _raise_on(lib, rc, "ssd_chunked_scan")
        ssd_chunked_scan.launches += 1
        return y


def compose_states(parts: list, reverse: bool, position: int) -> torch.Tensor:
    """The state entering segment ``position`` of a sequence cut into
    ``parts`` (each segment's (state, decay) from zero, in sequence
    order), in the scan's direction: from segment 0 up, or with
    ``reverse`` from the last segment down. S = S * decay + state, fp32."""
    order = range(position) if not reverse else range(len(parts) - 1, position, -1)
    state = torch.zeros_like(parts[position][0], dtype=torch.float32)
    for i in order:
        e, g = parts[i]
        state = state * g[..., None, None] + e
    return state


class SegmentBackward:
    """K2's carried backward: the gradient of a scan over one segment of a
    longer sequence, in two phases around the exchange of the segments'
    adjoints. Made, it has run the first phase and holds ``adjoint``, the
    fp32 adjoint leaving the segment's first token in scan order from
    ``dy`` alone (B, H, N, P): what the segments before it in the scan need.
    ``grads(initial_state, final_state_grad)`` then gives (dx, ddt, dA, dB,
    dC, dD, dS0) of the segment with the state S0 entering it and the
    adjoint lambda entering its end. On the card the first phase is K2's
    backward summary of every tile and a carry that leaves each tile's
    decay from the segment's ends in place (``adnm_ssd_segment_adjoint``),
    the second its gradient walks from S0 and lambda decayed to each tile,
    then the sums (``adnm_ssd_segment_backward``); on the CPU both are the
    plain versions. From S0 = lambda = 0 the gradients are K2's backward's
    bits."""

    launches = 0  # the second phase's launches since the last reset

    def __init__(self, x, dt, A, B, C, D, dy, chunk_size: int = 256, reverse: bool = False):
        self.q = _check(x, dt, A, B, C, D, chunk_size, dy)
        if dy.shape != x.shape:
            raise ValueError(f"dy {tuple(dy.shape)} does not fit x {tuple(x.shape)}")
        dy = dy.contiguous()
        self.inputs, self.reverse = (x, dt, A, B, C, D, dy), reverse
        if x.device.type == "cpu":
            self.adjoint = ssd_segment_adjoint_reference(x, dt, A, B, C, D, dy, self.q, reverse)
            return
        if x.device.type != "cuda":
            raise ValueError(f"ssd_chunked_scan_backward runs on CPU or CUDA tensors, "
                             f"got {x.device}")
        b, h, p, l = x.shape
        n = B.shape[1]
        self.strides = _kernel_args("ssd_chunked_scan_backward",
                                    {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D, "dy": dy},
                                    self.q)
        lib = _library()
        n_scratch = ctypes.c_int64()
        rc = lib.adnm_ssd_segment_backward_scratch_floats(b, h, l, ctypes.byref(n_scratch))
        if rc == 0:
            dev = x.device
            self.scratch = torch.empty(n_scratch.value, dtype=torch.float32, device=dev)
            records = torch.empty((2, b, h, p, n), dtype=torch.float32, device=dev)
            decays = torch.empty((2, b, h), dtype=torch.float32, device=dev)
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.adnm_ssd_segment_adjoint(
                    *(t.data_ptr() for t in (x, dt, A, B, C, D, dy, self.scratch, records,
                                             decays)),
                    *self.strides, b, h, p, n, l, self.q, int(reverse), _DTYPE_CODES[x.dtype],
                    stream)
            self.adjoint = records[1].transpose(-1, -2)  # the kernel's (P, N) records
        _raise_on(lib, rc, "ssd_chunked_scan_backward")

    def grads(self, initial_state: torch.Tensor, final_state_grad: torch.Tensor):
        """(dx, ddt, dA, dB, dC, dD) in x's dtype and dS0 (B, H, N, P) fp32,
        with ``initial_state`` entering the segment and ``final_state_grad``
        entering its end, each (B, H, N, P)."""
        x, dt, A, B, C, D, dy = self.inputs
        b, h, p, l = x.shape
        n = B.shape[1]
        for name, t in (("initial_state", initial_state), ("final_state_grad", final_state_grad)):
            if t.shape != (b, h, n, p):
                raise ValueError(f"{name} {tuple(t.shape)} does not fit (B, H, N, P) = "
                                 f"{(b, h, n, p)}")
        if x.device.type == "cpu":
            return ssd_chunked_scan_backward_reference(
                x, dt, A, B, C, D, dy, self.q, self.reverse, initial_state=initial_state,
                final_state_grad=final_state_grad)
        dev, io = x.device, x.dtype
        s0, lam = (t.to(dev, torch.float32).transpose(-1, -2).contiguous()
                   for t in (initial_state, final_state_grad))
        dx = torch.empty((b, h, p, l), dtype=io, device=dev)
        ddt = torch.empty((b, h, l), dtype=io, device=dev)
        dB = torch.empty((b, n, l), dtype=io, device=dev)
        dC = torch.empty((b, n, l), dtype=io, device=dev)
        dA = torch.empty(h, dtype=io, device=dev)
        dD = torch.empty(h, dtype=io, device=dev)
        ds0 = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
        lib = _library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.adnm_ssd_segment_backward(
                *(t.data_ptr() for t in (x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, ds0,
                                         self.scratch, s0, lam)),
                *self.strides, b, h, p, n, l, self.q, int(self.reverse), _DTYPE_CODES[io],
                stream)
        _raise_on(lib, rc, "ssd_chunked_scan_backward")
        SegmentBackward.launches += 1
        return dx, ddt, dA, dB, dC, dD, ds0.transpose(-1, -2)


def _exchange(state: torch.Tensor, decay: torch.Tensor, group, axis: str) -> list:
    """Every 'seq' rank's (state (B, H, N, P), decay (B, H)) in 'seq' order:
    one all-gather of the two packed (a few KiB)."""
    b, h, n, p = state.shape
    packed = torch.cat([state.reshape(b, h, -1), decay[..., None].to(state.dtype)], dim=-1)
    return [(t[..., :-1].reshape(b, h, n, p), t[..., -1])
            for t in exchange(packed, group, axis)]


class _CarriedScan(torch.autograd.Function):
    """The scan of a sequence split in bands over 'seq', each rank holding
    its segment of L in row order. Forward: the segment's states from zero
    (``ScanSegment``), the ranks' (state, decay) all-gathered, the state
    entering this rank's segment composed from the ranks before it in the
    scan's direction, then the segment's outputs from it. Backward, its
    mirror (``SegmentBackward``): the adjoint leaving the segment's start
    from dy alone, the ranks' (adjoint, decay) all-gathered, the adjoint
    entering this segment's end composed from the ranks after it in the
    scan's direction, then the gradients from the entering state and
    adjoint. No rank holds the whole sequence, and none waits on its
    neighbour's backward in turn."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, q, reverse, group, position):
        seg = ScanSegment(x, dt, A, B, C, D, q, reverse)
        s0 = compose_states(_exchange(seg.state, seg.decay, group, "seq"), reverse, position)
        ctx.save_for_backward(x, dt, A, B, C, D, s0, seg.decay)
        ctx.q, ctx.reverse, ctx.group, ctx.position = q, reverse, group, position
        return seg.outputs(s0)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, D, s0, decay = ctx.saved_tensors
        bwd = SegmentBackward(x, dt, A, B, C, D, dy, ctx.q, ctx.reverse)
        parts = _exchange(bwd.adjoint, decay, ctx.group, "seq_backward")
        lam = compose_states(parts, not ctx.reverse, ctx.position)
        return (*bwd.grads(s0, lam)[:6], None, None, None, None)


class _Scan(torch.autograd.Function):
    """The scan with its gradient: K2 and K2's backward kernel on the card,
    their plain versions on the CPU. Saves the inputs; the backward
    recomputes the states it needs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, q, reverse):
        ctx.save_for_backward(x, dt, A, B, C, D)
        ctx.q, ctx.reverse = q, reverse
        return _scan(x, dt, A, B, C, D, q, reverse)

    @staticmethod
    def backward(ctx, dy):
        grads = ssd_chunked_scan_backward(*ctx.saved_tensors, dy, ctx.q, ctx.reverse)
        return (*grads, None, None)


def ssd_chunked_scan(x, dt, A, B, C, D, chunk_size: int = 256,
                     reverse: bool = False) -> torch.Tensor:
    """Causal chunked SSD scan over L; with ``reverse`` the scan runs from
    the last token to the first, ``flip(scan(flip(x, dt, B, C)))`` along L
    (the bimamba mixers' second path). Differentiable in all six inputs.

    On a band of a frame split over 'seq' (``parallel.tensor.banded``) L is
    this rank's segment of the tokens, and the state is carried from rank
    to rank (``_CarriedScan``). A scan from a given entering state (the
    JAX function's ``initial_state``) is ``ScanSegment(...).outputs``."""
    q = _check(x, dt, A, B, C, D, chunk_size)
    if banded():
        return _CarriedScan.apply(x, dt, A, B, C, D, q, reverse, seq_group(), seq_position())
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, A, B, C, D)):
        return _Scan.apply(x, dt, A, B, C, D, q, reverse)
    return _scan(x, dt, A, B, C, D, q, reverse)


ssd_chunked_scan.launches = 0  # kernel launches since the last reset (set to 0 to reset)


def ssd_chunked_scan_backward(x, dt, A, B, C, D, dy, chunk_size: int = 256,
                              reverse: bool = False):
    """(dx, ddt, dA, dB, dC, dD) of ``ssd_chunked_scan`` for the output
    gradient ``dy``: the plain version for CPU tensors, else K2's backward
    kernel (csrc/ssd_scan.cu), which raises on what it does not take."""
    q = _check(x, dt, A, B, C, D, chunk_size, dy)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ssd_chunked_scan_backward_reference(x, dt, A, B, C, D, dy, q, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked_scan_backward runs on CPU or CUDA tensors, "
                         f"got {x.device}")
    b, h, p, l = x.shape
    n = B.shape[1]
    dy = dy.contiguous()
    strides = _kernel_args("ssd_chunked_scan_backward",
                           {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D, "dy": dy}, q)
    lib = _library()
    n_scratch = ctypes.c_int64()
    rc = lib.adnm_ssd_backward_scratch_floats(b, h, l, ctypes.byref(n_scratch))
    if rc == 0:
        dev, io = x.device, x.dtype
        dx = torch.empty((b, h, p, l), dtype=io, device=dev)
        ddt = torch.empty((b, h, l), dtype=io, device=dev)
        dB = torch.empty((b, n, l), dtype=io, device=dev)
        dC = torch.empty((b, n, l), dtype=io, device=dev)
        dA = torch.empty(h, dtype=io, device=dev)
        dD = torch.empty(h, dtype=io, device=dev)
        scratch = torch.empty(n_scratch.value, dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.adnm_ssd_chunked_scan_backward(
                *(t.data_ptr() for t in (x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD,
                                         scratch)),
                *strides, b, h, p, n, l, q, int(reverse), _DTYPE_CODES[io], stream)
    _raise_on(lib, rc, "ssd_chunked_scan_backward")
    ssd_chunked_scan_backward.launches += 1
    return dx, ddt, dA, dB, dC, dD


ssd_chunked_scan_backward.launches = 0  # kernel launches since the last reset
