"""Kernels K1 (RMS norm), K3 (gated RMS norm) and K2 (chunked SSD scan),
forward and backward, in fp32 and bf16, of the PyTorch port on an NVIDIA
card (K1 also at MLA's rows), a bimamba training step through K2's two
kernels, the evaluator on the card against the CPU, the entry points' fp32
without TF32, the bits of two forwards and of two training steps, and the
baselines (TransUnet and SwinUnet among them) and the MLA model on the
card against the CPU.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports no JAX; ``tests/conftest.py`` does, so on a machine with the
card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adnm_tpu_torch.device import resolve_device, tf32_enabled
from adnm_tpu_torch.metrics.evaluator import SimplifiedEvaluator
from adnm_tpu_torch.ops import ssd
from adnm_tpu_torch.ops.rms_norm import (
    gated_rms_norm,
    gated_rms_norm_backward,
    gated_rms_norm_backward_reference,
    gated_rms_norm_reference,
    rms_norm,
    rms_norm_backward,
    rms_norm_backward_reference,
    rms_norm_reference,
)
from chip_smoke import (
    FORWARD_ATOL,
    K1_MLA_PER_FORWARD,
    K1_MLA_ROWS,
    MLA,
    REFINER_K1,
    baseline_trainer,
    channel_slices,
    exact_zero_gradient,
    k2_grad_terms,
    make_trainer,
    train_batch,
)

# The main path's shapes: refiner (B, 32, 256, 256), every Block norm at
# 32^2 ... 8^2, and the Pallas contract's (rows, d) on the last axis; then
# ones that reach each branch of the kernels' split: C not a multiple of
# the cluster size, H*W below the narrowest 16-byte tile, H*W not a
# multiple of 4 (the scalar variant), batch 4 at 8^2, a channel axis too
# wide for registers (the forward's chunks), d not a multiple of 32 (a
# warp per row), and rows of packs that leave lanes of a row idle (d = 20:
# 5 fp32 packs, or 20 bf16 values, one a thread) or of single values (d = 30).
CARD_CASES = [((1, 32, 256, 256), 1), ((4, 32, 256, 256), 1), ((1, 128, 32, 32), 1),
              ((1, 256, 16, 16), 1), ((1, 512, 8, 8), 1), ((1, 1024, 8, 8), 1),
              ((1, 1024, 16, 16), 1), ((1, 512, 32, 32), 1), ((4096, 32), -1),
              ((1, 1000, 8, 8), 1), ((2, 64, 3, 3), 1), ((3, 33, 7, 5), 1), ((4, 1024, 8, 8), 1),
              ((5, 1000), -1), ((300, 20), -1), ((7, 30), -1)]
# Forward only: beyond the backward's MAX_BACKWARD_C.
FORWARD_CASES = [((1, 20000, 2, 2), 1)]


def misaligned(shape, dtype, gen, device):
    """A contiguous tensor of ``shape`` whose storage starts one element
    past a 16-byte boundary."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.randn(n + 1, generator=gen, device=device).to(dtype)
    return flat[1:].view(shape)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return resolve_device("cuda")  # fp32 without TF32, as the entry points run


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_the_card(card, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    cases = [(torch.randn(shape, generator=gen, device=card).to(dtype), axis)
             for shape, axis in CARD_CASES + FORWARD_CASES]
    cases.append((misaligned((1, 128, 32, 32), dtype, gen, card), 1))
    for x, axis in cases:
        c = x.shape[axis]
        w = torch.rand(c, generator=gen, device=card) + 0.5
        before = rms_norm.launches
        got = rms_norm(x, w, 1e-6, axis)
        torch.cuda.synchronize()
        assert rms_norm.launches == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        want = rms_norm_reference(x, w, 1e-6, axis)
        # fp32: a few ulp; bf16: one bf16 rounding step of the output.
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 1e-5)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{tuple(x.shape)}: {m}")


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take(card):
    """No silent fallback to the plain version on a CUDA tensor."""
    x = torch.randn(2, 8, 4, 4, device=card)
    w = torch.ones(8, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rms_norm(x.half(), w, 1e-6, 1)
    with pytest.raises(TypeError, match="float32 weight"):
        rms_norm(x, w.double(), 1e-6, 1)
    with pytest.raises(ValueError, match="contiguous"):
        rms_norm(x.transpose(2, 3), w, 1e-6, 1)
    with pytest.raises(ValueError, match="a tensor on cpu"):
        rms_norm(x, w.cpu(), 1e-6, 1)
    with pytest.raises(ValueError, match="contiguous"):
        rms_norm_backward(x, w, x.transpose(2, 3), 1e-6, 1)
    with pytest.raises(TypeError, match="one dtype"):
        rms_norm_backward(x, w, x.bfloat16(), 1e-6, 1)
    with pytest.raises(ValueError, match="at most 1536"):
        wide = torch.ones(2, 2048, device=card)
        rms_norm_backward(wide, torch.ones(2048, device=card), wide)
    with pytest.raises(ValueError, match="at most 16384"):
        wide = torch.ones(1, 16385, 2, 2, device=card)
        rms_norm_backward(wide, torch.ones(16385, device=card), wide, 1e-6, 1)
    # K3 trains over the last axis, as the JAX GatedRMSNorm; another axis
    # raises in the backward
    with pytest.raises(ValueError, match="axis 1 of a 4-d tensor"):
        gated_rms_norm(x.clone().requires_grad_(), x, w, 1e-6, 1).sum().backward()
    rows = x.view(32, 8).clone().requires_grad_()
    gated_rms_norm(rows, rows.detach(), w).sum().backward()
    torch.testing.assert_close(rows.grad, gated_rms_norm_backward_reference(
        rows.detach(), rows.detach(), w, torch.ones_like(rows))[0], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="at most 1536"):
        wide = torch.ones(2, 2048, device=card)
        gated_rms_norm_backward(wide, wide, torch.ones(2048, device=card), wide)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_matches_plain_version_on_the_card(card, dtype):
    """dx in x's dtype and dw in fp32 against the explicit formula. dx:
    fp32 a few ulp of its terms; bf16 one rounding step of the output. dw
    sums up to 262,144 products per channel (batch 4 at 256^2) in another
    order: relative 1e-4 of the channel's sum of |terms| covers it. Two
    launches give bit-equal dw (no atomics)."""
    gen = torch.Generator(device=card).manual_seed(5)
    cases = [(torch.randn(shape, generator=gen, device=card).to(dtype),
              torch.randn(shape, generator=gen, device=card).to(dtype), axis)
             for shape, axis in CARD_CASES]
    cases.append((misaligned((1, 128, 32, 32), dtype, gen, card),
                  misaligned((1, 128, 32, 32), dtype, gen, card), 1))
    for x, dy, axis in cases:
        shape, c = tuple(x.shape), x.shape[axis]
        w = torch.rand(c, generator=gen, device=card) + 0.5
        before = rms_norm_backward.launches
        dx, dw = rms_norm_backward(x, w, dy, 1e-6, axis)
        dw2 = rms_norm_backward(x, w, dy, 1e-6, axis)[1]
        torch.cuda.synchronize()
        assert rms_norm_backward.launches == before + 2
        assert dx.dtype == dtype and dx.shape == x.shape and dw.dtype == torch.float32
        assert torch.equal(dw, dw2), shape
        dx_want, dw_want = rms_norm_backward_reference(x, w, dy, 1e-6, axis)
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 1e-5)
        torch.testing.assert_close(dx.float(), dx_want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{shape}: {m}")
        dims = [d for d in range(x.dim()) if d != axis % x.dim()]
        r = torch.rsqrt(x.float().square().mean(dim=axis, keepdim=True) + 1e-6)
        scale = (dy.float() * x.float() * r).abs().sum(dim=dims)
        assert bool(((dw - dw_want).abs() <= 1e-4 * scale + 1e-6).all()), shape


@pytest.mark.cuda
def test_rms_norm_trains_through_both_kernels(card):
    """Autograd on CUDA tensors runs K1 forward and the backward kernel,
    and the gradients match autograd through the plain forward."""
    gen = torch.Generator(device=card).manual_seed(6)
    x = torch.randn(2, 32, 16, 16, generator=gen, device=card, requires_grad=True)
    w = (torch.rand(32, generator=gen, device=card) + 0.5).requires_grad_()
    dy = torch.randn(2, 32, 16, 16, generator=gen, device=card)
    fwd, bwd = rms_norm.launches, rms_norm_backward.launches
    (rms_norm(x, w, 1e-6, 1) * dy).sum().backward()
    torch.cuda.synchronize()
    assert (rms_norm.launches - fwd, rms_norm_backward.launches - bwd) == (1, 1)
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    (rms_norm_reference(x, w, 1e-6, 1) * dy).sum().backward()
    torch.testing.assert_close(gx, x.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gw, w.grad, rtol=1e-4, atol=1e-4)


# K3's shapes: the refiner's (B*L, d) rows at d = 32 and 64 and a small
# one (the JAX package's kernel benchmark), NCHW channels (one split across
# a cluster), ragged ones: a warp per row (d = 1000), rows of 5 or 10 packs
# (d = 40: lanes of a row idle) and d not a multiple of a pack (30: one
# value a thread). The backward takes the last axis ones.
K3_CASES = [((65536, 32), -1), ((262144, 32), -1), ((262144, 64), -1), ((4096, 32), -1),
            ((2, 32, 64, 64), 1), ((1, 1024, 8, 8), 1), ((3, 33, 7, 5), 1), ((5, 1000), -1),
            ((300, 40), -1), ((300, 30), -1)]
K3_BACKWARD_CASES = [shape for shape, axis in K3_CASES if axis == -1]


def gated_inputs(shape, c, dtype, gen, device, offset=False):
    """x and z (z at twice x's scale, so the gate spans its curve), and w of
    ``c`` channels; with ``offset``, x and z start one element past a
    16-byte boundary."""
    make = (lambda: misaligned(shape, dtype, gen, device)) if offset else (
        lambda: torch.randn(shape, generator=gen, device=device).to(dtype))
    x, z = make(), 2 * make()
    return x, z, torch.rand(c, generator=gen, device=device) + 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_kernel_matches_plain_version_on_the_card(card, dtype):
    gen = torch.Generator(device=card).manual_seed(7)
    for shape, axis, offset in [(s, a, False) for s, a in K3_CASES] + [((4096, 32), -1, True)]:
        x, z, w = gated_inputs(shape, shape[axis], dtype, gen, card, offset)
        before = gated_rms_norm.launches
        got = gated_rms_norm(x, z, w, 1e-6, axis)
        torch.cuda.synchronize()
        assert gated_rms_norm.launches == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        want = gated_rms_norm_reference(x, z, w, 1e-6, axis)
        # fp32: the kernel's expf and the sums differ by a few ulp; bf16: one
        # rounding step of the output.
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 1e-5)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_backward_kernel_matches_plain_version_on_the_card(card, dtype):
    """dx and dz in x's dtype and dw in fp32 against the plain version,
    with K1's backward tolerances (dx, dz: a few ulp in fp32, one rounding
    step in bf16; dw: 1e-4 of the channel's sum of |terms|), at K3's last
    axis shapes and with x, z and dy one element off a 16-byte boundary;
    two launches give bit-equal dw."""
    gen = torch.Generator(device=card).manual_seed(8)
    for shape, offset in [(s, False) for s in K3_BACKWARD_CASES] + [((4096, 32), True)]:
        x, z, w = gated_inputs(shape, shape[-1], dtype, gen, card, offset)
        dy = (misaligned(shape, dtype, gen, card) if offset
              else torch.randn(shape, generator=gen, device=card).to(dtype))
        before = gated_rms_norm_backward.launches
        dx, dz, dw = gated_rms_norm_backward(x, z, w, dy)
        dw2 = gated_rms_norm_backward(x, z, w, dy)[2]
        torch.cuda.synchronize()
        assert gated_rms_norm_backward.launches == before + 2
        assert dx.dtype == dz.dtype == dtype and dx.shape == dz.shape == x.shape
        assert dw.dtype == torch.float32 and torch.equal(dw, dw2), shape
        dx_want, dz_want, dw_want = gated_rms_norm_backward_reference(x, z, w, dy)
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 1e-5)
        for got, want in ((dx, dx_want), (dz, dz_want)):
            torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol,
                                       msg=lambda m: f"{shape} offset={offset}: {m}")
        g = x.float() * torch.nn.functional.silu(z.float())
        r = torch.rsqrt(g.square().mean(dim=-1, keepdim=True) + 1e-6)
        scale = (dy.float() * g * r).abs().sum(dim=0)
        assert bool(((dw - dw_want).abs() <= 1e-4 * scale + 1e-6).all()), shape


@pytest.mark.cuda
def test_gated_rms_norm_trains_through_both_kernels(card):
    """Autograd through GatedRMSNorm on CUDA tensors runs K3 forward and its
    backward kernel, and the gradients match autograd through the plain
    forward."""
    from adnm_tpu_torch.core.layers import GatedRMSNorm

    gen = torch.Generator(device=card).manual_seed(9)
    x, z, w = gated_inputs((2, 64, 64), 64, torch.float32, gen, card)
    x.requires_grad_()
    z.requires_grad_()
    dy = torch.randn(x.shape, generator=gen, device=card)
    m = GatedRMSNorm(64).to(card)
    with torch.no_grad():
        m.weight.copy_(w)
    fwd, bwd = gated_rms_norm.launches, gated_rms_norm_backward.launches
    (m(x, z) * dy).sum().backward()
    torch.cuda.synchronize()
    assert (gated_rms_norm.launches - fwd, gated_rms_norm_backward.launches - bwd) == (1, 1)
    got = (x.grad.clone(), z.grad.clone(), m.weight.grad.clone())
    x.grad = z.grad = None
    wr = w.clone().requires_grad_()
    (gated_rms_norm_reference(x, z, wr) * dy).sum().backward()
    for a, b in zip(got, (x.grad, z.grad, wr.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def scan_inputs(b, h, p, l, gen, carry=False, n=16, device="cuda"):
    """Scan inputs at the model's scales (A = -exp(U(0, ln 16)), dt from a
    softplus near 1e-3...0.1) or, with ``carry``, with |dA| ~ 3e-4, where
    the state carried from earlier chunks dominates y."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=device)

    x = torch.randn(b, h, p, l, generator=gen, device=device)
    if carry:
        dt, A = 0.005 + 0.01 * u(b, h, l), -(0.01 + 0.04 * u(h))
    else:
        dt = torch.nn.functional.softplus(torch.randn(b, h, l, generator=gen, device=device) - 4)
        A = -torch.exp(u(h) * 2.77)
    B, C = (torch.randn(b, n, l, generator=gen, device=device) for _ in range(2))
    return x, dt, A, B, C, 0.5 + u(h)


# (batch, heads, P, L, chunk, channel slices): the main path's (at batch
# 1) and ragged ones: Q below 32 and not a multiple of 32, head counts that
# do not fill a block's group of 8 heads (H = 5, at L = 1,024 over the
# tiles of one cluster, and at L = 2,600 over more tiles than a cluster
# takes, the last one ragged), L not a multiple of the sub-chunk (96) or
# below it (48, 40; 24 is a single sub-chunk), L not a multiple of 4 (50:
# 4-byte copies), more tiles than the carry stages at once (L = 65,792:
# 257 tiles), and batch 3 read from channel slices of wider tensors.
K2_CASES = [(1, 32, 4, 1024, 256, False), (1, 64, 4, 256, 256, False),
            (1, 128, 4, 64, 256, False), (1, 8, 4, 65536, 256, False), (2, 3, 4, 96, 48, False),
            (3, 5, 4, 40, 8, False), (1, 6, 4, 512, 128, False), (2, 8, 4, 96, 96, False),
            (1, 8, 4, 48, 48, False), (1, 5, 4, 1024, 256, False), (2, 3, 4, 50, 50, False),
            (1, 4, 4, 24, 8, False), (2, 5, 4, 2600, 40, False), (1, 3, 4, 65792, 256, False),
            (3, 8, 4, 4096, 256, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_ssd_kernel_matches_plain_version_on_the_card(card, reverse, carry):
    gen = torch.Generator(device=card).manual_seed(1)
    for b, h, p, l, q, sliced in K2_CASES:
        args = scan_inputs(b, h, p, l, gen, carry)
        if sliced:
            x, dt, A, B, C, D = args
            x, dt, B, C = channel_slices(x, dt, B, C)
            assert x.stride(0) > h * p * l and B.stride(0) > 16 * l
            args = x, dt, A, B, C, D
        before = ssd.ssd_chunked_scan.launches
        got = ssd.ssd_chunked_scan(*args, chunk_size=q, reverse=reverse)
        torch.cuda.synchronize()
        assert ssd.ssd_chunked_scan.launches == before + 1
        flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
        x, dt, A, B, C, D = args
        want = flip(ssd.ssd_chunked_scan_reference(flip(x), flip(dt), A, flip(B), flip(C), D, q))
        # fp32 both, sums and exps in another order: y is of order 1-10.
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_kernel_matches_the_naive_oracle_across_many_chunks(card):
    """16 chunks of 32 with a small |dA|, and L = 4,096 (64 or 128
    sub-chunks of the kernel over several tiles), forward and reversed: a
    broken carry cannot hide."""
    gen = torch.Generator(device=card).manual_seed(2)
    args = scan_inputs(1, 4, 4, 4096, gen, carry=True)
    want = ssd.ssd_naive_scan(*args)
    torch.testing.assert_close(ssd.ssd_chunked_scan(*args), want, rtol=1e-4, atol=1e-4)
    x, dt, A, B, C, D = args
    flip = [t.flip(-1) for t in (x, dt, B, C)]
    want = ssd.ssd_naive_scan(flip[0], flip[1], A, flip[2], flip[3], D).flip(-1)
    torch.testing.assert_close(ssd.ssd_chunked_scan(*args, reverse=True), want, rtol=1e-4,
                               atol=1e-4)
    args = scan_inputs(2, 8, 4, 512, gen, carry=True)
    got = ssd.ssd_chunked_scan(*args, chunk_size=32)
    one_chunk = ssd.ssd_chunked_scan(*args, chunk_size=256)
    want = ssd.ssd_naive_scan(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(one_chunk, want, rtol=1e-4, atol=1e-4)
    x, dt, A, B, C, D = args
    # What the first half's state adds to the second half (0.49 on average
    # on the CPU at this seed) is thousands of times the tolerance.
    x, dt, B, C = (t[..., 256:].contiguous() for t in (x, dt, B, C))
    alone = ssd.ssd_chunked_scan(x, dt, A, B, C, D, chunk_size=32)
    assert (got[..., 256:] - alone).abs().mean() > 0.1


@pytest.mark.cuda
def test_ssd_kernel_reads_channel_slices_in_place(card):
    """The mixers hand over channel slices of NCHW tensors (each sample
    contiguous, a larger batch stride); the kernel reads them as they are."""
    gen = torch.Generator(device=card).manual_seed(3)
    b, h, p, l = 2, 8, 4, 512
    big = torch.randn(b, 2 * h * p + 2 * 16 + 16, l, generator=gen, device=card)
    x = big[:, :h * p].view(b, h, p, l)
    B, C = big[:, 2 * h * p:2 * h * p + 16], big[:, 2 * h * p + 16:2 * h * p + 32]
    dt = torch.nn.functional.softplus(big[:, -16:-8] - 4)
    A, D = -torch.rand(2 * h, generator=gen, device=card)[h:] - 0.5, torch.ones(h, device=card)
    got = ssd.ssd_chunked_scan(x, dt, A, B, C, D, chunk_size=128, reverse=True)
    want = ssd.ssd_chunked_scan(*(t.contiguous() for t in (x, dt, A, B, C, D)),
                                chunk_size=128, reverse=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_ssd_kernel_wrapper_raises_on_what_the_kernel_does_not_take(card):
    gen = torch.Generator(device=card).manual_seed(4)
    args = scan_inputs(1, 4, 4, 64, gen)
    x, dt, A, B, C, D = args
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_chunked_scan(x.double(), dt, A, B, C, D)
    with pytest.raises(ValueError, match="N = 16"):
        ssd.ssd_chunked_scan(x, dt, A, B[:, :8], C[:, :8], D)
    with pytest.raises(ValueError, match="P = 4"):
        ssd.ssd_chunked_scan(*scan_inputs(1, 4, 8, 64, gen))
    with pytest.raises(ValueError, match="at most 256"):
        ssd.ssd_chunked_scan(*scan_inputs(1, 2, 4, 1024, gen), chunk_size=512)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_chunked_scan(x.transpose(1, 2), dt, A, B, C, D)
    with pytest.raises(ValueError, match="on cpu"):
        ssd.ssd_chunked_scan(x, dt, A.cpu(), B, C, D)


def scan_grad_inputs(b, h, p, l, gen, carry=False, sliced=False):
    x, dt, A, B, C, D = scan_inputs(b, h, p, l, gen, carry)
    if sliced:
        x, dt, B, C = channel_slices(x, dt, B, C)
    return x, dt, A, B, C, D, torch.randn(b, h, p, l, generator=gen, device=x.device)


# K2's backward also at the edges of its own layout, tiles of 128 tokens
# (4 sub-chunks of 32) of which at most 8 (L = 1,024, in K2_CASES) go
# through one thread cluster: L of exactly one tile (128), one tile and a
# token (129), a cluster's tiles and one sub-chunk more (1,056: the first
# shape of the multi-launch form), a carry one tile past its window of 512
# tiles (65,664: 513 tiles; 65,792 in K2_CASES is 514), and decoder2's 256
# heads at L = 256 (32 head groups whose dB and dC are summed).
K2B_CASES = K2_CASES + [(1, 8, 4, 128, 128, False), (2, 8, 4, 129, 129, False),
                        (1, 5, 4, 1056, 96, False), (1, 3, 4, 65664, 128, False),
                        (1, 256, 4, 256, 256, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_ssd_backward_kernel_matches_plain_version_on_the_card(card, reverse, carry):
    """K2's backward against its plain version at K2B_CASES (channel slices
    among them), and two launches bit-equal in every gradient: no atomics."""
    gen = torch.Generator(device=card).manual_seed(5)
    for b, h, p, l, q, sliced in K2B_CASES:
        *args, dy = scan_grad_inputs(b, h, p, l, gen, carry, sliced)
        before = ssd.ssd_chunked_scan_backward.launches
        got = ssd.ssd_chunked_scan_backward(*args, dy, q, reverse)
        again = ssd.ssd_chunked_scan_backward(*args, dy, q, reverse)
        torch.cuda.synchronize()
        assert ssd.ssd_chunked_scan_backward.launches == before + 2
        want = ssd.ssd_chunked_scan_backward_reference(*args, dy, q, reverse)
        terms = k2_grad_terms(*args, dy, want)
        for name, g, g2, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, again, want):
            assert torch.equal(g, g2), (name, b, h, l)
            if name in ("dA", "dD"):
                # sums over batch and L: 1e-4 of the sum of the terms' magnitudes
                assert bool(((g - w).abs() <= 1e-4 * terms[name] + 1e-6).all()), (name, b, h, l)
            else:
                # fp32 both, sums in another order, as the forward
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item(),
                                           msg=lambda m: f"{name} {b} {h} {l}: {m}")


@pytest.mark.cuda
def test_ssd_backward_kernel_wrapper_raises_on_what_the_kernel_does_not_take(card):
    gen = torch.Generator(device=card).manual_seed(6)
    *args, dy = scan_grad_inputs(1, 4, 4, 64, gen)
    x, dt, A, B, C, D = args
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_chunked_scan_backward(*args, dy.double())
    with pytest.raises(ValueError, match="N = 16"):
        ssd.ssd_chunked_scan_backward(x, dt, A, B[:, :8], C[:, :8], D, dy)
    with pytest.raises(ValueError, match="at most 256"):
        ssd.ssd_chunked_scan_backward(*scan_grad_inputs(1, 2, 4, 1024, gen), chunk_size=512)
    with pytest.raises(ValueError, match="on cpu"):
        ssd.ssd_chunked_scan_backward(x, dt, A, B, C, D, dy.cpu())
    # a non-contiguous dy is made contiguous
    got = ssd.ssd_chunked_scan_backward(*args, dy.transpose(2, 3).contiguous().transpose(2, 3))
    want = ssd.ssd_chunked_scan_backward(*args, dy)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mixer_type", ["adnssd", "vssd"])
def test_bimamba_model_trains_through_both_k2_kernels(card, mixer_type):
    """One training step of create_adnm_unet(5, 20, 6,
    linear_attn_duality=False) at 64^2: 28 K2 launches (20 and the
    refiner's 8 recomputed under remat), 20 K2 backward launches, and the
    loss and gradients of the CPU's plain versions."""
    from adnm_tpu_torch.models.adnm_unet import apply_reference_init, create_adnm_unet
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset

    def trainer(device):
        model = create_adnm_unet(5, 20, 6, linear_attn_duality=False, mixer_type=mixer_type)
        return Trainer(model, get_preset("ADNMUnet", 5, 20, 6, "Shanghai"), 5, device, seed=0,
                       param_transform=apply_reference_init)

    batch = np.random.RandomState(0).rand(1, 25, 1, 64, 64).astype(np.float32)
    t = trainer(card)
    ssd.ssd_chunked_scan.launches = ssd.ssd_chunked_scan_backward.launches = 0
    loss, grads = t.grads(batch)
    torch.cuda.synchronize()
    assert (ssd.ssd_chunked_scan.launches, ssd.ssd_chunked_scan_backward.launches) == (28, 20)
    loss_cpu, grads_cpu = trainer(torch.device("cpu")).grads(batch)
    torch.testing.assert_close(float(loss), float(loss_cpu), rtol=1e-4, atol=0)
    total = float(torch.sqrt(sum(g.square().sum() for g in grads_cpu.values())))
    for k, w in grads_cpu.items():
        # fp32 on both sides through some 60 layers, sums in other orders
        err = float((grads[k].cpu() - w).norm())
        assert err <= 2e-2 * float(w.norm()) + 1e-6 * total, (k, err, float(w.norm()))


@pytest.mark.cuda
def test_resolve_device_runs_fp32_convolutions_without_tf32():
    """TF32 allowed (cuDNN's default), then resolve_device("cuda"): the
    flags are off and a 256-channel convolution keeps fp32's precision
    against float64 (TF32's 10-bit mantissa would miss by ~1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    dev = resolve_device("cuda")
    assert not tf32_enabled()
    gen = torch.Generator().manual_seed(0)
    x, w = torch.randn(2, 256, 32, 32, generator=gen), torch.randn(64, 256, 3, 3, generator=gen)
    want = F.conv2d(x.double(), w.double(), padding=1)
    got = F.conv2d(x.to(dev), w.to(dev), padding=1).cpu().double()
    assert float((got - want).norm() / want.norm()) < 1e-5


@pytest.mark.cuda
def test_evaluator_on_the_card_counts_as_on_the_cpu(card):
    """A 4 x 20 x 256^2 batch, half of it on the thresholds' k/90: equal
    contingency counts (floor and compare are exact in fp32 on both), MAE
    and MSE within 1e-6 relative, SSIM within 1e-5."""
    rng = np.random.default_rng(0)
    shape = (4, 20, 256, 256)
    gt = rng.uniform(-0.05, 1.05, shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    on = (np.array([19, 20, 21, 29, 30, 31, 34, 35, 36, 39, 40, 41], np.float32)
          / np.float32(90))
    gt[:, :10] = rng.choice(on, size=(4, 10, 256, 256))
    evs = []
    for dev in (card, torch.device("cpu")):
        ev = SimplifiedEvaluator(20, 90, lpips_fn=False, device=dev)
        ev.lpips_fn = None
        ev.evaluate(pred, gt)
        evs.append(ev)
    got, want = evs
    assert got.metrics == want.metrics
    for k, rtol, atol in (("mae", 1e-6, 0), ("mse", 1e-6, 0), ("ssim", 0, 1e-5)):
        np.testing.assert_allclose(got.losses[k], want.losses[k], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.cuda
def test_two_forwards_of_one_input_are_bit_equal_on_the_card(card):
    """The full-width duality model at 256^2, batch 1: two forwards of one
    input give the same bits, and the transposed conv leaves cuDNN's
    deterministic flag as it found it (it holds the flag only for its own
    call: cuDNN's default algorithm for decoder.up_sample2 sums through
    atomics)."""
    from adnm_tpu_torch.cli import predict

    model = predict.load_model(None, card)
    x = torch.rand(1, 5, 1, 256, 256, generator=torch.Generator().manual_seed(0)).to(card)
    with torch.inference_mode():
        a, b = model(x), model(x)
    assert torch.equal(a, b)
    assert torch.backends.cudnn.deterministic is False


# bf16: the kernel and the plain version round fp32 results that differ by
# K2's fp32 tolerance, so the two roundings are at most one bf16 step
# (2^-7 relative) apart, plus that tolerance.
BF16_STEP = 2.0 ** -7


def bf16(*ts):
    return tuple(t.to(torch.bfloat16) for t in ts)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_ssd_kernel_matches_plain_version_in_bf16(card, reverse, carry):
    """K2 on bf16 inputs (K2_CASES: the vector and 4-byte paths, clusters
    and the three-launch form, channel slices) writes bf16 y within one
    bf16 step of its plain version, which computes in fp32 and rounds."""
    gen = torch.Generator(device=card).manual_seed(11)
    for b, h, p, l, q, sliced in K2_CASES:
        x, dt, A, B, C, D = bf16(*scan_inputs(b, h, p, l, gen, carry))
        if sliced:
            x, dt, B, C = channel_slices(x, dt, B, C)
        got = ssd.ssd_chunked_scan(x, dt, A, B, C, D, chunk_size=q, reverse=reverse)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16
        flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
        want = flip(ssd.ssd_chunked_scan_reference(flip(x), flip(dt), A, flip(B), flip(C), D, q))
        assert want.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP, atol=1e-4,
                                   msg=lambda m: f"{b} {h} {l}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("carry", [False, True])
def test_ssd_backward_kernel_matches_plain_version_in_bf16(card, reverse, carry):
    """K2's backward on bf16 inputs at K2B_CASES: every gradient bf16, two
    launches bit-equal, each within one bf16 step of the plain version
    (fp32 inside, rounded once) beside the fp32 tolerances."""
    gen = torch.Generator(device=card).manual_seed(12)
    for b, h, p, l, q, sliced in K2B_CASES:
        x, dt, A, B, C, D, dy = bf16(*scan_grad_inputs(b, h, p, l, gen, carry))
        if sliced:
            x, dt, B, C = channel_slices(x, dt, B, C)
        args = x, dt, A, B, C, D
        got = ssd.ssd_chunked_scan_backward(*args, dy, q, reverse)
        again = ssd.ssd_chunked_scan_backward(*args, dy, q, reverse)
        torch.cuda.synchronize()
        want = ssd.ssd_chunked_scan_backward_reference(*args, dy, q, reverse)
        terms = k2_grad_terms(*args, dy, want)
        for name, g, g2, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, again, want):
            assert g.dtype == w.dtype == torch.bfloat16, name
            assert torch.equal(g, g2), (name, b, h, l)
            g, w = g.float(), w.float()
            if name in ("dA", "dD"):
                tol = 1e-4 * terms[name] + BF16_STEP * w.abs() + 1e-6
                assert bool(((g - w).abs() <= tol).all()), (name, b, h, l)
            else:
                torch.testing.assert_close(g, w, rtol=BF16_STEP,
                                           atol=1e-4 * w.abs().max().item(),
                                           msg=lambda m: f"{name} {b} {h} {l}: {m}")


@pytest.mark.cuda
def test_ssd_kernels_raise_on_mixed_dtypes(card):
    gen = torch.Generator(device=card).manual_seed(13)
    *args, dy = scan_grad_inputs(1, 4, 4, 64, gen)
    x, dt, A, B, C, D = args
    with pytest.raises(TypeError, match="one dtype"):
        ssd.ssd_chunked_scan(x.bfloat16(), dt, A, B, C, D)
    with pytest.raises(TypeError, match="one dtype"):
        ssd.ssd_chunked_scan_backward(*bf16(*args), dy)


@pytest.mark.cuda
def test_two_bf16_forwards_of_one_input_are_bit_equal_on_the_card(card):
    """The full-width duality model at 256^2 in bf16 compute, batch 1: two
    forwards give the same bits, in bf16, from the fp32 parameters."""
    from adnm_tpu_torch.cli import predict

    model = predict.load_model(None, card, compute_dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x = torch.rand(1, 5, 1, 256, 256, generator=torch.Generator().manual_seed(0)).to(card)
    with torch.inference_mode():
        a, b = model(x.bfloat16()), model(x.bfloat16())
    assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("linear_attn_duality", [True, False])
def test_two_fp32_training_steps_give_the_same_gradients_on_the_card(card, linear_attn_duality):
    """Two gradients of one batch (the full-width model at 256^2, batch 1,
    refiner remat, the duality and the bimamba configurations) are
    bit-equal: the backward's convolutions run on cuDNN's deterministic
    algorithms (``Trainer._backward``), K1's and K2's backward kernels sum
    in one fixed order. The flag is restored after the backward."""
    from adnm_tpu_torch.models.adnm_unet import apply_reference_init, create_adnm_unet
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset

    trainer = Trainer(create_adnm_unet(5, 20, 6, linear_attn_duality=linear_attn_duality),
                      get_preset("ADNMUnet", 5, 20, 6, "Shanghai"), 5, card, seed=0,
                      param_transform=apply_reference_init)
    batch = np.random.RandomState(0).rand(1, 25, 1, 256, 256).astype(np.float32)
    runs = []
    for _ in range(2):
        loss, grads = trainer.grads(batch)
        runs.append((loss.clone(), {k: g.clone() for k, g in grads.items()}))
    (loss_a, a), (loss_b, b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    assert torch.backends.cudnn.deterministic is False


# -- the baselines ---------------------------------------------------------------

BASELINES = ("SmaATUnet", "ConvLSTM", "TrajGRU", "LPTQPN")
BASELINE_SIZE = 64
# Card against CPU, fp32 without TF32, full width at 64^2, seeded init: the
# forward's outputs (up to 1.0) within 1e-5 (CPU fp32 against fp64 at 64^2:
# 4.5e-8 ... 6.3e-7, scripts/torch_baseline_precision.py); one step's loss
# 1e-5 relative, global gradient norm 1e-3, each tensor 2e-2 of its norm +
# 1e-7 of the global norm (the ADNM step's bounds; 1e-5 of the global norm
# for a gradient that is 0 in exact arithmetic, ``chip_smoke.exact_zero_gradient``:
# the CPU's fp32 at 64^2 is 2.4e-7 of it from fp64), SmaAt's running
# statistics 1e-4 relative.
BASELINE_FORWARD_ATOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_forward_on_the_card_matches_the_cpu_bit_for_bit_twice(card, name):
    from adnm_tpu_torch.cli import predict

    x = torch.rand(1, 5, 1, BASELINE_SIZE, BASELINE_SIZE, generator=torch.Generator().manual_seed(0))
    models = {dev: predict.load_model(None, dev, model_name=name, img_size=BASELINE_SIZE)
              for dev in (card, torch.device("cpu"))}
    with torch.inference_mode():
        a, b = models[card](x.to(card)), models[card](x.to(card))
        want = models[torch.device("cpu")](x)
    assert torch.equal(a, b)
    assert float((a.cpu() - want).abs().max()) <= BASELINE_FORWARD_ATOL
    assert torch.backends.cudnn.deterministic is False


@pytest.mark.cuda
@pytest.mark.parametrize("name", BASELINES)
def test_baseline_training_step_on_the_card_matches_the_cpu_bit_for_bit_twice(card, name):
    """Two gradients of one batch on the card bit-equal (TrajGRU's warp sums
    its image gradient in a fixed order), and the card against the CPU."""
    batch = train_batch(1, BASELINE_SIZE)
    on_card = baseline_trainer(name, card, BASELINE_SIZE)
    runs = []
    for _ in range(2):
        loss, grads = on_card.grads(batch)
        runs.append((loss.clone(), {k: g.clone() for k, g in grads.items()},
                     {k: b.clone() for k, b in on_card.model.named_buffers()}))
    (loss_a, a, stats), (loss_b, b, _) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    on_cpu = baseline_trainer(name, torch.device("cpu"), BASELINE_SIZE)
    loss_cpu, want = on_cpu.grads(batch)
    assert abs(float(loss_a) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    total = float(torch.sqrt(sum(g.double().square().sum() for g in want.values())))
    got_total = float(torch.sqrt(sum(g.double().square().sum() for g in a.values())))
    assert abs(got_total - total) <= 1e-3 * total
    for k, w in want.items():
        err = float((a[k].cpu().double() - w.double()).norm())
        floor = 1e-5 if exact_zero_gradient(k) else 1e-7
        bound = 2e-2 * float(w.double().norm()) + floor * total
        assert err <= bound, (k, err, bound)
    for k, v in on_cpu.model.named_buffers():
        torch.testing.assert_close(stats[k].cpu(), v, rtol=1e-4, atol=1e-6)


# -- the last slice: MLA's K1 rows, the MLA model, TransUnet, SwinUnet ------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_and_its_backward_at_mla_rows_match_plain_versions(card, dtype):
    """K1 and its backward on MLA's (rows, rank) norms at batch 1 and 4
    (``chip_smoke.K1_MLA_ROWS``), within the tolerances of the tests above,
    dw bit-equal across launches."""
    gen = torch.Generator(device=card).manual_seed(7)
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 1e-5)
    for shape in K1_MLA_ROWS:
        x, dy = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(2))
        w = torch.rand(shape[1], generator=gen, device=card) + 0.5
        torch.testing.assert_close(rms_norm(x, w).float(), rms_norm_reference(x, w).float(),
                                   rtol=rtol, atol=atol, msg=lambda m: f"{shape}: {m}")
        (dx, dw), dw2 = rms_norm_backward(x, w, dy), rms_norm_backward(x, w, dy)[1]
        dx_want, dw_want = rms_norm_backward_reference(x, w, dy)
        torch.testing.assert_close(dx.float(), dx_want.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{shape}: {m}")
        r = torch.rsqrt(x.float().square().mean(dim=-1, keepdim=True) + 1e-6)
        scale = (dy.float() * x.float() * r).abs().sum(dim=0)
        assert torch.equal(dw, dw2) and bool(((dw - dw_want).abs() <= 1e-4 * scale + 1e-6).all())


@pytest.mark.cuda
def test_mla_model_forward_on_the_card_matches_the_cpu_bit_for_bit_twice(card):
    """The full-width MLA model at 64^2, batch 1, seeded init: two card
    forwards bit-equal with 26 K1 launches each, and the card against the
    CPU within the duality model's bound (``chip_smoke.FORWARD_ATOL``)."""
    from adnm_tpu_torch.cli import predict

    x = torch.rand(1, 5, 1, 64, 64, generator=torch.Generator().manual_seed(0))
    models = {dev: predict.load_model(None, dev, attn_type="mla")
              for dev in (card, torch.device("cpu"))}
    with torch.inference_mode():
        before = rms_norm.launches
        a, b = models[card](x.to(card)), models[card](x.to(card))
        torch.cuda.synchronize()
        assert rms_norm.launches - before == 2 * K1_MLA_PER_FORWARD
        want = models[torch.device("cpu")](x)
    assert torch.equal(a, b)
    assert float((a.cpu() - want).abs().max()) <= FORWARD_ATOL["mla"]


@pytest.mark.cuda
def test_two_mla_training_steps_give_the_same_gradients_on_the_card(card):
    """Two gradients of one batch of the full-width MLA model at 64^2 are
    bit-equal (34 K1 and 26 K1 backward launches each)."""
    trainer = make_trainer(card, **MLA)
    batch = train_batch(1, 64)
    runs = []
    for _ in range(2):
        before = (rms_norm.launches, rms_norm_backward.launches)
        loss, grads = trainer.grads(batch)
        torch.cuda.synchronize()
        assert (rms_norm.launches - before[0], rms_norm_backward.launches - before[1]) == \
            (K1_MLA_PER_FORWARD + REFINER_K1, K1_MLA_PER_FORWARD)
        runs.append((loss.clone(), {k: g.clone() for k, g in grads.items()}))
    (loss_a, a), (loss_b, b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]


# TransUnet's and SwinUnet's steps at 64^2, card against CPU with the
# stochastic rates at 0: the ADNM step's bounds, or ten times the CPU's fp32
# distance from fp64 at 64^2 where that is larger (TransUnet: gradient norm
# 4.3e-4, worst tensor 1.0e-2; SwinUnet 3.0e-9, 1.7e-6;
# scripts/torch_baseline_precision.py).
NEW_BASELINE_STEP_TOL = {"TransUnet": {"grad_norm": 4.3e-3, "tensor": 0.1},
                         "SwinUnet": {"grad_norm": 1e-3, "tensor": 2e-2}}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TransUnet", "SwinUnet"])
def test_new_baseline_forward_on_the_card_matches_the_cpu_bit_for_bit_twice(card, name):
    from adnm_tpu_torch.cli import predict

    x = torch.rand(1, 5, 1, BASELINE_SIZE, BASELINE_SIZE, generator=torch.Generator().manual_seed(0))
    models = {dev: predict.load_model(None, dev, model_name=name, img_size=BASELINE_SIZE)
              for dev in (card, torch.device("cpu"))}
    with torch.inference_mode():
        a, b = models[card](x.to(card)), models[card](x.to(card))
        want = models[torch.device("cpu")](x)
    assert torch.equal(a, b)
    assert float((a.cpu() - want).abs().max()) <= BASELINE_FORWARD_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["TransUnet", "SwinUnet"])
def test_new_baseline_steps_are_bit_equal_at_their_rates_and_match_the_cpu(card, name):
    """Two card steps at the published dropout and DropPath rates (the
    masks of one step) bit-equal; at rates 0, the card against the CPU
    within ``NEW_BASELINE_STEP_TOL`` (each tensor plus 1e-7 of the global
    norm; 1e-5 for an exact-zero gradient), each running statistic 1e-4
    relative L2 of its channel vector, as ``chip_smoke.check_baseline_step``
    holds it (a running mean near 0 has no relative error of its own)."""
    batch = train_batch(1, BASELINE_SIZE)
    on_card = baseline_trainer(name, card, BASELINE_SIZE)
    runs = []
    for _ in range(2):
        loss, grads = on_card.grads(batch)
        runs.append((loss.clone(), {k: g.clone() for k, g in grads.items()}))
    (loss_a, a), (loss_b, b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]
    del on_card
    on_card = baseline_trainer(name, card, BASELINE_SIZE, rates0=True)
    loss_c, got = on_card.grads(batch)
    on_cpu = baseline_trainer(name, torch.device("cpu"), BASELINE_SIZE, rates0=True)
    loss_cpu, want = on_cpu.grads(batch)
    tol = NEW_BASELINE_STEP_TOL[name]
    assert abs(float(loss_c) - float(loss_cpu)) <= 1e-5 * abs(float(loss_cpu))
    total = float(torch.sqrt(sum(g.double().square().sum() for g in want.values())))
    got_total = float(torch.sqrt(sum(g.double().square().sum() for g in got.values())))
    assert abs(got_total - total) <= tol["grad_norm"] * total
    for k, w in want.items():
        err = float((got[k].cpu().double() - w.double()).norm())
        floor = 1e-5 if exact_zero_gradient(k) else 1e-7
        assert err <= tol["tensor"] * float(w.double().norm()) + floor * total, (k, err)
    cpu_stats = dict(on_cpu.model.named_buffers())
    for k, v in on_card.model.named_buffers():
        w = cpu_stats[k].double()
        assert float((v.cpu().double() - w).norm()) <= 1e-4 * float(w.norm()), k


# -- the LAPS task's new kernel shapes, the native decode, bf16 baselines --------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_and_its_backward_at_the_laps_refiner_shape(card, dtype):
    """K1 and its backward at the LAPS model's 16-channel refiner Blocks,
    (1, 16, 256, 256): against the plain versions with
    ``test_kernel_matches_plain_version_on_the_card``'s and
    ``test_backward_kernel_matches_plain_version_on_the_card``'s
    tolerances, dw bit-equal across two launches."""
    gen = torch.Generator(device=card).manual_seed(7)
    x, dy = (torch.randn(1, 16, 256, 256, generator=gen, device=card).to(dtype)
             for _ in range(2))
    w = torch.rand(16, generator=gen, device=card) + 0.5
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 1e-5)
    before = (rms_norm.launches, rms_norm_backward.launches)
    y = rms_norm(x, w, 1e-6, 1)
    dx, dw = rms_norm_backward(x, w, dy, 1e-6, 1)
    dw2 = rms_norm_backward(x, w, dy, 1e-6, 1)[1]
    torch.cuda.synchronize()
    assert (rms_norm.launches, rms_norm_backward.launches) == (before[0] + 1, before[1] + 2)
    torch.testing.assert_close(y.float(), rms_norm_reference(x, w, 1e-6, 1).float(), rtol=rtol,
                               atol=atol)
    dx_want, dw_want = rms_norm_backward_reference(x, w, dy, 1e-6, 1)
    torch.testing.assert_close(dx.float(), dx_want.float(), rtol=rtol, atol=atol)
    assert torch.equal(dw, dw2)
    r = torch.rsqrt(x.float().square().mean(dim=1, keepdim=True) + 1e-6)
    scale = (dy.float() * x.float() * r).abs().sum(dim=(0, 2, 3))
    assert bool(((dw - dw_want).abs() <= 1e-4 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("carry", [False, True], ids=["model_scales", "small_dA_carry"])
def test_k2_and_its_backward_at_the_laps_refiner_shape(card, carry):
    """K2 and its backward at the LAPS bimamba refiner's 4 heads a path over
    65,536 tokens, batch 1, forward and reversed: the tolerances of the
    K2 tests above, the backward bit-equal across two launches."""
    gen = torch.Generator(device=card).manual_seed(8)
    for reverse in (False, True):
        *args, dy = scan_grad_inputs(1, 4, 4, 65536, gen, carry)
        flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
        x, dt, A, B, C, D = args
        got = ssd.ssd_chunked_scan(*args, chunk_size=256, reverse=reverse)
        want = flip(ssd.ssd_chunked_scan_reference(flip(x), flip(dt), A, flip(B), flip(C), D,
                                                   256))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        grads = ssd.ssd_chunked_scan_backward(*args, dy, 256, reverse)
        again = ssd.ssd_chunked_scan_backward(*args, dy, 256, reverse)
        ref = ssd.ssd_chunked_scan_backward_reference(*args, dy, 256, reverse)
        terms = k2_grad_terms(*args, dy, ref)
        for name, g, g2, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads, again, ref):
            assert torch.equal(g, g2), name
            if name in terms:
                assert bool(((g - w).abs() <= 1e-4 * terms[name] + 1e-6).all()), name
            else:
                torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item())


@pytest.mark.cuda
def test_native_decode_matches_interpolate_on_the_card_machine(card):
    """The native decode-resize (built with g++ from csrc/radar_io.cpp) of a
    clip at the h5's frame size against the F.interpolate path, within
    1e-6."""
    from adnm_tpu_torch.data import native, shanghai

    clip = np.random.RandomState(0).randint(0, 71, (5, 565, 784)).astype(np.uint8)
    got = native.decode_resize_clip(clip, 256)
    want = shanghai._resize_bilinear_antialias(clip.astype(np.float32) / 255.0, 256)
    assert got.shape == (5, 256, 256) and float(np.abs(got - want).max()) <= 1e-6


@pytest.mark.cuda
def test_two_bf16_baseline_forwards_are_bit_equal_on_the_card(card):
    """SmaAt-UNet in bf16 compute at 64^2, batch 1: two forwards give the
    same bits, fp32 out (JAX's up path is fp32), no hand kernel."""
    from adnm_tpu_torch.cli import predict

    model = predict.load_model(None, card, model_name="SmaATUnet", img_size=BASELINE_SIZE,
                               compute_dtype=torch.bfloat16)
    x = torch.rand(1, 5, 1, BASELINE_SIZE, BASELINE_SIZE,
                   generator=torch.Generator().manual_seed(0)).to(card, torch.bfloat16)
    before = rms_norm.launches
    with torch.inference_mode():
        a, b = model(x), model(x)
    assert a.dtype == torch.float32 and torch.isfinite(a).all() and torch.equal(a, b)
    assert rms_norm.launches == before


# Data parallelism on the card: the TINY ADNM-UNet of tests/test_multihost.py
# (K1 on every rank; K2 too in the bimamba configuration), one row a rank.
DP_CFG = dict(channels=5, out_channels=2, kernel=(3, 3, 3), wt_levels=(1, 1, 1),
              embed_dim=(8, 8, 16, 16, 16, 16), refine_dim=(8, 8, 8, 8))


def dp_job(**kw):
    import functools

    from adnm_tpu_torch.models.adnm_unet import ADNMUNet
    from test_torch_port_parallel_workers import Job

    batch = np.random.default_rng(100).uniform(0, 1, (2, 7, 1, 32, 32)).astype(np.float32)
    return Job(functools.partial(ADNMUNet, **DP_CFG, **kw), "ADNMUnet", batch, grads=True,
               steps=2)


@pytest.mark.cuda
def test_ddp_over_nccl_at_world_size_one_gives_the_plain_step_bits(card, tmp_path):
    """One rank over NCCL: the DDP Trainer's gradients, two steps' losses and
    gradient norms and every parameter after them are the plain Trainer's,
    bit for bit; K1 launched each step."""
    from adnm_tpu_torch.parallel import spawn
    from test_torch_port_parallel_workers import load_ranks, run_steps, single_process

    job = dp_job()
    spawn(run_steps, 1, args=(job, str(tmp_path)), device="cuda", timeout_s=600)
    (rank,) = load_ranks(str(tmp_path), 1)
    plain = single_process(job, card)
    assert rank["losses"] == plain["losses"] and rank["gnorms"] == plain["gnorms"]
    for k, g in plain["grads"].items():
        assert torch.equal(rank["grads"][k], g), k
    for k, v in plain["params"].items():
        assert torch.equal(rank["params"][k], v), k
    assert all(c["rms_norm"] > 0 and c["rms_norm_backward"] > 0 for c in rank["launches"])


@pytest.mark.cuda
@pytest.mark.parametrize("linear_attn_duality", [True, False])
def test_two_gloo_ranks_on_one_card_match_the_single_process(card, tmp_path,
                                                            linear_attn_duality):
    """Two ranks on the one card over gloo (CUDA tensors), one row each,
    against one process on the global batch of 2: the ranks agree bit for
    bit, the loss within 1e-5 and every gradient within 1e-4 of its norm or
    1e-6 of the global norm (fp32, the batch's sums in another order), the
    parameters after two AdamW steps within 2 lr a step; K1 (and K2) and
    their backwards launched on each rank."""
    from adnm_tpu_torch.parallel import spawn
    from test_torch_port_parallel_workers import load_ranks, run_steps, single_process

    job = dp_job(linear_attn_duality=linear_attn_duality)
    spawn(run_steps, 2, args=(job, str(tmp_path)), device="cuda", backend="gloo",
          shared_device=True, timeout_s=600)
    ranks = load_ranks(str(tmp_path), 2)
    plain = single_process(job, card)
    a, b = ranks
    assert a["losses"] == b["losses"] and a["gnorms"] == b["gnorms"]
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert a["launches"] == b["launches"]
    scan = not linear_attn_duality
    assert all(c["rms_norm_backward"] > 0 and (c["ssd_chunked_scan_backward"] > 0) == scan
               for c in a["launches"])
    assert a["grad_loss"] == pytest.approx(plain["grad_loss"], rel=1e-5)
    total = float(torch.sqrt(sum(g.double().square().sum() for g in plain["grads"].values())))
    for k, g in plain["grads"].items():
        err = float((a["grads"][k].double() - g.double()).norm())
        assert err <= max(1e-4 * float(g.double().norm()), 1e-6 * total), k
    for k, v in plain["params"].items():
        if v.is_floating_point() and v.numel():
            assert float((a["params"][k] - v).abs().max()) <= 2 * 2 * job.lr * 1.002, k


# Single dispatch on the card: Trainer(scan_steps=K) replays one CUDA graph
# of K steps, and the eval and serving forwards replay one graph per batch
# shape; each gives the eager bits.
GRAPH_LR, GRAPH_CLIP = 1e-3, 0.025


def graph_model(case: str):
    from adnm_tpu_torch.models.adnm_unet import ADNMUNet
    from adnm_tpu_torch.models.registry import create_model

    if case == "duality":
        return ADNMUNet(**DP_CFG)
    if case == "bimamba":
        return ADNMUNet(**DP_CFG, linear_attn_duality=False)
    if case == "SwinUnet":  # nonzero Dropout and DropPath rates
        from adnm_tpu_torch.models.swin_unet import SwinUnet

        return SwinUnet(2, img_size=32, embed_dim=12, depths=(1, 1, 1, 1),
                        num_heads=(1, 1, 1, 1), window_size=2, drop_rate=0.1,
                        attn_drop_rate=0.1, drop_path_rate=0.2)
    return create_model(case, 5, 2, 6, img_size=32)


def counted() -> dict:
    from adnm_tpu_torch.utils.graphs import COUNTED

    return {f.__name__: f.launches for f in COUNTED}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["duality", "bimamba", "SwinUnet", "SmaATUnet", "TrajGRU"])
def test_graphed_steps_give_the_eager_steps_bits(card, case):
    """Three groups of two steps (the first eager and captured, then two
    replays) against six eager steps from the same weights: every loss,
    gradient norm, parameter, buffer and optimizer state entry bit for
    bit, and a replay launches the hand kernels as the eager steps do.
    SwinUnet at its rates under whole-forward remat (the masks and their
    recompute), SmaAt-UNet with its BatchNorm buffers, TrajGRU with its
    deterministic warp."""
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset

    preset = "ADNMUnet" if case in ("duality", "bimamba") else case
    eager, graphed = (Trainer(graph_model(case), get_preset(preset, 5, 2, 6, "Shanghai"), 5,
                              card, seed=0, remat_forward=case == "SwinUnet", scan_steps=k)
                      for k in (1, 2))
    rng = np.random.default_rng(7)
    for g in range(3):
        group = torch.from_numpy(rng.uniform(0, 1, (2, 2, 7, 1, 32, 32)).astype(np.float32))
        group = group.to(card)
        before = counted()
        want = [eager.train_step(b, GRAPH_LR, GRAPH_CLIP) for b in group]
        mid = counted()
        losses, norms = graphed.train_steps(group, GRAPH_LR, GRAPH_CLIP)
        after = counted()
        torch.cuda.synchronize()
        assert torch.equal(losses, torch.stack([w[0] for w in want])), g
        assert torch.equal(norms, torch.stack([w[1] for w in want])), g
        assert {k: after[k] - mid[k] for k in after} == {k: mid[k] - before[k] for k in mid}
        if g:
            assert len(graphed.graphs.graphs) == 1
    for (name, p), q in zip(eager.model.state_dict().items(),
                            graphed.model.state_dict().values()):
        assert torch.equal(p, q), name
    want, got = eager.optimizer.state_dict(), graphed.optimizer.state_dict()
    for i, st in want["state"].items():
        for k, v in st.items():
            assert torch.equal(v, got["state"][i][k]), (i, k)


@pytest.mark.cuda
def test_graphed_forwards_give_the_eager_forwards_bits(card):
    """``forecast`` and ``eval_epoch`` with graphs against without, batch 2
    and the tail of 1: the first call of a shape eager and captured, the
    next replayed (``forecast`` with the caller's ``GraphSet``, and with
    the default, a set for the call); K1 launched as often either way."""
    from adnm_tpu_torch.cli.predict import forecast
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset
    from adnm_tpu_torch.utils.graphs import GraphSet

    t = Trainer(graph_model("duality"), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, card,
                seed=0)
    clips = np.random.default_rng(8).uniform(0, 1, (3, 7, 1, 32, 32)).astype(np.float32)
    before = counted()
    want = forecast(t.model, clips[:, :5], 2, card, graphs=False)
    eager_k1 = counted()["rms_norm"] - before["rms_norm"]
    graphs = GraphSet(card)
    for owned in (graphs, graphs, None):
        before = counted()
        np.testing.assert_array_equal(forecast(t.model, clips[:, :5], 2, card, graphs=owned),
                                      want)
        assert counted()["rms_norm"] - before["rms_norm"] == eager_k1
    assert len(graphs.graphs) == 2
    batches = [clips[:2], clips[2:]]
    loss, preds, _ = t.eval_epoch(batches, collect=True, graphs=False)
    for _ in range(2):
        got = t.eval_epoch(batches, collect=True)
        assert got[0] == loss
        np.testing.assert_array_equal(got[1], preds)
    assert len(t.graphs.graphs) == 2


# Tensor parallelism on the card: a rank's heads on the mesh's 'model' axis.


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_on_a_ranks_head_subset_is_its_plain_version_in_place(card, reverse):
    """What a rank of model=2 hands K2 at the refiner (8 heads a path,
    4 a rank, 65,536 tokens): its heads' channels of one wider tensor and
    its rows of dt, A and D, each sample contiguous, read in place; against
    the plain version on the same slices and the whole scan's heads."""
    gen = torch.Generator(device=card).manual_seed(3)
    x, dt, A, B, C, D = scan_inputs(2, 8, 4, 65536, gen, False)
    xs, dts, Bs, Cs = channel_slices(x, dt, B, C)
    whole = ssd.ssd_chunked_scan(xs, dts, A, Bs, Cs, D, chunk_size=256, reverse=reverse)
    flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
    for heads in (slice(0, 4), slice(4, 8)):
        sx, sdt = xs[:, heads], dts[:, heads]
        assert sx[0].is_contiguous() and sdt[0].is_contiguous()
        assert sx.stride(0) == xs.stride(0)  # views of the wider tensor, not copies
        before = ssd.ssd_chunked_scan.launches
        got = ssd.ssd_chunked_scan(sx, sdt, A[heads], Bs, Cs, D[heads], chunk_size=256,
                                   reverse=reverse)
        torch.cuda.synchronize()
        assert ssd.ssd_chunked_scan.launches == before + 1
        want = flip(ssd.ssd_chunked_scan_reference(flip(sx), flip(sdt), A[heads], flip(Bs),
                                                   flip(Cs), D[heads], 256))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got, whole[:, heads], rtol=0, atol=0)  # heads independent


@pytest.mark.cuda
@pytest.mark.parametrize("linear_attn_duality", [True, False])
def test_two_gloo_ranks_on_the_model_axis_match_one_process(card, tmp_path, linear_attn_duality):
    """``forecast`` on ('data', 'model') = (1, 2), two gloo ranks sharing
    the card, against one process: the same predictions on both ranks,
    within 1e-5 of one process (the partial products summed by the
    all-reduce), K1 (and K2, on each rank's half of the heads) launched on
    each rank."""
    import functools

    from adnm_tpu_torch.cli.predict import forecast
    from adnm_tpu_torch.convert import to_jax_params
    from adnm_tpu_torch.core.layers import seeded_init_
    from adnm_tpu_torch.models.adnm_unet import ADNMUNet
    from adnm_tpu_torch.parallel import spawn
    from test_torch_port_parallel_workers import MeshJob, model_forecast, run_mesh_jobs

    make = functools.partial(ADNMUNet, **DP_CFG, linear_attn_duality=linear_attn_duality)
    model = seeded_init_(make(), 0)
    params = to_jax_params(model)
    x = np.random.default_rng(9).uniform(0, 1, (2, 5, 1, 32, 32)).astype(np.float32)
    want = forecast(model.to(card), x, 2, card, graphs=False)
    job = MeshJob("tp", 1, 2, model_forecast, (make, params, x, 2))
    spawn(run_mesh_jobs, 2, args=([job], str(tmp_path)), device="cuda", backend="gloo",
          shared_device=True, timeout_s=600)
    ranks = [torch.load(tmp_path / f"tp_rank{r}.pt", weights_only=False) for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["result"], ranks[1]["result"])
    np.testing.assert_allclose(ranks[0]["result"], want, rtol=1e-5, atol=1e-5)
    for r in ranks:
        assert r["traffic"]["model"] > 0
        assert r["launches"]["rms_norm"] > 0
        assert (r["launches"]["ssd_chunked_scan"] > 0) == (not linear_attn_duality)


# The mesh's 'seq' axis on the card: K2's carried form, and a band a rank.

# (batch, heads, L, chunk): the layouts the carried form walks. One
# sub-chunk (L = 24), one tile (L = 96: the states launch writes its tile's
# record, which the plain path's fused launch keeps in a cluster), a few
# tiles (L = 1,024), a ragged last tile with heads past a block's 8 (L =
# 2,600, 5 heads), the refiner's half at seq = 2 (L = 32,768) and more
# tiles than the carry stages at once (L = 65,792).
K2_SEGMENT_CASES = [(2, 3, 24, 8), (1, 8, 96, 96), (2, 8, 1024, 256), (2, 5, 2600, 40),
                    (1, 8, 32768, 256), (1, 3, 65792, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_with_an_incoming_state_matches_its_plain_version(card, dtype, reverse):
    """A ``ScanSegment``'s outputs from an incoming state (K2's states,
    carry and outputs launches) and its end state and decay against the
    plain version with the same state, at the model's decays and at
    |dA| ~ 3e-4, on inputs rounded to ``dtype`` (the plain version widens
    them as the kernel does)."""
    from chip_smoke import BF16_STEP, K2_TOL

    rtol, atol = K2_TOL
    step = BF16_STEP if dtype == torch.bfloat16 else 0.0
    gen = torch.Generator(device=card).manual_seed(11)
    flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
    for carry in (False, True):
        for b, h, l, q in K2_SEGMENT_CASES:
            x, dt, A, B, C, D = (t.to(dtype) for t in scan_inputs(b, h, 4, l, gen, carry))
            s0 = torch.randn(b, h, 16, 4, generator=gen, device="cuda")
            before = ssd.ssd_chunked_scan.launches
            seg = ssd.ScanSegment(x, dt, A, B, C, D, q, reverse=reverse)
            got = seg.outputs(s0)
            torch.cuda.synchronize()
            assert ssd.ssd_chunked_scan.launches == before + 1 and got.dtype == dtype
            want, state, decay = ssd.ssd_chunked_scan_reference(
                flip(x), flip(dt), A, flip(B), flip(C), D, q, initial_state=s0,
                return_final_state=True)
            want = flip(want).float()
            err = (got.float() - want).abs()
            assert bool((err <= atol + (rtol + step) * want.abs()).all()), (b, h, l, carry)
            _, zero_state, zero_decay = ssd.ssd_chunked_scan_reference(
                flip(x), flip(dt), A, flip(B), flip(C), D, q, return_final_state=True)
            torch.testing.assert_close(seg.state, zero_state, rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(seg.decay, zero_decay, rtol=1e-4, atol=1e-30)
            # the state carried through to the end: the zero-state segment's
            # state plus s0 decayed across it
            torch.testing.assert_close(state, zero_state + s0 * zero_decay[..., None, None],
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_segments_chained_equal_the_whole_scan(card, dtype, reverse):
    """A sequence cut into 2 and 4 segments, each scanned by K2's carried
    form from the state its predecessors (in the scan's direction) hand
    it, equals the whole scan: at |dA| ~ 3e-4 over many chunks, where a
    broken carry cannot hide (the incoming state moves the later segments
    by far more than the tolerance), and at the refiner's L = 65,536."""
    from chip_smoke import BF16_STEP, K2_TOL

    rtol, atol = K2_TOL
    step = BF16_STEP if dtype == torch.bfloat16 else 0.0
    gen = torch.Generator(device=card).manual_seed(12)
    for b, h, l, q, carry in ((2, 8, 4096, 32, True), (1, 8, 65536, 256, True),
                              (1, 8, 65536, 256, False)):
        args = [t.to(dtype) for t in scan_inputs(b, h, 4, l, gen, carry)]
        whole = ssd.ssd_chunked_scan(*args, q, reverse=reverse).float()
        for parts in (2, 4):
            cut = l // parts
            pieces = [[t[..., i * cut:(i + 1) * cut].contiguous() if t.dim() > 1 else t
                       for t in args] for i in range(parts)]
            segs = [ssd.ScanSegment(*p, q, reverse=reverse) for p in pieces]
            states = [(s.state, s.decay) for s in segs]
            ys = [s.outputs(ssd.compose_states(states, reverse, i)) for i, s in enumerate(segs)]
            got = torch.cat(ys, dim=-1).float()
            err = (got - whole).abs()
            assert bool((err <= atol + (rtol + step) * whole.abs()).all()), (l, parts, carry)
            if carry:
                later = slice(cut, None) if not reverse else slice(0, l - cut)
                alone = torch.cat([s.outputs(torch.zeros_like(s.state)) for s in segs],
                                  dim=-1).float()
                assert (alone[..., later] - whole[..., later]).abs().mean() > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_without_a_state_keeps_its_launch_and_a_zero_state_its_bits(card, reverse):
    """Without an incoming state a scan takes K2's unchanged entry, one
    launch counted, two calls bit-equal; at the refiner's many tiles the
    carried form from a zero state gives those bits too (its carry-in adds
    0 * decay to the same entering states), fp32 and bf16."""
    gen = torch.Generator(device=card).manual_seed(13)
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in scan_inputs(1, 8, 4, 65536, gen)]
        before = ssd.ssd_chunked_scan.launches
        plain = ssd.ssd_chunked_scan(*args, 256, reverse=reverse)
        again = ssd.ssd_chunked_scan(*args, 256, reverse=reverse)
        torch.cuda.synchronize()
        assert ssd.ssd_chunked_scan.launches == before + 2
        torch.testing.assert_close(plain, again, rtol=0, atol=0)
        zero = torch.zeros(1, 8, 16, 4, device=card)
        carried = ssd.ScanSegment(*args, 256, reverse=reverse).outputs(zero)
        torch.testing.assert_close(carried, plain, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("linear_attn_duality", [True, False])
def test_two_gloo_ranks_on_the_seq_axis_match_one_process(card, tmp_path, linear_attn_duality):
    """``forecast`` on ('data', 'seq') = (1, 2), two gloo ranks sharing the
    card, each holding its band of rows: the same predictions on both
    ranks, within 1e-5 of one process, K1 (and K2, carried from rank to
    rank on bimamba) launched on each rank, bytes sent over 'seq' alone."""
    import functools

    from adnm_tpu_torch.cli.predict import forecast
    from adnm_tpu_torch.convert import to_jax_params
    from adnm_tpu_torch.core.layers import seeded_init_
    from adnm_tpu_torch.models.adnm_unet import ADNMUNet
    from adnm_tpu_torch.parallel import spawn
    from test_torch_port_parallel_workers import MeshJob, model_forecast, run_mesh_jobs

    make = functools.partial(ADNMUNet, **DP_CFG, linear_attn_duality=linear_attn_duality)
    model = seeded_init_(make(), 0)
    params = to_jax_params(model)
    x = np.random.default_rng(9).uniform(0, 1, (2, 5, 1, 32, 32)).astype(np.float32)
    want = forecast(model.to(card), x, 2, card, graphs=False)
    job = MeshJob("seq", 1, 1, model_forecast, (make, params, x, 2), seq=2)
    spawn(run_mesh_jobs, 2, args=([job], str(tmp_path)), device="cuda", backend="gloo",
          shared_device=True, timeout_s=600)
    ranks = [torch.load(tmp_path / f"seq_rank{r}.pt", weights_only=False) for r in range(2)]
    np.testing.assert_array_equal(ranks[0]["result"], ranks[1]["result"])
    np.testing.assert_allclose(ranks[0]["result"], want, rtol=1e-5, atol=1e-5)
    for r in ranks:
        assert r["traffic"]["seq"] > 0 and r["traffic"]["model"] == r["traffic"]["data"] == 0
        assert r["launches"]["rms_norm"] > 0
        assert (r["launches"]["ssd_chunked_scan"] > 0) == (not linear_attn_duality)


# Training on the mesh's 'seq' and 'model' axes on the card: K2's carried
# backward, and two gloo ranks stepping a band or half the heads each.


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_carried_backward_matches_its_plain_version(card, dtype, reverse):
    """``SegmentBackward`` on the card (K2's backward summary and segment
    carry, then its gradient walks from the entering state S0 and adjoint
    lambda) against the plain version with the same S0 and lambda, at
    K2_SEGMENT_CASES' layouts, the model's decays and |dA| ~ 3e-4: the six
    gradients within K2's backward bounds (bf16 within one more bf16 step),
    dS0 and the first phase's adjoint within them in fp32."""
    from chip_smoke import k2_carried_backward_against_plain

    gen = torch.Generator(device=card).manual_seed(21)
    for carry in (False, True):
        for b, h, l, q in K2_SEGMENT_CASES:
            *args, dy = (t.to(dtype) for t in scan_grad_inputs(b, h, 4, l, gen, carry))
            s0, lam = (torch.randn(b, h, 16, 4, generator=gen, device="cuda") for _ in range(2))
            k2_carried_backward_against_plain(ssd, args, dy, s0, lam, reverse,
                                              f"{(b, h, l)} {dtype} carry={carry}", q)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_carried_backward_from_zero_is_the_backward_kernels_bits(card, reverse):
    """From S0 = lambda = 0 the carried backward gives K2's backward
    kernel's bits, in its one-cluster layout (L = 1,024) and its carried one
    (the refiner's L = 65,536 and half of it), fp32 and bf16; one launch
    counted a call."""
    gen = torch.Generator(device=card).manual_seed(22)
    for b, h, l in ((2, 8, 1024), (1, 8, 32768), (1, 8, 65536)):
        for dtype in (torch.float32, torch.bfloat16):
            *args, dy = (t.to(dtype) for t in scan_grad_inputs(b, h, 4, l, gen))
            zero = torch.zeros(b, h, 16, 4, device="cuda")
            plain = ssd.ssd_chunked_scan_backward(*args, dy, 256, reverse)
            before = ssd.SegmentBackward.launches
            got = ssd.SegmentBackward(*args, dy, 256, reverse=reverse).grads(zero, zero)
            torch.cuda.synchronize()
            assert ssd.SegmentBackward.launches == before + 1
            for name, p, g in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), plain, got):
                assert torch.equal(p, g), (name, b, h, l, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_carried_backward_chained_equals_the_whole_scans(card, reverse):
    """A sequence cut into 2 and 4 segments, each segment's backward from
    the state and the adjoint the others hand it in the scan's direction,
    equals the whole scan's backward kernel, at |dA| ~ 3e-4 over many
    chunks (where the carried state and adjoint move the gradients far
    beyond the bound) and at the refiner's L = 65,536."""
    from chip_smoke import K2B_NAMES, K2B_SUM_RTOL, chained_backward

    gen = torch.Generator(device=card).manual_seed(23)
    for b, h, l, carry in ((2, 8, 4096, True), (1, 8, 65536, True), (1, 8, 65536, False)):
        *args, dy = scan_grad_inputs(b, h, 4, l, gen, carry)
        whole = ssd.ssd_chunked_scan_backward(*args, dy, 256, reverse)
        terms = k2_grad_terms(*args, dy, whole)
        for parts in (2, 4):
            got, alone = chained_backward(ssd, args, dy, parts, reverse)
            for name, g, a, w in zip(K2B_NAMES, got, alone, whole):
                e = (g.float() - w.float()).abs()
                if name in terms:
                    assert bool((e <= K2B_SUM_RTOL * terms[name] + 1e-6).all()), (name, l, parts)
                else:
                    assert bool((e <= 1e-4 * w.abs() + 1e-4 * w.abs().max()).all()), (name, l)
                    if carry:
                        assert (a - w).abs().max() > 0.01 * w.abs().max(), (name, l, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_k2_backward_on_a_ranks_head_subset_is_its_plain_version_in_place(card, reverse):
    """What a rank of model=2 hands K2's backward at the refiner (4 of a
    path's 8 heads, 65,536 tokens): its heads' channels of one wider tensor
    read in place, against the plain version on the same slices and the
    whole scan's heads (the heads are independent)."""
    gen = torch.Generator(device=card).manual_seed(24)
    *args, dy = scan_grad_inputs(2, 8, 4, 65536, gen, sliced=True)
    x, dt, A, B, C, D = args
    whole = ssd.ssd_chunked_scan_backward(*args, dy, 256, reverse)
    for heads in (slice(0, 4), slice(4, 8)):
        sx, sdt = x[:, heads], dt[:, heads]
        assert sx.stride(0) == x.stride(0) and sx[0].is_contiguous()
        part = (sx, sdt, A[heads], B, C, D[heads], dy[:, heads].contiguous())
        got = ssd.ssd_chunked_scan_backward(*part, 256, reverse)
        want = ssd.ssd_chunked_scan_backward_reference(*part, 256, reverse)
        for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * w.abs().max().item(),
                                       msg=lambda m: f"{name}: {m}")
        torch.testing.assert_close(got[0], whole[0][:, heads], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("axes", [(1, 2, 1), (1, 1, 2)])
@pytest.mark.parametrize("linear_attn_duality", [True, False])
def test_two_gloo_ranks_train_on_the_seq_and_model_axes_as_one_process(card, tmp_path, axes,
                                                                        linear_attn_duality):
    """Two training steps of the TINY ADNM-UNet on ('data', 'seq',
    'model') = ``axes``, two gloo ranks sharing the card, against one
    process: the ranks bit-equal, the loss within 1e-5 and every gradient
    within 1e-3 of its norm (plus 1e-6 of the whole gradient's), K1's
    backward launched on each rank and, on bimamba, K2's carried backward
    on 'seq'."""
    import functools

    from adnm_tpu_torch.core.layers import seeded_init_
    from adnm_tpu_torch.models.adnm_unet import ADNMUNet
    from adnm_tpu_torch.parallel import spawn
    from test_torch_port_parallel_workers import (MeshTrainJob, one_process_train,
                                                  run_mesh_cases)

    make = functools.partial(ADNMUNet, **DP_CFG, linear_attn_duality=linear_attn_duality)
    batch = np.random.default_rng(100).uniform(0, 1, (2, 7, 1, 32, 32)).astype(np.float32)
    job = MeshTrainJob("train", make, "ADNMUnet", batch, seeded_init_(make(), 0).state_dict())
    spawn(run_mesh_cases, 2, args=(axes, [job], str(tmp_path)), device="cuda", backend="gloo",
          shared_device=True, timeout_s=600)
    ranks = [torch.load(tmp_path / f"train_rank{r}.pt", weights_only=False) for r in range(2)]
    one = one_process_train(job, card)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    for step in range(2):
        assert ranks[0]["losses"][step] == pytest.approx(one["losses"][step], rel=1e-5)
        got, want = ranks[0]["grads"][step], one["grads"][step]
        total = float(torch.sqrt(sum(w.double().square().sum() for w in want.values())))
        for k, w in want.items():
            err = float((got[k].double() - w.double()).norm())
            assert err <= 1e-3 * float(w.double().norm()) + 1e-6 * total, (k, step)
        for k, v in ranks[0]["params"][step].items():
            assert torch.equal(v, ranks[1]["params"][step][k]), (k, step)
    for r in ranks:
        launches = r["launches"][0]
        assert launches["rms_norm_backward"] > 0
        carried = not linear_attn_duality and axes[1] > 1
        assert (launches["ssd_segment_backward"] > 0) == carried
