"""The chunked SSD scan of the PyTorch port (kernel K2's plain version, its
wrapper and the naive oracle) and its backward (the plain backward and the
autograd function) against the JAX package (``jax.vjp``), on the CPU.

The port's layout is sequence-minor, x (B, H, P, L), dt (B, H, L), B and C
(B, N, L); JAX's is token-minor, x (B, L, H, P), dt (B, L, H), B and C
(B, L, N): the same numpy inputs go to both, transposed. Tolerance rtol
1e-4 / atol 1e-5 on outputs of order 1-30: both sides compute in fp32 and
differ in the order of their sums (JAX's dots run at full fp32 precision
in the tests). Gradients: dx, ddt, dB and dC as outputs (rtol 1e-4, atol
1e-5 of the largest entry); dA and dD, sums over the batch and L, to 1e-4
of the sum of their terms' magnitudes, as K1's dw. The CUDA kernels are
held against the plain versions on the card by
``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.ops import ssd as jssd
from adnm_tpu.ops.pallas import ssd_chunked_scan_pallas
from adnm_tpu_torch.ops import ssd
from test_torch_port_layers import one_torch_thread  # noqa: F401 (a fixture)

RTOL, ATOL = 1e-4, 1e-5


def scan_inputs(b, h, p, n, l, seed=0, carry=False):
    """The model's scales, or with ``carry`` |dA| ~ 3e-4 (A in [-0.05,
    -0.01], dt ~ 0.01), where the state carried between chunks dominates y."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, p, l)
    if carry:
        dt, A = rng.uniform(0.005, 0.015, (b, h, l)), -rng.uniform(0.01, 0.05, h)
    else:
        dt, A = np.log1p(np.exp(rng.randn(b, h, l) - 2)), -np.exp(rng.uniform(0, 2.77, h))
    B, C = rng.randn(b, n, l), rng.randn(b, n, l)
    D = rng.uniform(0.5, 1.5, h)
    return [a.astype(np.float32) for a in (x, dt, A, B, C, D)]


def to_jax(x, dt, A, B, C, D):
    return (jnp.asarray(x.transpose(0, 3, 1, 2)), jnp.asarray(dt.transpose(0, 2, 1)),
            jnp.asarray(A), jnp.asarray(B.transpose(0, 2, 1)), jnp.asarray(C.transpose(0, 2, 1)),
            jnp.asarray(D))


def from_jax(y) -> np.ndarray:
    return np.asarray(y).transpose(0, 2, 3, 1)


def flip_l(*arrays):
    return [np.ascontiguousarray(a[..., ::-1]) if a.ndim > 1 else a for a in arrays]


@pytest.mark.parametrize("b,h,p,n,l,chunk,carry", [
    (2, 3, 4, 5, 64, 256, False),   # one chunk, q = L < chunk
    (1, 4, 4, 16, 256, 64, False),  # four chunks
    (2, 2, 2, 8, 96, 16, True),     # six chunks, the carry dominates
    (1, 3, 8, 16, 1024, 256, True),  # the encoder4 Blocks' L and chunk
])
def test_plain_version_matches_jax_chunked_scan(b, h, p, n, l, chunk, carry):
    args = scan_inputs(b, h, p, n, l, seed=l, carry=carry)
    want = from_jax(jssd.ssd_chunked_scan(*to_jax(*args), chunk_size=chunk))
    got = ssd.ssd_chunked_scan(*map(torch.from_numpy, args), chunk_size=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("carry", [False, True])
def test_plain_and_naive_scans_match_the_jax_oracle(carry):
    args = scan_inputs(2, 3, 4, 8, 128, seed=1, carry=carry)
    want = from_jax(jssd.ssd_naive_scan(*to_jax(*args)))
    t_args = list(map(torch.from_numpy, args))
    np.testing.assert_allclose(ssd.ssd_naive_scan(*t_args).numpy(), want, rtol=RTOL, atol=ATOL)
    got = ssd.ssd_chunked_scan_reference(*t_args, chunk_size=16).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_the_carry_case_depends_on_the_carry():
    """Scanning the second half alone drops what the first half's state
    adds: in the small-|dA| case that is far above the tolerance."""
    x, dt, A, B, C, D = map(torch.from_numpy, scan_inputs(1, 4, 4, 16, 512, carry=True))
    y = ssd.ssd_chunked_scan(x, dt, A, B, C, D, chunk_size=64)
    alone = ssd.ssd_chunked_scan(*(t[..., 256:] for t in (x, dt)), A,
                                 *(t[..., 256:] for t in (B, C)), D, chunk_size=64)
    assert (y[..., 256:] - alone).abs().mean() > 0.1


def test_reverse_is_the_flipped_scan_of_the_bimamba_path():
    """``reverse=True`` is what the JAX mixers do for path 2: flip x, dt, B
    and C along L, scan, flip the result back."""
    args = scan_inputs(2, 4, 4, 16, 256, seed=2, carry=True)
    x, dt, A, B, C, D = args
    fx, fdt, fB, fC = flip_l(x, dt, B, C)
    want = from_jax(jssd.ssd_chunked_scan(*to_jax(fx, fdt, A, fB, fC, D), chunk_size=64))[..., ::-1]
    got = ssd.ssd_chunked_scan(*map(torch.from_numpy, args), chunk_size=64, reverse=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_plain_version_matches_the_pallas_kernel():
    """ssd_chunked_scan_pallas in interpret mode, as the JAX package's tests
    run it on the CPU; two chunks of 16."""
    args = scan_inputs(1, 2, 4, 8, 32, seed=3)
    want = from_jax(ssd_chunked_scan_pallas(*to_jax(*args), 16))
    got = ssd.ssd_chunked_scan_reference(*map(torch.from_numpy, args), chunk_size=16).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-4)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    args = list(map(torch.from_numpy, scan_inputs(1, 2, 4, 16, 64)))
    before = ssd.ssd_chunked_scan.launches
    got = ssd.ssd_chunked_scan(*args, chunk_size=32)
    assert ssd.ssd_chunked_scan.launches == before
    assert torch.equal(got, ssd.ssd_chunked_scan_reference(*args, chunk_size=32))


def test_wrapper_raises_on_a_ragged_chunk_and_other_devices():
    x, dt, A, B, C, D = map(torch.from_numpy, scan_inputs(1, 2, 4, 16, 96))
    with torch.no_grad():
        ssd.ssd_chunked_scan(x, dt, A, B, C, D.requires_grad_())  # no gradient is needed
    with pytest.raises(ValueError, match="not a multiple of the chunk 64"):
        ssd.ssd_chunked_scan(x, dt, A, B, C, D.detach(), chunk_size=64)
    with pytest.raises(ValueError, match="not a multiple"):
        ssd.ssd_chunked_scan_reference(x, dt, A, B, C, D.detach(), chunk_size=64)
    with pytest.raises(ValueError, match="shapes do not fit"):
        ssd.ssd_chunked_scan(x, dt[:, :1], A, B, C, D.detach())
    meta = [t.detach().to("meta") for t in (x, dt, A, B, C, D)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssd.ssd_chunked_scan(*meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssd.ssd_chunked_scan_backward(*meta, meta[0])
    with pytest.raises(ValueError, match="does not fit x"):
        ssd.ssd_chunked_scan_backward(x, dt, A, B, C, D.detach(), x[..., :32])


# -- the backward ---------------------------------------------------------

GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def grad_inputs(b, h, p, n, l, seed=0, carry=False):
    return [*scan_inputs(b, h, p, n, l, seed, carry),
            np.random.RandomState(seed + 1).randn(b, h, p, l).astype(np.float32)]


def jax_grads(args, dy, chunk, fn=None):
    """jax.vjp of the JAX scan (or ``fn``), in the port's layout."""
    fn = fn or (lambda *a: jssd.ssd_chunked_scan(*a, chunk_size=chunk))
    _, vjp = jax.vjp(fn, *to_jax(*args))
    dx, ddt, dA, dB, dC, dD = vjp(jnp.asarray(dy.transpose(0, 3, 1, 2)))
    return [from_jax(dx), np.asarray(ddt).transpose(0, 2, 1), np.asarray(dA),
            np.asarray(dB).transpose(0, 2, 1), np.asarray(dC).transpose(0, 2, 1),
            np.asarray(dD)]


def sum_terms(x, dt, A, B, C, D, dy):
    """sum |dt_t a_t <G_t, S_{t-1}>| and sum |x_t dy_t| per head, the
    magnitudes of the terms that dA and dD add up, from the recurrence in
    float64."""
    x, dt, A, B, C, dy = (a.astype(np.float64) for a in (x, dt, A, B, C, dy))
    b, h, p, l = x.shape
    a = np.exp(dt * A[None, :, None])
    S = np.zeros((l + 1, b, h, B.shape[1], p))  # S[t + 1] = S_t
    for t in range(l):
        S[t + 1] = a[:, :, t, None, None] * S[t] + np.einsum(
            "bn,bhp->bhnp", B[:, :, t], x[..., t] * dt[:, :, t, None])
    g = np.zeros((b, h, l))
    G = np.zeros_like(S[0])
    for t in reversed(range(l)):
        G = np.einsum("bn,bhp->bhnp", C[:, :, t], dy[..., t]) + G
        g[:, :, t] = a[:, :, t] * np.einsum("bhnp,bhnp->bh", G, S[t])
        G = a[:, :, t, None, None] * G
    return np.abs(dt * g).sum((0, 2)), np.abs(x * dy).sum((0, 2, 3))


def assert_grads_match(got, want, terms):
    """dx, ddt, dB, dC as the forward's outputs (rtol 1e-4, atol 1e-5 of
    the largest entry); dA and dD, sums over batch and L, to 1e-4 of the
    sum of their terms' magnitudes."""
    for name, g, w in zip(GRAD_NAMES, got, want):
        g = np.asarray(g)
        assert g.shape == w.shape, name
        if name in ("dA", "dD"):
            bound = 1e-4 * terms[name == "dD"] + 1e-7
            assert (np.abs(g - w) <= bound).all(), (name, g, w, bound)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL * np.abs(w).max(),
                                       err_msg=name)


@pytest.mark.parametrize("b,h,p,n,l,chunk,carry", [
    (2, 3, 4, 5, 64, 256, False),   # one chunk, q = L < chunk
    (1, 4, 4, 16, 256, 64, False),  # four chunks
    (2, 2, 2, 8, 96, 16, True),     # six chunks, the carry dominates
    (1, 3, 8, 16, 1024, 256, True),  # the encoder4 Blocks' L and chunk
])
def test_plain_backward_matches_jax_vjp(b, h, p, n, l, chunk, carry):
    *args, dy = grad_inputs(b, h, p, n, l, seed=l, carry=carry)
    want = jax_grads(args, dy, chunk)
    got = ssd.ssd_chunked_scan_backward(*map(torch.from_numpy, args), torch.from_numpy(dy),
                                        chunk_size=chunk)
    assert_grads_match(got, want, sum_terms(*args, dy))


def test_plain_backward_of_the_reverse_scan_matches_jax_vjp_of_the_flipped_scan():
    *args, dy = grad_inputs(2, 4, 4, 16, 256, seed=2, carry=True)
    x, dt, A, B, C, D = args
    flipped = [*flip_l(x, dt), A, *flip_l(B, C), D]
    fx, fdt, _, fB, fC, _ = want = jax_grads(flipped, *flip_l(dy), 64)
    want = [*flip_l(fx, fdt), want[2], *flip_l(fB, fC), want[5]]
    got = ssd.ssd_chunked_scan_backward(*map(torch.from_numpy, args), torch.from_numpy(dy),
                                        chunk_size=64, reverse=True)
    assert_grads_match(got, want, sum_terms(*flipped, *flip_l(dy)))


def test_plain_backward_matches_the_pallas_custom_vjp():
    """jax.vjp of ssd_chunked_scan_pallas (interpret mode), so its
    custom_vjp backward is what is held; two chunks of 16."""
    *args, dy = grad_inputs(1, 2, 4, 8, 32, seed=3, carry=True)
    want = jax_grads(args, dy, 16, lambda *a: ssd_chunked_scan_pallas(*a, 16))
    got = ssd.ssd_chunked_scan_backward_reference(*map(torch.from_numpy, args),
                                                  torch.from_numpy(dy), chunk_size=16)
    assert_grads_match(got, want, sum_terms(*args, dy))


@pytest.mark.parametrize("reverse", [False, True])
def test_autograd_through_the_scan_is_the_plain_backward(reverse):
    """On the CPU ``loss.backward()`` through the wrapper runs the plain
    backward, and launches nothing; channel slices get their gradients."""
    *args, dy = grad_inputs(2, 3, 4, 16, 128, seed=4, carry=True)
    x, dt, A, B, C, D = map(torch.from_numpy, args)
    big = torch.cat([B, C], 1).requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, D)]
    before = ssd.ssd_chunked_scan_backward.launches
    y = ssd.ssd_chunked_scan(leaves[0], leaves[1], leaves[2], big[:, :16], big[:, 16:],
                             leaves[3], chunk_size=32, reverse=reverse)
    y.backward(torch.from_numpy(dy))
    assert ssd.ssd_chunked_scan_backward.launches == before
    want = ssd.ssd_chunked_scan_backward_reference(x, dt, A, B, C, D, torch.from_numpy(dy),
                                                   32, reverse)
    got = [leaves[0].grad, leaves[1].grad, leaves[2].grad, big.grad[:, :16], big.grad[:, 16:],
           leaves[3].grad]
    for name, g, w in zip(GRAD_NAMES, got, want):
        assert torch.equal(g, w), name


def test_the_carry_case_gradients_depend_on_the_carry():
    """dy on the second half only: the first half's inputs get gradients
    only through the adjoint carried back across chunks, far above the
    tolerance in the small-|dA| case."""
    *args, dy = grad_inputs(1, 4, 4, 16, 512, carry=True)
    dy[..., :256] = 0
    t_args = list(map(torch.from_numpy, args))
    dx, ddt, dA, dB, dC, dD = ssd.ssd_chunked_scan_backward(*t_args, torch.from_numpy(dy),
                                                            chunk_size=64)
    assert dx[..., :256].abs().mean() > 0.1 and dB[..., :256].abs().mean() > 0.1
    assert not dC[..., :256].any()  # C_t reaches only y_t
    want = jax_grads(args, dy, 64)
    np.testing.assert_allclose(dx.numpy(), want[0], rtol=RTOL, atol=ATOL * np.abs(want[0]).max())


@pytest.mark.parametrize("carry", [False, True])
def test_the_kernels_suffix_sum_form_of_the_decay_gradient_matches_jax_vjp(carry):
    """K2's backward kernel keeps no state S_{t-1}: it takes
    w_t = a_t <G_t, S_{t-1}> as w_{t+1} + C_t . S_t dy_t - dt_t x_t . u_t,
    summed within each 32-token sub-chunk from the sub-chunk's end product
    <a_{t1} G_{t1}, S_{t1-1}>. That form, in float32 as the kernel takes it,
    against jax.vjp's ddt and dA over three sub-chunks."""
    *args, dy = grad_inputs(2, 3, 4, 16, 96, seed=7, carry=carry)
    x, dt, A, B, C, D = args
    b, h, p, l = x.shape
    a = np.exp(dt * A[None, :, None])
    S = np.zeros((b, h, 16, p), np.float32)
    z = np.zeros((b, h, l), np.float32)
    ends = {}  # the state at each sub-chunk's last token
    for t in range(l):
        S = a[:, :, t, None, None] * S + np.einsum("bn,bhp->bhnp", B[:, :, t], x[..., t] * dt[:, :, t, None])
        z[:, :, t] = np.einsum("bn,bhnp,bhp->bh", C[:, :, t], S, dy[..., t])
        if t % 32 == 31:
            ends[t] = S
    G = np.zeros_like(S)  # a_{t+1} G_{t+1}
    u = np.zeros_like(x)
    w = np.zeros((b, h, l), np.float32)
    for t in reversed(range(l)):
        if t % 32 == 31:
            acc = np.einsum("bhnp,bhnp->bh", G, ends[t])  # the sub-chunk's end product
        G = np.einsum("bn,bhp->bhnp", C[:, :, t], dy[..., t]) + G
        u[..., t] = np.einsum("bhnp,bn->bhp", G, B[:, :, t])
        acc = acc + z[:, :, t] - dt[:, :, t] * (x[..., t] * u[..., t]).sum(2)
        w[:, :, t] = acc
        G = a[:, :, t, None, None] * G
    ddt = (x * u).sum(2) + A[None, :, None] * w
    dA = (dt * w).sum((0, 2))
    want = jax_grads(args, dy, 32)
    np.testing.assert_allclose(ddt, want[1], rtol=RTOL, atol=ATOL * np.abs(want[1]).max())
    assert (np.abs(dA - want[2]) <= 1e-4 * sum_terms(*args, dy)[0] + 1e-7).all()


def test_chip_smoke_times_k2_at_every_shape_the_model_gives_it(one_torch_thread, monkeypatch):
    """The bimamba model (create_adnm_unet(5, 20, 6,
    linear_attn_duality=False), seeded) at 64^2 on the CPU: the (heads, L)
    that reach K2, with L scaled to 256^2, are the ones chip_smoke.py checks
    and times (with the earlier kernels' recorded times at each, batch 1
    and 4), each scanned forward and reversed, 20 calls a forward."""
    import chip_smoke
    from adnm_tpu_torch.cli import predict
    from adnm_tpu_torch.mixers import ssd_mixer

    seen = []

    def recording(x, dt, A, B, C, D, chunk_size=256, reverse=False):
        seen.append((x.shape[1], x.shape[-1], reverse))
        return ssd.ssd_chunked_scan(x, dt, A, B, C, D, chunk_size, reverse)

    monkeypatch.setattr(ssd_mixer, "ssd_chunked_scan", recording)
    model = predict.load_model(None, torch.device("cpu"), linear_attn_duality=False)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 5, 1, 64, 64).astype(np.float32))
    with torch.inference_mode():
        model(x)
    assert len(seen) == chip_smoke.K2_PER_FORWARD == 20
    assert {(h, 16 * l) for h, l, _ in seen} == set(chip_smoke.K2_SHAPES)
    timed = {(b, h, l) for b in (1, 4) for h, l in chip_smoke.K2_SHAPES}
    assert set(chip_smoke.K2_QUADRATIC_US) == set(chip_smoke.K2_BWD_FIRST_US) == timed
    for h, l, _ in seen:
        assert {r for hh, ll, r in seen if (hh, ll) == (h, l)} == {False, True}
