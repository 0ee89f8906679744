"""Kernels K1 (RMS norm) and K3 (gated RMS norm), forward and backward, of
the PyTorch port: their plain versions against the JAX package, the
wrappers' dispatch and checks, and the build helper.

On the CPU the wrappers take the plain versions; the CUDA kernels
themselves are tested on the card by ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.core.layers import GatedRMSNorm as JGatedRMSNorm
from adnm_tpu.core.layers import RMSNorm as JRMSNorm
from adnm_tpu.ops.pallas import rms_norm_pallas
from adnm_tpu.ops.pallas.fused_norm import gated_rms_norm_pallas
from adnm_tpu_torch import convert
from adnm_tpu_torch.core.layers import GatedRMSNorm, RMSNorm
from adnm_tpu_torch.ops import _build
from adnm_tpu_torch.ops.rms_norm import (
    gated_rms_norm,
    gated_rms_norm_backward,
    gated_rms_norm_reference,
    rms_norm,
    rms_norm_backward,
    rms_norm_backward_reference,
    rms_norm_reference,
)
from test_torch_port_layers import one_torch_thread  # noqa: F401 (a fixture)

TOL = 1e-5  # fp32; rsqrt and the sum order differ


def _inputs(shape, c, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2).astype(np.float32)
    w = rng.uniform(0.5, 1.5, c).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(4, 8, 32), (300, 16), (3, 5, 7, 40)])
def test_plain_version_matches_pallas_kernel_on_last_axis(shape):
    """rms_norm_pallas in interpret mode, as the JAX package's tests run it."""
    x, w = _inputs(shape, shape[-1])
    want = np.asarray(rms_norm_pallas(jnp.asarray(x), jnp.asarray(w)))
    got = rms_norm_reference(torch.from_numpy(x), torch.from_numpy(w), 1e-6, -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# The main path's channel counts at its 8^2 Blocks (encoder6, decoder1),
# at 4x4 and 8x8, batch 1.
WIDE = [(1, 512, 4, 4), (1, 1024, 4, 4), (1, 512, 8, 8), (1, 1024, 8, 8)]


@pytest.mark.parametrize("shape", [(2, 32, 16, 16), (1, 128, 4, 4), (2, 12, 5, 3), *WIDE])
def test_rms_norm_module_matches_jax_on_nchw_channels(shape):
    x, w = _inputs(shape, shape[1], seed=1)
    want = JRMSNorm(shape[1], 1e-6, axis=1).apply({"params": {"weight": jnp.asarray(w)}},
                                                  jnp.asarray(x))
    m = RMSNorm(shape[1], 1e-6, axis=1)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(w))
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_bf16_keeps_fp32_statistics():
    x, w = _inputs((6, 16, 4, 4), 16, seed=2)
    xb = torch.from_numpy(x).bfloat16()
    got = rms_norm(xb, torch.from_numpy(w), 1e-6, 1)
    assert got.dtype == torch.bfloat16
    want = rms_norm_reference(xb.float(), torch.from_numpy(w), 1e-6, 1).bfloat16()
    assert torch.equal(got, want)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    x, w = _inputs((2, 8, 3, 3), 8)
    before = rms_norm.launches
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, 1)
    assert rms_norm.launches == before
    assert torch.equal(got, rms_norm_reference(torch.from_numpy(x), torch.from_numpy(w), 1e-6, 1))


def test_other_devices_and_bad_shapes_raise():
    """No silent fallback: a tensor neither on the CPU nor on CUDA raises."""
    with pytest.raises(ValueError, match="CPU or CUDA"):
        rms_norm(torch.empty(2, 4, device="meta"), torch.empty(4, device="meta"))
    with pytest.raises(ValueError, match="weight shape"):
        rms_norm(torch.ones(2, 4), torch.ones(3))


@pytest.mark.parametrize("shape,axis", [((2, 32, 8, 8), 1), ((3, 12, 5, 3), 1), ((300, 16), -1),
                                        ((4, 6, 40), -1), *((s, 1) for s in WIDE)])
def test_backward_plain_version_matches_jax_vjp(shape, axis):
    """dx and dw of ``rms_norm_backward_reference`` against ``jax.vjp`` of
    the JAX RMSNorm module; fp32 both, sums in another order."""
    c = shape[axis]
    x, w = _inputs(shape, c, seed=3)
    dy = np.random.RandomState(4).randn(*shape).astype(np.float32)
    m = JRMSNorm(c, 1e-6, axis=axis)
    _, vjp = jax.vjp(lambda p, v: m.apply({"params": {"weight": p}}, v), jnp.asarray(w),
                     jnp.asarray(x))
    dw_want, dx_want = vjp(jnp.asarray(dy))
    dx, dw = rms_norm_backward_reference(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.from_numpy(dy), 1e-6, axis)
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32 and dw.shape == (c,)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_want), rtol=1e-4, atol=1e-4)


def test_chip_smoke_times_k1_at_every_shape_the_model_gives_it(one_torch_thread, monkeypatch):
    """The duality models of both tasks (create_adnm_unet(5, 20, 6) and
    LAPS's (5, 3, 60), seeded) at 64^2 on the CPU: the shapes that reach K1,
    with H and W scaled to 256^2, are the ones chip_smoke.py checks and
    times (with the refiners' at batch 4), and a forward makes 20 calls."""
    import chip_smoke
    from adnm_tpu_torch.cli import predict
    from adnm_tpu_torch.core import layers

    seen = []

    def recording(x, weight, eps=1e-6, axis=-1):
        seen.append((tuple(x.shape), axis))
        return rms_norm(x, weight, eps, axis)

    monkeypatch.setattr(layers, "rms_norm", recording)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 5, 1, 64, 64).astype(np.float32))
    shapes = {}
    for dataset in ("Shanghai", "LAPS"):
        seen.clear()
        model = predict.load_model(None, torch.device("cpu"), dataset=dataset, img_size=64)
        with torch.inference_mode():
            model(x)
        assert len(seen) == chip_smoke.K1_PER_FORWARD == 20
        assert all(axis == 1 for _, axis in seen)
        shapes[dataset] = {(b, c, 4 * h, 4 * w) for (b, c, h, w), _ in seen}
    cases = {shape for shape, axis in chip_smoke.K1_CASES if axis == 1}
    refiners_b4 = {(4, c, 256, 256) for c in (32, 16)}
    assert shapes["Shanghai"] | {(4, 32, 256, 256)} == set(chip_smoke.K1_MAIN)
    assert shapes["LAPS"] - shapes["Shanghai"] | {(4, 16, 256, 256)} == set(chip_smoke.K1_LAPS)
    assert shapes["Shanghai"] | shapes["LAPS"] | refiners_b4 == cases


def test_rms_norm_is_differentiable_on_the_cpu_through_the_explicit_formula():
    """Autograd through ``rms_norm`` runs ``rms_norm_backward_reference``
    on a CPU tensor and agrees with autograd of the plain forward."""
    x, w = _inputs((2, 16, 4, 4), 16, seed=5)
    dy = torch.from_numpy(np.random.RandomState(6).randn(2, 16, 4, 4).astype(np.float32))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (rms_norm(xt, wt, 1e-6, 1) * dy).sum().backward()
    xr, wr = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (rms_norm_reference(xr, wr, 1e-6, 1) * dy).sum().backward()
    torch.testing.assert_close(xt.grad, xr.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(wt.grad, wr.grad, rtol=1e-5, atol=1e-5)
    before = rms_norm_backward.launches
    rms_norm_backward(torch.from_numpy(x), torch.from_numpy(w), dy, 1e-6, 1)
    assert rms_norm_backward.launches == before


@pytest.mark.parametrize("shape", [(4, 8, 32), (300, 16), (3, 5, 7, 40)])
def test_gated_plain_version_matches_pallas_kernel_and_jax_module(shape):
    """K3's plain version against ``gated_rms_norm_pallas`` in interpret
    mode and against the JAX ``GatedRMSNorm`` (the norm after the gate)."""
    x, w = _inputs(shape, shape[-1], seed=7)
    z = np.random.RandomState(8).randn(*shape).astype(np.float32) * 2
    pallas = np.asarray(gated_rms_norm_pallas(jnp.asarray(x), jnp.asarray(z), jnp.asarray(w)))
    module = np.asarray(JGatedRMSNorm(shape[-1], 1e-6).apply(
        {"params": {"weight": jnp.asarray(w)}}, jnp.asarray(x), jnp.asarray(z)))
    got = gated_rms_norm_reference(torch.from_numpy(x), torch.from_numpy(z),
                                   torch.from_numpy(w), 1e-6, -1)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), module, rtol=TOL, atol=TOL)
    m = GatedRMSNorm(shape[-1], 1e-6)
    convert.from_jax_params(m, {"weight": w})
    with torch.no_grad():
        np.testing.assert_array_equal(m(torch.from_numpy(x), torch.from_numpy(z)).numpy(),
                                      got.numpy())


def test_gated_module_on_nchw_channels_matches_the_last_axis():
    x, w = _inputs((2, 12, 5, 3), 12, seed=9)
    z = np.random.RandomState(10).randn(2, 12, 5, 3).astype(np.float32)
    got = GatedRMSNorm(12, 1e-6, axis=1)
    convert.from_jax_params(got, {"weight": w})
    with torch.no_grad():
        nchw = got(torch.from_numpy(x), torch.from_numpy(z))
    last = gated_rms_norm_reference(torch.from_numpy(x).movedim(1, -1),
                                    torch.from_numpy(z).movedim(1, -1), torch.from_numpy(w))
    torch.testing.assert_close(nchw, last.movedim(-1, 1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 8, 32), (300, 16), (3, 5, 7, 40)])
def test_gated_module_gradients_match_jax_vjp(shape):
    """dx, dz and dw through the port's GatedRMSNorm (autograd, the plain
    backward on the CPU) against ``jax.vjp`` of the JAX module with
    respect to weight, x and z; fp32 both, sums in another order."""
    x, w = _inputs(shape, shape[-1], seed=11)
    z = np.random.RandomState(12).randn(*shape).astype(np.float32) * 2
    dy = np.random.RandomState(13).randn(*shape).astype(np.float32)
    jm = JGatedRMSNorm(shape[-1], 1e-6)
    _, vjp = jax.vjp(lambda p, a, b: jm.apply({"params": {"weight": p}}, a, b), jnp.asarray(w),
                     jnp.asarray(x), jnp.asarray(z))
    dw_want, dx_want, dz_want = vjp(jnp.asarray(dy))
    m = GatedRMSNorm(shape[-1], 1e-6)
    convert.from_jax_params(m, {"weight": w})
    xt, zt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(z).requires_grad_()
    (m(xt, zt) * torch.from_numpy(dy)).sum().backward()
    for got, want in ((xt.grad, dx_want), (zt.grad, dz_want), (m.weight.grad, dw_want)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_gated_rms_norm_is_differentiable_and_counts_no_launch_on_the_cpu():
    """On CPU tensors the forward and the backward take their plain
    versions and count no launch; autograd through ``gated_rms_norm``
    agrees with autograd of the plain forward; the backward takes the last
    axis only, on every device."""
    x, w = _inputs((4, 8), 8)
    z = np.random.RandomState(14).randn(4, 8).astype(np.float32)
    dy = torch.from_numpy(np.random.RandomState(15).randn(4, 8).astype(np.float32))
    before = gated_rms_norm.launches, gated_rms_norm_backward.launches
    got = [torch.from_numpy(t).requires_grad_() for t in (x, z, w)]
    y = gated_rms_norm(*got)
    assert y.dtype == torch.float32
    (y * dy).sum().backward()
    assert (gated_rms_norm.launches, gated_rms_norm_backward.launches) == before
    want = [torch.from_numpy(t).requires_grad_() for t in (x, z, w)]
    (gated_rms_norm_reference(*want) * dy).sum().backward()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        gated_rms_norm(torch.from_numpy(x), torch.ones(4, 7), torch.from_numpy(w))
    nchw = torch.from_numpy(x).view(1, 4, 8, 1)[..., 0].requires_grad_()
    with pytest.raises(ValueError, match="axis 1 of a 3-d tensor"):
        gated_rms_norm(nchw, nchw.detach(), torch.ones(4), 1e-6, 1).sum().backward()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_is_keyed_by_the_source(monkeypatch, tmp_path):
    """An edited source gets a new library file, so a stale build is never loaded."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build.library_path("k", ("k.cu",))
    assert first == _build.library_path("k", ("k.cu",))
    (tmp_path / "k.cu").write_text("// two\n")
    assert _build.library_path("k", ("k.cu",)) != first
    assert first.parent == _build.BUILD_DIR
