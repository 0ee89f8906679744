"""Kernel K1 (RMS norm) of the PyTorch port: its plain version against the
JAX package, the wrapper's dispatch and checks, and the build helper.

On the CPU the wrapper takes the plain version; the CUDA kernel itself is
tested on the card by ``tests/test_torch_port_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.core.layers import RMSNorm as JRMSNorm
from adnm_tpu.ops.pallas import rms_norm_pallas
from adnm_tpu_torch.core.layers import RMSNorm
from adnm_tpu_torch.ops import _build
from adnm_tpu_torch.ops.rms_norm import rms_norm, rms_norm_reference
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


@pytest.mark.parametrize("shape", [(2, 32, 16, 16), (1, 128, 4, 4), (2, 12, 5, 3)])
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
