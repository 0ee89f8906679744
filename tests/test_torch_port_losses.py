"""The PyTorch port's rainfall losses against the JAX package's, on the CPU.

Both sides get the same numpy predictions and targets in [0, 1] (a share of
them above the 0.7 "high rain" threshold) and compute in fp32; the sums
run in another order, so the tolerance is rtol 1e-6 on losses of order
0.1.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.losses import rainfall as jrain
from adnm_tpu_torch.losses import rainfall as rain

RTOL = 1e-6


def _pair(shape=(2, 4, 1, 16, 16), seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)


def _both(name, pred, target, **kw):
    want = float(jrain.get_loss(name, **kw)(jnp.asarray(pred), jnp.asarray(target)))
    got = rain.get_loss(name, **kw)(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.dim() == 0 and got.dtype == torch.float32
    return float(got), want


@pytest.mark.parametrize("gamma", [0.0, 0.1, 0.7])
def test_en_rainfall_loss_matches_jax(gamma):
    """gamma = 0 is the ADNMUnet preset's; the others exercise the
    false-negative penalty."""
    pred, target = _pair(seed=1)
    got, want = _both("en_rainfall", pred, target, omega_t=0.57, alpha=0.25, gamma=gamma)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("omega_t", [0.57, 0.8])
def test_rainfall_loss_matches_jax_with_its_hard_coded_base_weight(omega_t):
    pred, target = _pair(seed=2)
    got, want = _both("rainfall", pred, target, omega_t=omega_t, alpha=0.25)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_rain_loss_matches_jax():
    pred, target = _pair(seed=3)
    got, want = _both("rain", pred, target)
    np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("lam", [None, 0.25])
def test_weighted_mse_mae_matches_jax(lam):
    """Targets scaled to the Shanghai thresholds (20, 30, 35, 40)."""
    pred, target = _pair(seed=4)
    pred, target = pred * 60.0, target * 60.0
    got, want = _both("weighted_mse_mae", pred, target, thresholds=(20, 30, 35, 40), lam=lam)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_en_rainfall_gradient_matches_jax():
    """The gradient the trainer takes, elementwise, at gamma 0.1."""
    import jax

    pred, target = _pair(seed=5)
    kw = dict(omega_t=0.57, alpha=0.25, gamma=0.1)
    want = jax.grad(lambda p: jrain.en_rainfall_loss(p, jnp.asarray(target), **kw))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    rain.en_rainfall_loss(p, torch.from_numpy(target), **kw).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-12)


def test_unknown_loss_raises():
    with pytest.raises(KeyError):
        rain.get_loss("dice")
