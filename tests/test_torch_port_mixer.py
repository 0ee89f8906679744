"""The PyTorch port's ADN-SSD mixer, duality op and softmax attention
against their JAX counterparts, on the CPU at small sizes.

The JAX mixer runs token-minor below L = 16384 tokens and channel-major
from there on; the port has one NCHW path, held against both. Tolerance
rtol 1e-4 / atol 1e-5 (fp32 both sides, sums in another order)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.mixers.attention import StandardAttention as JStandardAttention
from adnm_tpu.mixers.ssd_mixer import ADNSSDMixer as JADNSSDMixer
from adnm_tpu.ops import ssd as jssd
from adnm_tpu_torch.mixers.attention import StandardAttention
from adnm_tpu_torch.mixers.ssd_mixer import ADNSSDMixer
from adnm_tpu_torch.ops import ssd
from test_torch_port_layers import (  # noqa: F401 (one_torch_thread is a fixture)
    ATOL,
    RTOL,
    check_nchw,
    jax_apply,
    one_torch_thread,
    random_params,
    rand,
    run_port,
)


def test_linear_attn_dual_seqminor():
    rng = np.random.RandomState(0)
    b, h, p, n, l = 2, 3, 4, 5, 64
    args = (
        rng.randn(b, h, p, l), np.log1p(np.exp(rng.randn(b, h, l))), -rng.uniform(1, 4, h),
        rng.randn(b, n, l), rng.randn(b, n, l), rng.uniform(0.5, 1.5, h),
    )
    args = [a.astype(np.float32) for a in args]
    want = jssd.linear_attn_dual_seqminor(*map(jnp.asarray, args), True)
    got = ssd.linear_attn_dual_seqminor(*map(torch.from_numpy, args))
    # atol 1e-4: outputs reach ~170 (sums over 64 tokens and 5 states of
    # unit normals), so near-zero entries carry that sum's fp32 rounding.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("d_model,headdim,size", [
    (8, 4, 16),     # token-minor in JAX (L = 256)
    (16, 8, 8),     # wider heads
    (8, 4, 128),    # channel-major in JAX (L = 16384)
])
def test_mixer_matches_the_jax_layout_it_takes(d_model, headdim, size):
    x = rand(2, d_model, size, size)
    check_nchw(JADNSSDMixer(d_model, headdim=headdim), ADNSSDMixer(d_model, headdim=headdim), x)


def test_mixer_matches_jax_channel_major_io():
    """JAX's ``cl=True`` path: (B, C, H, W) in and out, as in the refiner."""
    x = rand(1, 8, 128, 128)
    jm = JADNSSDMixer(8, headdim=4)
    params = random_params(jm, jnp.asarray(x), cl=True)
    want = np.asarray(jax_apply(jm, params, jnp.asarray(x), cl=True))
    got = run_port(ADNSSDMixer(8, headdim=4), params, x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_mixer_rejects_an_odd_head_count():
    with pytest.raises(ValueError):
        ADNSSDMixer(6, headdim=4)


@pytest.mark.parametrize("dim,heads,dim_head", [(8, 2, 4), (16, 4, 4)])
def test_standard_attention(dim, heads, dim_head):
    """JAX takes (B, L, D) tokens; the port takes (B, D, H, W)."""
    x = rand(2, dim, 4, 6)
    jm = JStandardAttention(dim, heads=heads, dim_head=dim_head)
    tokens = jnp.asarray(x.reshape(2, dim, -1).transpose(0, 2, 1))
    params = random_params(jm, tokens)
    want = np.asarray(jax_apply(jm, params, tokens)).transpose(0, 2, 1).reshape(x.shape)
    got = run_port(StandardAttention(dim, heads=heads, dim_head=dim_head), params, x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
