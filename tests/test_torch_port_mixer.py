"""The PyTorch port's ADN-SSD and VSSD mixers, duality op and softmax
attention against their JAX counterparts, on the CPU at small sizes.

The JAX ADN-SSD mixer runs token-minor below L = 16384 tokens and
channel-major from there on, and always token-minor with the chunked
scan; the port has one NCHW path, held against all of them. Tolerance
rtol 1e-4 / atol 1e-5 (fp32 both sides, sums in another order)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.mixers.attention import StandardAttention as JStandardAttention
from adnm_tpu.mixers.ssd_mixer import ADNSSDMixer as JADNSSDMixer
from adnm_tpu.mixers.vssd import VSSDMixer as JVSSDMixer
from adnm_tpu.ops import ssd as jssd
from adnm_tpu_torch.mixers.attention import StandardAttention
from adnm_tpu_torch.mixers.ssd_mixer import ADNSSDMixer
from adnm_tpu_torch.mixers.vssd import VSSDMixer
from adnm_tpu_torch.ops import ssd
from test_torch_port_layers import (  # noqa: F401 (one_torch_thread is a fixture)
    ATOL,
    RTOL,
    check_nchw,
    jax_apply,
    nchw,
    nhwc,
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


def slow_decay(params, seed=0):
    """A_log of every mixer set to log U(0.001, 0.01): with dt near 1 the
    state then lasts for hundreds of tokens, so the chunked scan's carry
    between chunks shows in the output."""
    rng = np.random.RandomState(seed)
    return {k: slow_decay(v, seed + 1) if isinstance(v, dict) else
            np.log(rng.uniform(0.001, 0.01, v.shape)).astype(np.float32) if k == "A_log" else v
            for k, v in params.items()}


def check_scan_mixer(jm, pm, x):
    """``check_nchw`` with the slow decay of ``slow_decay``."""
    jx = jnp.asarray(nhwc(x))
    params = slow_decay(random_params(jm, jx))
    want = nchw(jax_apply(jm, params, jx))
    np.testing.assert_allclose(run_port(pm, params, x), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("grid", [16, 32])
def test_bimamba_mixer_matches_the_jax_token_minor_path(grid):
    """The chunked scan over grid^2 tokens: JAX in chunks of 16 and with
    its path-2 channels of a head interleaved [a, b, a, b]; the port in
    chunks of 256 (one at 16^2, four at 32^2) and assembled [a, a, b, b]."""
    x = rand(2, 8, grid, grid)
    check_scan_mixer(JADNSSDMixer(8, headdim=4, linear_attn_duality=False, chunk_size=16),
                     ADNSSDMixer(8, headdim=4, linear_attn_duality=False), x)


@pytest.mark.parametrize("duality", [True, False])
def test_vssd_mixer(duality):
    """The bimamba branch as above: JAX in chunks of 16, the port in one."""
    x = rand(2, 8, 16, 16, seed=1)
    check_scan_mixer(JVSSDMixer(8, headdim=4, linear_attn_duality=duality, chunk_size=16),
                     VSSDMixer(8, headdim=4, linear_attn_duality=duality), x)


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
