"""The PyTorch port's layers, wavelets and blocks against their JAX
counterparts, on the CPU at small sizes.

Every JAX parameter is drawn with numpy from a seed (not from the
modules' inits, whose gates are all 1.0 and would hide a swapped pair),
carried into the port by ``adnm_tpu_torch.convert.from_jax_params``, and
both sides get the same numpy input: NHWC for JAX, NCHW for the port.
Tolerance rtol 1e-4 / atol 1e-5: both sides compute in fp32 and differ
only in the order of their sums. The helpers here are shared with the
other ``test_torch_port_*`` files.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.core import blocks as jblocks
from adnm_tpu.core import layers as jlayers
from adnm_tpu.core import wavelet as jwavelet
from adnm_tpu_torch.convert import from_jax_params, unflatten_tree
from adnm_tpu_torch.core import blocks, layers, wavelet

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch: the tests run several processes side by
    side, and oversubscribed OpenMP threads slow small CPU convolutions by
    two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(rng: np.random.RandomState, name: str, shape) -> np.ndarray:
    if name == "kernel":
        bound = 1.0 / math.sqrt(max(1, math.prod(shape[:-1])))
        v = rng.uniform(-bound, bound, shape)
    elif name == "A_log":
        v = np.log(rng.uniform(1.0, 16.0, shape))
    elif name in ("bias", "dt_bias", "get_all_att_kernel", "get_all_att_bias") or \
            name.startswith(("shift", "threshold")):
        v = rng.uniform(-0.3, 0.3, shape)
    else:  # gates, scales, norm weights: around their init of 1
        v = rng.uniform(0.6, 1.4, shape)
    return v.astype(np.float32)


def random_params(jax_module, *args, seed: int = 0, **kwargs) -> dict:
    """A params tree for ``jax_module.apply(..., *args, **kwargs)`` with every
    leaf drawn by numpy; shapes come from ``jax.eval_shape`` of the init."""
    shapes = jax.eval_shape(
        lambda *a: jax_module.init(jax.random.PRNGKey(0), *a, **kwargs), *args).get("params", {})
    rng = np.random.RandomState(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        key = "/".join(str(p.key) for p in path)
        flat[key] = _draw(rng, key.rsplit("/", 1)[-1], leaf.shape)
    return unflatten_tree(flat)


def jax_apply(jax_module, params, *args, **kwargs):
    fn = jax.jit(lambda p, *a: jax_module.apply({"params": p}, *a, **kwargs))
    return fn(jax.tree.map(jnp.asarray, params), *args)


def nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def nchw(x) -> np.ndarray:
    return np.moveaxis(np.asarray(x), -1, 1)


def rand(*shape, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def run_port(module: torch.nn.Module, params, *args) -> np.ndarray:
    from_jax_params(module, params)
    with torch.no_grad():
        return module.eval()(*(torch.from_numpy(a) for a in args)).numpy()


def check_nchw(jax_module, port_module, *xs, rtol=RTOL, atol=ATOL, **kwargs):
    """Run both modules on NCHW inputs ``xs`` (NHWC for JAX) and compare."""
    jx = [jnp.asarray(nhwc(x)) for x in xs]
    params = random_params(jax_module, *jx, **kwargs)
    want = nchw(jax_apply(jax_module, params, *jx, **kwargs))
    got = run_port(port_module, params, *xs)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


NORMS = {
    "biasfree_ln": (lambda: jlayers.BiasFreeLayerNorm(8), lambda: layers.BiasFreeLayerNorm(8)),
    "instance": (lambda: jlayers.InstanceNorm(), lambda: layers.InstanceNorm()),
    "group4": (lambda: jlayers.GroupNorm(4, 8), lambda: layers.GroupNorm(4, 8)),
    "group8": (lambda: jlayers.GroupNorm(8, 8), lambda: layers.GroupNorm(8, 8)),
}


@pytest.mark.parametrize("kind", sorted(NORMS))
def test_norms(kind):
    jm, pm = NORMS[kind]
    x = rand(2, 8, 6, 5) * 3 + 1  # a mean away from 0 shows a missing centring
    check_nchw(jm(), pm(), x)


@pytest.mark.parametrize("name", ["Swish", "IntensityGate"])
def test_gates(name):
    check_nchw(getattr(jlayers, name)(), getattr(layers, name)(), rand(2, 3, 4, 4))


def test_gelu_is_the_tanh_form():
    x = torch.linspace(-4, 4, 101)
    got = layers.ACTS["gelu"](x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)


CONV_LAYERS = {
    "3x3_bias_gelu": dict(cin=4, features=6, kernel_size=3, padding=1, act="gelu"),
    "1x1_nobias": dict(cin=4, features=6, kernel_size=1, padding=0, use_bias=False),
    "grouped_1x3_group4_norm": dict(cin=8, features=8, kernel_size=(1, 3), padding=(0, 1),
                                    groups=2, norm="group4", act="gelu"),
    "depthwise_instance": dict(cin=8, features=8, kernel_size=3, padding=1, groups=8,
                               norm="instance"),
    "stride2": dict(cin=4, features=4, kernel_size=3, stride=2, padding=1),
    "same_even_kernel": dict(cin=4, features=4, kernel_size=6, padding="same", groups=4),
    "3x1_group8_norm": dict(cin=8, features=8, kernel_size=(3, 1), padding=(1, 0),
                            norm="group8", act="gelu"),
}


@pytest.mark.parametrize("case", sorted(CONV_LAYERS))
def test_conv_layer(case):
    kw = dict(CONV_LAYERS[case])
    cin = kw.pop("cin")
    x = rand(2, cin, 9, 10)
    check_nchw(jlayers.ConvLayer(**kw), layers.ConvLayer(cin, **kw), x)


def test_conv_layer_swish():
    jm = jlayers.ConvLayer(4, 3, 1, 1, use_bias=False,
                           act_module=lambda: jlayers.Swish(name="swish_act"))
    check_nchw(jm, layers.ConvLayer(4, 4, 3, 1, 1, use_bias=False, swish=True), rand(2, 4, 8, 8))


@pytest.mark.parametrize("ratio,kernel", [(2, 3), (2, 2), (4, 3), (2, 5)])
def test_deconv_layer_maps_the_transposed_kernel(ratio, kernel):
    """The JAX kernel is the HWIO kernel of the equivalent forward conv; the
    port's ConvTranspose2d weight is that kernel as (cin, cout, kh, kw)."""
    jm = jlayers.DeConvLayer(6, ratio, (kernel, kernel))
    pm = layers.DeConvLayer(4, 6, ratio, (kernel, kernel))
    x = rand(2, 4, 5, 7)
    check_nchw(jm, pm, x)
    assert pm(torch.from_numpy(x)).shape[2:] == (5 * ratio, 7 * ratio)


@pytest.mark.parametrize("name", ["Mlp", "FeedForward", "ConvFFD"])
def test_channel_mlps(name):
    check_nchw(getattr(jlayers, name)(8), getattr(layers, name)(8), rand(2, 8, 6, 6))


def test_haar_dwt_layout_and_inverse():
    x = rand(2, 3, 8, 6)
    got = wavelet.haar_dwt(torch.from_numpy(x))
    want = np.asarray(jwavelet.haar_dwt(jnp.asarray(nhwc(x))))  # (B, h, w, C, 4)
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 4, 1, 2)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(wavelet.haar_idwt(got).numpy(), x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("levels,kernel,size", [
    (1, 5, (8, 8)), (2, 3, (9, 11)), (3, 5, (16, 12)), (2, 6, (10, 10)), (3, 3, (13, 7)),
])
def test_wtconv2d(levels, kernel, size):
    """Kernel and scale in the per-channel block order ch*4+s; odd sizes
    pad before each DWT and crop after each IDWT."""
    jm = jwavelet.WTConv2d(4, kernel, 1, True, levels)
    pm = wavelet.WTConv2d(4, kernel, True, levels)
    check_nchw(jm, pm, rand(2, 4, *size))


def test_wtconv_layer():
    jm = jwavelet.WTConvLayer(4, 5, 1, 2, False, norm="group4", act="gelu")
    pm = wavelet.WTConvLayer(4, 5, 2, False, norm="group4", act="gelu")
    check_nchw(jm, pm, rand(2, 4, 12, 12))


@pytest.mark.parametrize("instance_norm", [True, False])
def test_patch_embed(instance_norm):
    x = np.random.RandomState(0).rand(2, 5, 16, 16).astype(np.float32)
    jm = jblocks.PatchEmbed(5, 8, 5, 2, instance_norm=instance_norm)
    pm = blocks.PatchEmbed(5, 8, 5, 2, instance_norm=instance_norm)
    jx = jnp.asarray(nhwc(x))
    params = random_params(jm, jx)
    want, want_res = jax_apply(jm, params, jx)
    from_jax_params(pm, params)
    with torch.no_grad():
        got, got_res = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), nchw(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_res.numpy(), np.asarray(want_res), rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["plain", "residual", "residual_group_norm"])
def test_wt_layer(mode):
    """The decoder's form (a residual, GroupNorm(8) without instance norm)
    and the encoder's (no residual)."""
    args = (rand(2, 8, 8, 8),) if mode == "plain" else \
        (rand(2, 4, 8, 8), rand(2, 4, 8, 8, seed=1))
    kw = dict(if_res=mode != "plain", instance_norm=mode != "residual_group_norm")
    check_nchw(jblocks.WTLayer(8, 6, 3, 2, **kw), blocks.WTLayer(8, 6, 3, 2, **kw), *args)


def test_down_and_up_sample():
    x = rand(2, 4, 8, 6)
    got = blocks.DownSample(2)(torch.from_numpy(x)).numpy()
    want = nchw(jblocks.DownSample(2).apply({}, jnp.asarray(nhwc(x))))
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    check_nchw(jblocks.UpSample(6), blocks.UpSample(4, 6), x)


def test_channel_att_bridge():
    c_list = (4, 6, 8)
    skips = [rand(2, c, 16 // (i + 1), 16 // (i + 1), seed=i) for i, c in enumerate(c_list)]
    jm, pm = jblocks.ChannelAttBridge(c_list), blocks.ChannelAttBridge(c_list)
    jx = [jnp.asarray(nhwc(s)) for s in skips]
    params = random_params(jm, jx)
    want = jax_apply(jm, params, jx)
    from_jax_params(pm, params)
    with torch.no_grad():
        got = pm([torch.from_numpy(s) for s in skips])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("instance_norm", [True, False])
def test_encoder_to_decoder(instance_norm):
    """Padded pools: -inf for max, count_include_pad for the average."""
    x = rand(2, 8, 6, 6) * 2 - 1
    att = rand(2, 8, 1, 1, seed=1)
    check_nchw(jblocks.EncoderToDecoder(8, instance_norm), blocks.EncoderToDecoder(8, instance_norm),
               x, att)


def test_out_proj_broadcasts_the_last_frame():
    x = rand(2, 8, 16, 16)
    res = np.random.RandomState(1).rand(2, 16, 16).astype(np.float32)
    jm, pm = jblocks.OutProj(5, 8), blocks.OutProj(5, 8)
    jx = jnp.asarray(nhwc(x))
    params = random_params(jm, jx, jnp.asarray(res))
    want = nchw(jax_apply(jm, params, jx, jnp.asarray(res)))
    got = run_port(pm, params, x, res)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_seeded_init_follows_the_jax_distributions():
    """Same seed -> same weights; kernels within the kaiming-uniform (a=sqrt 5)
    bound 1/sqrt(fan_in) and spread over it."""
    a = layers.seeded_init_(blocks.WTLayer(8, 6, 3, 2), 3)
    b = layers.seeded_init_(blocks.WTLayer(8, 6, 3, 2), 3)
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    w = a.conv.conv.weight  # (6, 8, 3, 3): fan_in 72
    bound = 1 / math.sqrt(72)
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
