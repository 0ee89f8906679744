"""The PyTorch port in bf16 compute (the JAX package's ``--bf16``) against
the JAX package in bf16, on the CPU.

Parameters are fp32 on both sides, drawn by numpy and carried into the port
by ``convert.from_jax_params``; inputs come from a numpy seed and are
rounded to bf16 on both sides. bf16 rounds at other places in the two
frameworks (XLA's fused elementwise chains, cuDNN's and oneDNN's
accumulators), so the yardstick is JAX's own: ``d``, the relative L2
distance between the JAX module in bf16 and in fp32 on the same inputs.
The port in bf16 is held to 2 d of JAX in bf16, never below one bf16
rounding (2^-8); the whole model also to 1.5 d of JAX in fp32. Every
activation's dtype is held to the dtype flax gives the counterpart module
(``capture_intermediates``), the JAX package's cast sites and fp32 islands
included. The training step in bf16 is in ``test_torch_port_train.py``,
beside the JAX trainer it reuses.
"""

from __future__ import annotations

import functools
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.core import blocks as jblocks
from adnm_tpu.core import layers as jlayers
from adnm_tpu.core import wavelet as jwavelet
from adnm_tpu.mixers import ssd_mixer as jssd_mixer
from adnm_tpu.mixers.vssd import VSSDMixer as JVSSDMixer
from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu.ops import ssd as jssd
from adnm_tpu.train.loop import Trainer as JTrainer
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import predict, train as train_cli, validate as validate_cli
from adnm_tpu_torch.cli import visualize as visualize_cli
from adnm_tpu_torch.core import blocks, layers, wavelet
from adnm_tpu_torch.mixers.ssd_mixer import ADNSSDMixer
from adnm_tpu_torch.mixers.vssd import VSSDMixer
from adnm_tpu_torch.models import adnm_unet as model
from adnm_tpu_torch.ops import ssd
from adnm_tpu_torch.train import checkpoint as ckpt
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_layers import (  # noqa: F401 (one_torch_thread is a fixture)
    nchw,
    nhwc,
    one_torch_thread,
    rand,
    random_params,
)
from test_torch_port_model import NARROW, frames

BF16_ROUNDING = 2.0 ** -8
CPU = torch.device("cpu")
# the JAX modules that only build parameters for a mixer's functional math:
# what flax captures for them are fp32 parameters, not activations
PARAM_BUILDERS = (jssd_mixer._Kernel, jssd_mixer._LNParams, jlayers._RawConvKernel,
                  jlayers._ConvParams)
CONFIGS = {"duality": {}, "bimamba": {"linear_attn_duality": False},
           "vssd-duality": {"mixer_type": "vssd"}}


def rel(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def to_bf16(tree):
    return jax.tree.map(lambda t: t.astype(jnp.bfloat16) if t.dtype == jnp.float32 else t, tree)


def leaves(out) -> list:
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in leaves(o)]
    return [out]


def port_arrays(out) -> list:
    return [t.float().numpy() for t in leaves(out)]


def jax_arrays(out) -> list:
    """NHWC leaves as NCHW float32 arrays."""
    return [np.asarray(nchw(t) if t.ndim == 4 else t, np.float32)
            for t in jax.tree_util.tree_leaves(jax.tree.map(lambda t: t.astype(jnp.float32), out))]


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def check_bf16(jax_module, port_module, *xs, fp32_inputs=()):
    """JAX in fp32 and in bf16 (one compile) and the port in bf16 on the
    NCHW numpy inputs ``xs`` (lists of them allowed; those at the indices
    ``fp32_inputs`` stay fp32 in both bf16 runs); every output leaf in the
    dtype JAX gives it, and within 2 d of JAX in bf16 (floor 2^-8)."""
    jx = jax.tree.map(lambda x: jnp.asarray(nhwc(x) if x.ndim == 4 else x), xs)
    params = random_params(jax_module, *jx)
    keep = [i in fp32_inputs for i in range(len(xs))]

    def both(p, *a):
        lo = [v if k else to_bf16(v) for v, k in zip(a, keep)]
        return jax_module.apply({"params": p}, *a), jax_module.apply({"params": p}, *lo)

    j32, j16 = jax.jit(both)(jax.tree.map(jnp.asarray, params), *jx)
    convert.from_jax_params(port_module, params)

    def port_input(x, k):
        dt = torch.float32 if k else torch.bfloat16
        return [torch.from_numpy(v).to(dt) for v in x] if isinstance(x, list) \
            else torch.from_numpy(x).to(dt)

    tx = [port_input(x, k) for x, k in zip(xs, keep)]
    with torch.no_grad():
        p16 = port_module.eval()(*tx)
    assert [dtype_name(t) for t in leaves(p16)] == \
        [dtype_name(t) for t in jax.tree_util.tree_leaves(j16)]
    for p, w16, w32 in zip(port_arrays(p16), jax_arrays(j16), jax_arrays(j32)):
        d = rel(w16, w32)
        assert rel(p, w16) <= max(2 * d, BF16_ROUNDING), (rel(p, w16), d)


# -- (a) the dtype of every activation -------------------------------------

@pytest.fixture(scope="module")
def narrow_params():
    jm = jmodel.ADNMUNet(**NARROW)  # the duality and bimamba models share one tree
    return {"adnssd": random_params(jm, jnp.asarray(frames(1, 32)), train=False),
            "vssd": random_params(jmodel.ADNMUNet(**NARROW, mixer_type="vssd"),
                                  jnp.asarray(frames(1, 32)), train=False)}


def params_of(narrow_params, config: str) -> dict:
    return narrow_params["vssd" if CONFIGS[config].get("mixer_type") == "vssd" else "adnssd"]


def jax_call_dtypes(jm, params, x) -> dict:
    """{module path: [the output leaves' dtypes of each call]} of a bf16
    forward, from flax's captured intermediates (shapes only, no compile)."""
    def run(p, v):
        return jm.apply({"params": p}, v, train=False, mutable=["intermediates"],
                        capture_intermediates=lambda mdl, method: (
                            method == "__call__" and not isinstance(mdl, PARAM_BUILDERS)))

    _, state = jax.eval_shape(run, jax.tree.map(jnp.asarray, params), x)
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                out[".".join(path)] = [[dtype_name(leaf) for leaf in jax.tree_util.tree_leaves(c)]
                                       for c in v]
            else:
                walk(v, path + [k])

    walk(state["intermediates"], [])
    return out


def port_call_dtypes(pm, x) -> dict:
    """{module name: [the output leaves' dtypes of each call]} of a forward,
    from forward hooks."""
    out = {}

    def hook(name):
        def record(module, args, result):
            out.setdefault(name, []).append([dtype_name(t) for t in leaves(result)])
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in pm.named_modules()]
    try:
        with torch.no_grad():
            pm(x)
    finally:
        for h in handles:
            h.remove()
    return out


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_every_activation_has_the_dtype_jax_gives_it(config, narrow_params):
    """Every module call of the NARROW model in bf16 that has a flax
    counterpart returns the dtypes flax's intermediates have: bf16, and
    fp32 where JAX promotes (the channel-attention maps; VSSD's mixer
    output and all that follows it). Only the ADN-SSD mixers' inner
    convolutions and norm, functional in JAX, have none."""
    kw = CONFIGS[config]
    params = params_of(narrow_params, config)
    x = frames(1, 32)
    want = jax_call_dtypes(jmodel.ADNMUNet(**NARROW, **kw), params,
                           jnp.asarray(x).astype(jnp.bfloat16))
    pm = model.ADNMUNet(**NARROW, **kw)
    convert.from_jax_params(pm, params)
    got = port_call_dtypes(pm, torch.from_numpy(x).bfloat16())
    unmatched = [n for n in got if n not in want]
    assert all(".mixer_" in n for n in unmatched), unmatched
    compared = {n: got[n] for n in got if n in want}
    assert len(compared) > 250, len(compared)
    assert {n: want[n] for n in compared} == compared
    assert got[""] == [["float32" if config == "vssd-duality" else "bfloat16"]]
    assert {t for calls in got.values() for c in calls for t in c} == {"bfloat16", "float32"}
    assert all(dt == ["float32"] * 7 for dt in got["decoder.fusion"])


# -- (b) each layer in bf16 --------------------------------------------------

LAYERS = {
    "conv_layer_group_norm_gelu": lambda: (
        jlayers.ConvLayer(8, (1, 3), 1, (0, 1), groups=2, norm="group4", act="gelu"),
        layers.ConvLayer(8, 8, (1, 3), 1, (0, 1), groups=2, norm="group4", act="gelu"),
        rand(2, 8, 9, 10)),
    "conv_layer_depthwise_instance": lambda: (
        jlayers.ConvLayer(8, 3, 1, 1, groups=8, norm="instance"),
        layers.ConvLayer(8, 8, 3, 1, 1, groups=8, norm="instance"), rand(2, 8, 9, 10)),
    "conv_layer_swish": lambda: (
        jlayers.ConvLayer(4, 3, 1, 1, use_bias=False,
                          act_module=lambda: jlayers.Swish(name="swish_act")),
        layers.ConvLayer(4, 4, 3, 1, 1, use_bias=False, swish=True), rand(2, 4, 8, 8)),
    "intensity_gate": lambda: (jlayers.IntensityGate(), layers.IntensityGate(),
                               rand(2, 3, 4, 4)),
    "biasfree_layer_norm": lambda: (jlayers.BiasFreeLayerNorm(8), layers.BiasFreeLayerNorm(8),
                                    rand(2, 8, 6, 5) * 3 + 1),
    "deconv_layer": lambda: (jlayers.DeConvLayer(6, 2, (3, 3)), layers.DeConvLayer(4, 6, 2, (3, 3)),
                             rand(2, 4, 5, 7)),
    "mlp": lambda: (jlayers.Mlp(8), layers.Mlp(8), rand(2, 8, 6, 6)),
    "feed_forward": lambda: (jlayers.FeedForward(8), layers.FeedForward(8), rand(2, 8, 6, 6)),
    "conv_ffd": lambda: (jlayers.ConvFFD(8), layers.ConvFFD(8), rand(2, 8, 6, 6)),
    "rms_norm_k1": lambda: (jlayers.RMSNorm(8), layers.RMSNorm(8, axis=1), rand(2, 8, 6, 5) + 1),
    "wtconv_layer": lambda: (jwavelet.WTConvLayer(4, 5, 1, 2, False, norm="group4", act="gelu"),
                             wavelet.WTConvLayer(4, 5, 2, False, norm="group4", act="gelu"),
                             rand(2, 4, 12, 12)),
    "patch_embed": lambda: (jblocks.PatchEmbed(5, 8, 5, 2), blocks.PatchEmbed(5, 8, 5, 2),
                            np.random.RandomState(0).rand(2, 5, 16, 16).astype(np.float32)),
    "wt_layer_residual": lambda: (jblocks.WTLayer(8, 6, 3, 2, if_res=True),
                                  blocks.WTLayer(8, 6, 3, 2, if_res=True), rand(2, 4, 8, 8),
                                  rand(2, 4, 8, 8, seed=1)),
    "channel_att_bridge": lambda: (jblocks.ChannelAttBridge((4, 6, 8)),
                                   blocks.ChannelAttBridge((4, 6, 8)),
                                   [rand(2, c, 16 // (i + 1), 16 // (i + 1), seed=i)
                                    for i, c in enumerate((4, 6, 8))]),
    "encoder_to_decoder_fp32_map": lambda: (jblocks.EncoderToDecoder(8),
                                            blocks.EncoderToDecoder(8), rand(2, 8, 6, 6),
                                            rand(2, 8, 1, 1, seed=1)),
    "out_proj": lambda: (jblocks.OutProj(5, 8), blocks.OutProj(5, 8), rand(2, 8, 16, 16),
                         np.random.RandomState(1).rand(2, 16, 16).astype(np.float32)),
    "adnssd_mixer_duality": lambda: (jssd_mixer.ADNSSDMixer(16, headdim=4),
                                     ADNSSDMixer(16, headdim=4), rand(2, 16, 8, 8)),
    "adnssd_mixer_bimamba": lambda: (jssd_mixer.ADNSSDMixer(16, headdim=4,
                                                            linear_attn_duality=False),
                                     ADNSSDMixer(16, headdim=4, linear_attn_duality=False),
                                     rand(2, 16, 8, 8)),
    "vssd_mixer_duality_fp32_output": lambda: (JVSSDMixer(16, headdim=4), VSSDMixer(16, headdim=4),
                                               rand(2, 16, 8, 8)),
    "attention_block": lambda: (jmodel.AttentionBlock(16, 8, headdim=4),
                                model.AttentionBlock(16, 8, headdim=4), rand(2, 16, 4, 4)),
    "block_residual_features": lambda: (jmodel.Block(16, 12, 4), model.Block(16, 12, 4),
                                        rand(2, 8, 8, 8), rand(2, 8, 8, 8, seed=1),
                                        rand(2, 8, 8, 8, seed=2)),
    "block_bimamba": lambda: (jmodel.Block(16, 12, 4, linear_attn_duality=False),
                              model.Block(16, 12, 4, linear_attn_duality=False),
                              rand(2, 16, 8, 8)),
}


# the attention map reaches EncoderToDecoder in fp32 beside a bf16 skip
FP32_INPUTS = {"encoder_to_decoder_fp32_map": (1,)}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_in_bf16_matches_jax_in_bf16(name):
    """Each layer's bf16 output against the JAX module's in bf16, dtypes
    included; the channel-attention maps and the VSSD mixer's output are
    fp32 from bf16 inputs, as in JAX."""
    check_bf16(*LAYERS[name](), fp32_inputs=FP32_INPUTS.get(name, ()))


def test_k1_weight_gradient_reaches_the_fp32_weight_in_fp32():
    """K1 on bf16 x with its fp32 weight: dx in bf16, dw in fp32 as JAX's
    VJP through ``astype`` gives it, both from the same bf16 x and dy."""
    x, dy = rand(2, 8, 6, 5) + 1, rand(2, 8, 6, 5, seed=1)
    w = np.random.RandomState(2).uniform(0.6, 1.4, 8).astype(np.float32)
    jm = jlayers.RMSNorm(8)
    _, vjp = jax.vjp(lambda p, v: jm.apply({"params": {"weight": p}}, v), jnp.asarray(w),
                     jnp.asarray(nhwc(x)).astype(jnp.bfloat16))
    dw_want, dx_want = vjp(jnp.asarray(nhwc(dy)).astype(jnp.bfloat16))
    pm = layers.RMSNorm(8, axis=1)
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(w))
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    pm(tx).backward(torch.from_numpy(dy).bfloat16())
    assert pm.weight.grad.dtype == torch.float32 and tx.grad.dtype == torch.bfloat16
    assert dw_want.dtype == jnp.float32
    np.testing.assert_allclose(pm.weight.grad.numpy(), np.asarray(dw_want), rtol=1e-5, atol=1e-6)
    assert rel(tx.grad.float().numpy(), nchw(dx_want.astype(jnp.float32))) <= BF16_ROUNDING


def test_gates_are_rounded_to_bf16_as_in_jax():
    """A gate of 1 + 2^-10 is 1.0 in bf16: JAX rounds it before the multiply
    (``gate_cast``); torch's own promotion would multiply by the fp32
    value."""
    g = layers.Swish(beta_init=1.0 + 2.0 ** -10)
    x = torch.full((1, 1, 1, 4), 3.0, dtype=torch.bfloat16)
    assert torch.equal(g(x), x * torch.sigmoid(x))


# -- (c) K2's plain version in bf16 -------------------------------------------

def scan_case(b, h, l, carry, seed):
    """x (B, H, P, L), dt, A, B, C, D at the model's scales, or with |dA|
    about 3e-4 where the carried state dominates y."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, 4, l)
    if carry:
        dt, A = 0.005 + 0.01 * rng.rand(b, h, l), -(0.01 + 0.04 * rng.rand(h))
    else:
        dt, A = np.logaddexp(0, rng.randn(b, h, l) - 4), -np.exp(rng.rand(h) * 2.77)
    B, C = rng.randn(b, 16, l), rng.randn(b, 16, l)
    D = 0.5 + rng.rand(h)
    return [np.asarray(t, np.float32) for t in (x, dt, A, B, C, D)]


def jax_scan_layout(x, dt, A, B, C, D):
    """The port's (B, H, P, L) layout as the JAX scan's (B, L, H, P)."""
    return (jnp.moveaxis(x, -1, 1), jnp.moveaxis(dt, -1, 1), A, jnp.moveaxis(B, -1, 1),
            jnp.moveaxis(C, -1, 1), D)


def round_bf16(arrays):
    return [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)) for a in arrays]


# (batch, heads, L, chunk): 16 chunks, so the carried state crosses 15 of them
K2_SHAPE = (2, 4, 1024, 64)


@functools.cache
def jax_scan_grads(dtype):
    """y and the six gradients of JAX's ``ssd_chunked_scan`` in ``dtype``
    for (x, dt, A, B, C, D, dy) in the port's layout, jitted once per dtype."""
    def grads(*arrays):
        *a, g = [t.astype(dtype) for t in arrays]
        x, dt, A, B, C, D = jax_scan_layout(*a)
        y, vjp = jax.vjp(lambda *v: jssd.ssd_chunked_scan(*v, chunk_size=K2_SHAPE[3]),
                         x, dt, A, B, C, D)
        dx, ddt, dA, dB, dC, dD = vjp(jnp.moveaxis(g, -1, 1))
        back = [jnp.moveaxis(t, 1, -1) for t in (y, dx, ddt)] + [dA] + \
            [jnp.moveaxis(t, 1, -1) for t in (dB, dC)] + [dD]
        return [t.astype(jnp.float32) for t in back]  # y dx ddt dA dB dC dD

    return jax.jit(grads)


@pytest.mark.parametrize("carry", [False, True], ids=["model_scales", "small_dA_carry"])
def test_k2_plain_version_in_bf16_matches_jax(carry):
    """Forward and backward of K2's plain version on bf16 inputs, over 16
    chunks, at the model's scales and with |dA| about 3e-4 (the carried
    state dominates): against JAX's bf16 ``ssd_chunked_scan`` and its
    ``jax.vjp`` by the yardstick, and against JAX in fp32 on the same
    bf16-rounded inputs within one bf16 rounding of each output (the plain
    version computes in fp32 and rounds once)."""
    b, h, l, q = K2_SHAPE
    ins = scan_case(b, h, l, carry, seed=int(carry))
    dy = np.random.RandomState(1).randn(b, h, 4, l).astype(np.float32)
    rounded = round_bf16(ins + [dy])
    j16, j32, j32_rounded = ([np.asarray(t) for t in jax_scan_grads(dtype)(*arrays)]
                             for dtype, arrays in ((jnp.bfloat16, ins + [dy]),
                                                   (jnp.float32, ins + [dy]),
                                                   (jnp.float32, rounded)))
    t16 = [torch.from_numpy(a).bfloat16() for a in ins + [dy]]
    y = ssd.ssd_chunked_scan(*t16[:6], chunk_size=q)
    grads = ssd.ssd_chunked_scan_backward(*t16, chunk_size=q)
    port = [t.float().numpy() for t in (y, *grads)]
    assert all(t.dtype == torch.bfloat16 for t in (y, *grads))
    for name, p, w16, w32, wr in zip(("y", "dx", "ddt", "dA", "dB", "dC", "dD"), port, j16,
                                     j32, j32_rounded):
        d = rel(w16, w32)
        assert rel(p, w16) <= max(2 * d, BF16_ROUNDING), (name, rel(p, w16), d)
        scale = np.abs(wr).max()
        assert np.all(np.abs(p - wr) <= BF16_ROUNDING * np.abs(wr) + 1e-5 * scale), name


def test_k2_takes_one_dtype():
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in scan_case(1, 2, 64, False, 0))
    with pytest.raises(TypeError, match="one dtype"):
        ssd.ssd_chunked_scan(x.bfloat16(), dt, A, B, C, D)
    with pytest.raises(TypeError, match="one dtype"):
        ssd.ssd_chunked_scan_backward(*(t.bfloat16() for t in (x, dt, A, B, C, D)), x)


# -- (d) the whole model ----------------------------------------------------

@pytest.mark.parametrize("config", ["duality", "bimamba"])
def test_whole_model_in_bf16_matches_jax(config, narrow_params):
    """NARROW at 32^2: the port in bf16 within 2 d of JAX in bf16 and 1.5 d
    of JAX in fp32, d being JAX's own bf16-vs-fp32 distance (1.09e-2
    duality, 1.63e-2 bimamba)."""
    kw = CONFIGS[config]
    jm = jmodel.ADNMUNet(**NARROW, **kw)
    x = jnp.asarray(frames(1, 32))

    def both(p, v):
        return (jm.apply({"params": p}, v, train=False),
                jm.apply({"params": p}, v.astype(jnp.bfloat16), train=False))

    j32, j16 = (np.asarray(t.astype(jnp.float32)) for t in jax.jit(both)(
        jax.tree.map(jnp.asarray, params_of(narrow_params, config)), x))
    pm = model.ADNMUNet(**NARROW, **kw)
    convert.from_jax_params(pm, params_of(narrow_params, config))
    with torch.no_grad():
        p16 = pm(torch.from_numpy(frames(1, 32)).bfloat16())
    assert p16.dtype == torch.bfloat16
    d = rel(j16, j32)
    assert 2 ** -9 < d < 0.05, d
    assert rel(p16.float().numpy(), j16) <= 2 * d, (rel(p16.float().numpy(), j16), d)
    assert rel(p16.float().numpy(), j32) <= 1.5 * d, (rel(p16.float().numpy(), j32), d)


def test_vssd_bimamba_refuses_bf16_before_any_work():
    kw = dict(linear_attn_duality=False, mixer_type="vssd")
    with pytest.raises(TypeError, match="float32 only"):
        model.ADNMUNet(**NARROW, **kw)(torch.zeros(1, 5, 1, 32, 32, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="float32 only"):
        Trainer(model.ADNMUNet(**NARROW, **kw), get_preset("ADNMUnet", 5, 20, 6, "Shanghai"),
                5, CPU, compute_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32 only"):
        predict.load_model(None, CPU, compute_dtype=torch.bfloat16, **kw)


# -- the trainer's wire formats ----------------------------------------------

def test_split_batch_matches_the_jax_trainer_in_bf16():
    """uint8 frames cast to bf16 and scaled by bf16(1/255), float frames
    cast, targets fp32: the JAX trainer's ``_split_batch`` bit for bit."""
    rng = np.random.RandomState(0)
    wire = {"uint8": rng.randint(0, 256, (2, 7, 1, 8, 8)).astype(np.uint8),
            "float32": rng.rand(2, 7, 1, 8, 8).astype(np.float32)}
    jt = JTrainer.__new__(JTrainer)  # _split_batch reads only these two
    jt.input_frames, jt.compute_dtype = 5, jnp.bfloat16
    pt = Trainer.__new__(Trainer)
    pt.input_frames, pt.compute_dtype = 5, torch.bfloat16
    for name, batch in wire.items():
        want = [np.asarray(t.astype(jnp.float32)) for t in jt._split_batch(jnp.asarray(batch))]
        got = pt._split_batch(torch.from_numpy(batch))
        assert [t.dtype for t in got] == [torch.bfloat16, torch.float32], name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.float().numpy(), w, err_msg=name)


# -- (f) the CLIs --------------------------------------------------------------

CLI_ARGS = ["--synthetic", "--synthetic-len", "8", "--img-size", "32", "--batch-size", "2",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def bf16_run(tmp_path_factory):
    """One bf16 epoch of the full-width model through the train CLI, with its
    epoch snapshot."""
    root = str(tmp_path_factory.mktemp("bf16_run"))
    out = train_cli.main([*CLI_ARGS, "--bf16", "--epochs", "1", "--save-every", "1",
                          "--root", root])
    snapshot = ckpt.best_ckpt_dir(root, "Shanghai", "ADNMUnet") + "_epoch1"
    yield root, out, snapshot
    shutil.rmtree(root)  # after the module's last test: the snapshot is 851 MB


def test_train_cli_trains_in_bf16_with_fp32_parameters_and_adamw_state(bf16_run):
    _, out, snapshot = bf16_run
    trainer, (log,) = out["trainer"], out["logs"]
    assert trainer.compute_dtype == torch.bfloat16 and trainer.step == 2
    assert all(p.dtype == torch.float32 for p in trainer.params)
    state = trainer.optimizer.state_dict()["state"]
    assert state and all(v.dtype == torch.float32 for s in state.values() for k, v in s.items()
                         if k != "step")
    assert np.isfinite([log.train_loss, log.val_loss, out["test_loss"]]).all()
    assert os.path.exists(snapshot)
    params = ckpt.restore_state(snapshot, {"params": {}})["params"]
    assert all(v.dtype == torch.float32 for v in params.values())


def test_validate_and_visualize_clis_run_in_bf16(bf16_run, tmp_path):
    root, _, snapshot = bf16_run
    val = validate_cli.main([*CLI_ARGS, "--bf16", "--root", root, "--ckpt", snapshot])
    assert val["trainer"].compute_dtype == torch.bfloat16
    assert val["preds"].dtype == np.float32 and np.isfinite(val["preds"]).all()
    assert all(np.isfinite(m["TP"]) for m in val["metrics"]["threshold_metrics"].values())
    written = visualize_cli.main([*CLI_ARGS, "--bf16", "--root", root, "--ckpt", snapshot,
                                  "--out", str(tmp_path / "vis"), "--max-samples", "1"])
    assert len(written) == 1 and os.path.exists(os.path.join(written[0], "ADNMUnet.png"))


def test_predict_cli_serves_a_bf16_snapshot_in_both_dtypes(bf16_run, tmp_path):
    """The bf16-trained snapshot (fp32 parameters) served with --bf16 and in
    fp32: fp32 predictions both, the chained rollout too, within the
    whole model's bf16-vs-fp32 distance of each other."""
    root, _, snapshot = bf16_run
    x = np.random.RandomState(0).rand(5, 32, 32).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    runs = {}
    for label, extra in (("bf16", ["--bf16", "--horizon", "30"]), ("fp32", [])):
        runs[label] = predict.main(["--input", str(tmp_path / "x.npy"), "--output",
                                    str(tmp_path / f"{label}.npy"), "--img-size", "32",
                                    "--device", "cpu", "--ckpt", snapshot, *extra])
        assert runs[label].dtype == np.float32 and np.isfinite(runs[label]).all()
    assert runs["bf16"].shape == (1, 30, 1, 32, 32) and runs["fp32"].shape == (1, 20, 1, 32, 32)
    assert rel(runs["bf16"][:, :20], runs["fp32"]) < 0.05


def test_an_fp32_checkpoint_serves_and_trains_in_bf16(tmp_path):
    """The reverse: a checkpoint of an fp32 trainer loads into a bf16 one,
    which trains a step and predicts in fp32 from bf16 activations."""
    tiny = dict(embed_dim=(8,) * 6, refine_dim=(8,) * 4, wt_levels=(1, 1, 1), channels=5,
                out_channels=2, kernel=(3, 3, 3), headdim=2, refine_headdim=(2,) * 4)
    preset = get_preset("ADNMUnet", 5, 2, 6, "Shanghai")
    t32 = Trainer(model.ADNMUNet(**tiny), preset, 5, CPU, seed=0)
    path = str(tmp_path / "fp32")
    ckpt.save_state(path, t32.state_dict())
    t16 = Trainer(model.ADNMUNet(**tiny), preset, 5, CPU, seed=1, compute_dtype=torch.bfloat16)
    t16.load(path)
    for a, b in zip(t16.params, t32.params):
        assert torch.equal(a, b)
    batch = torch.from_numpy(np.random.RandomState(0).rand(2, 7, 1, 32, 32).astype(np.float32))
    loss, gnorm = t16.train_step(batch, 1e-3, 0.025)
    assert np.isfinite([float(loss), float(gnorm)]).all()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in t16.params)
    _, out = t16.eval_step(batch)
    assert out.dtype == torch.float32 and out.shape == (2, 2, 1, 32, 32)
