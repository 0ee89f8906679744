"""The port's four baselines (SmaAt-UNet, ConvLSTM, TrajGRU, LPTQPN) against
the JAX package, on the CPU at small sizes: BatchNorm, the TrajGRU warp,
SmaAt's upsample, LPTQPN's pixel (un)shuffle, each model's forward, the
reference importers and the registry.

Every JAX parameter (and SmaAt's running statistics) is drawn with numpy
from a seed and carried into the port by ``convert.from_jax_params``.
Sizes: SmaAt and LPTQPN at 32^2 (LPTQPN with one block per level and one
refinement block), ConvLSTM and TrajGRU at 64^2; 5 frames in, 20 out.
Each JAX model is built and compiled once per module.

Tolerances, fp32 on both sides with sums in other orders:
  * a model's forward within 1e-5 relative L2 and 1e-5 of the output's
    largest entry (measured 1e-7..5e-7);
  * BatchNorm's outputs and running statistics rtol 1e-5, atol 1e-6 (the
    port's variance is JAX's E[x^2] - E[x]^2 in another order);
  * the warp: rtol 1e-5, atol 1e-6 against JAX's four-gather form (the
    port unnormalises a [-1, 1] grid, JAX adds the flow to the pixel
    index); its gradients against ``jax.vjp`` and against ``grid_sample``'s
    own backward, rtol 1e-5, atol 1e-5;
  * the upsample within 1e-6 of JAX (both interpolation-matrix products at
    fp32) and of ``F.interpolate``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adnm_tpu.core import layers as jlayers
from adnm_tpu.models import lptqpn as jlptqpn
from adnm_tpu.models import registry as jregistry
from adnm_tpu.models import smaat_unet as jsmaat
from adnm_tpu.models import traj_gru as jtraj
from adnm_tpu.train import torch_import as jimport
from adnm_tpu_torch import convert
from adnm_tpu_torch.core import layers
from adnm_tpu_torch.models import registry, smaat_unet, traj_gru
from adnm_tpu_torch.models.lptqpn import LPTQPN
from adnm_tpu_torch.train import checkpoint as ckpt
from adnm_tpu_torch.train import torch_import
from test_torch_port_layers import nchw, nhwc, one_torch_thread, random_params  # noqa: F401

SIZES = {"SmaATUnet": 32, "ConvLSTM": 64, "TrajGRU": 64, "LPTQPN": 32}
LPTQPN_SMALL = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
FWD_RTOL = 1e-5  # relative L2, and of the largest |entry|


def jax_model(name: str):
    if name == "LPTQPN":
        return jlptqpn.LPTQPN(5, 20, **LPTQPN_SMALL)
    return jregistry.create_model(name, 5, 20, 6, img_size=SIZES[name])


def port_model(name: str):
    if name == "LPTQPN":
        return LPTQPN(5, 20, **LPTQPN_SMALL)
    return registry.create_model(name, 5, 20, 6, img_size=SIZES[name])


def random_stats(jm, x, seed: int = 1):
    """A batch_stats tree for ``jm`` (empty without BatchNorm): means in
    [-0.5, 0.5], variances in [0.5, 2]."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, train=True))
    flat = convert.flatten_tree(jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                             dict(shapes.get("batch_stats", {}))))
    rng = np.random.RandomState(seed)
    return convert.unflatten_tree({
        k: (rng.uniform(-0.5, 0.5, v.shape) if k.endswith("mean")
            else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32) for k, v in flat.items()})


_CASES: dict = {}


def case(name: str) -> dict:
    """The JAX model, its params and batch_stats, an input and the JAX eval
    forward, built once per module."""
    if name not in _CASES:
        s = SIZES[name]
        jm = jax_model(name)
        x = np.random.RandomState(0).rand(2, 5, 1, s, s).astype(np.float32)
        params = random_params(jm, jnp.zeros((1, 5, 1, s, s)), train=False)
        stats = random_stats(jm, jnp.zeros((1, 5, 1, s, s)))
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(x))
        _CASES[name] = dict(params=params, stats=stats, x=x, want=np.asarray(want))
    return _CASES[name]


def assert_close_rel(got: np.ndarray, want: np.ndarray, rtol: float = FWD_RTOL):
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= rtol, f"relative L2 error {err:.3e}"
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def forward(model: torch.nn.Module, x: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x)).numpy()


# -- layers -------------------------------------------------------------------

def test_batchnorm_matches_jax_in_train_and_eval_mode():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 6, 5, 7) * 2 + 1).astype(np.float32)  # NCHW, a mean away from 0
    params = {"weight": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.uniform(-0.3, 0.3, 6).astype(np.float32)}
    stats = {"mean": rng.uniform(-0.5, 0.5, 6).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    jm = jlayers.BatchNorm(6)
    variables = {"params": params, "batch_stats": stats}
    want_train, mut = jm.apply(variables, jnp.asarray(nhwc(x)), train=True,
                               mutable=["batch_stats"])
    want_eval = jm.apply(variables, jnp.asarray(nhwc(x)), train=False)

    bn = convert.from_jax_params(layers.BatchNorm(6), params, stats)
    assert {k for k, _ in bn.named_buffers()} == {"mean", "var"}
    with torch.no_grad():
        got_eval = bn.eval()(torch.from_numpy(x)).numpy()
        got_train = bn.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_eval, nchw(want_eval), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_train, nchw(want_train), rtol=1e-5, atol=1e-6)
    new = convert.to_jax_batch_stats(bn)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k], np.asarray(mut["batch_stats"][k]), rtol=1e-5,
                                   atol=1e-6)
    # the running statistics are torch's (biased variance to normalise, the
    # unbiased one into the running variance, momentum 0.1)
    ref = torch.nn.BatchNorm2d(6, eps=1e-5, momentum=0.1)
    with torch.no_grad():
        ref.running_mean.copy_(torch.from_numpy(stats["mean"]))
        ref.running_var.copy_(torch.from_numpy(stats["var"]))
        ref.weight.copy_(torch.from_numpy(params["weight"]))
        ref.bias.copy_(torch.from_numpy(params["bias"]))
        np.testing.assert_allclose(ref.train()(torch.from_numpy(x)).numpy(), got_train,
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ref.running_mean, bn.mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ref.running_var, bn.var, rtol=1e-5, atol=1e-6)


# (flow, frame height, width) of each case. At integer flows every sample
# sits on a kink of the bilinear weights, where the flow gradient is a
# one-sided derivative: JAX's floor(arange + flow) takes the right one; the
# port unnormalises the [-1, 1] grid of grid_sample, whose rounding can put
# an integer coordinate an ulp below it, and there takes the left one. With
# H - 1 and W - 1 powers of two the port's coordinates are exact and both
# take the right one. Fractional flows, the model's case, have no kink.
FLOWS = {
    "integer": (lambda rng, shape: rng.randint(-3, 4, shape).astype(np.float32), 9, 17),
    "fractional": (lambda rng, shape: rng.uniform(-2.5, 2.5, shape).astype(np.float32), 9, 11),
    "out_of_frame": (lambda rng, shape: rng.uniform(-9.0, 9.0, shape).astype(np.float32), 9, 11),
}


@pytest.mark.parametrize("kind", sorted(FLOWS))
def test_bilinear_warp_and_its_gradients_match_jax(kind):
    """The warp at integer, fractional and out-of-frame flows: its output
    and its gradients with respect to the image and the flow against
    ``jax.vjp`` of the JAX four-gather form, and against ``grid_sample``'s
    own backward (which the port replaces by a fixed-order sum)."""
    rng = np.random.RandomState(0)
    draw, h, w = FLOWS[kind]
    img = rng.randn(3, 4, h, w).astype(np.float32)
    flow = draw(rng, (3, h, w, 2))
    ct = rng.randn(3, 4, h, w).astype(np.float32)
    want, vjp = jax.vjp(jtraj.bilinear_warp, jnp.asarray(nhwc(img)), jnp.asarray(flow))
    want_dimg, want_dflow = vjp(jnp.asarray(nhwc(ct)))

    ti = torch.from_numpy(img).requires_grad_()
    tf = torch.from_numpy(flow).requires_grad_()
    got = traj_gru.bilinear_warp(ti, tf)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), nchw(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.grad.numpy(), nchw(want_dimg), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(want_dflow), rtol=1e-5, atol=1e-5)

    ri = torch.from_numpy(img).requires_grad_()
    grid = torch.from_numpy(flow).requires_grad_()
    g = torch.stack([2 * (torch.arange(w) + grid[..., 0]) / (w - 1) - 1,
                     2 * (torch.arange(h)[:, None] + grid[..., 1]) / (h - 1) - 1], dim=-1)
    F.grid_sample(ri, g, mode="bilinear", padding_mode="zeros",
                  align_corners=True).backward(torch.from_numpy(ct))
    torch.testing.assert_close(ti.grad, ri.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(tf.grad, grid.grad, rtol=1e-5, atol=1e-5)
    if kind == "out_of_frame":
        assert (got.detach() == 0).any()  # some samples fall wholly outside


def test_upsample_matches_jax_and_interpolate():
    x = np.random.RandomState(0).randn(2, 3, 5, 7).astype(np.float32)
    got = smaat_unet.upsample_bilinear_align_corners(torch.from_numpy(x))
    want = nchw(jsmaat.upsample_bilinear_align_corners(jnp.asarray(nhwc(x)), 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    ref = F.interpolate(torch.from_numpy(x), scale_factor=2, mode="bilinear",
                        align_corners=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)


def test_pixel_shuffles_keep_the_jax_channel_order():
    x = np.random.RandomState(0).randn(2, 8, 6, 4).astype(np.float32)
    down = F.pixel_unshuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(down, nchw(jlptqpn.pixel_unshuffle(jnp.asarray(nhwc(x)))))
    up = F.pixel_shuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(up, nchw(jlptqpn.pixel_shuffle(jnp.asarray(nhwc(x)))))


# -- models -------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SIZES))
def test_forward_matches_jax(name):
    c = case(name)
    m = convert.from_jax_params(port_model(name), c["params"], c["stats"] or None)
    assert_close_rel(forward(m, c["x"]), c["want"])
    # the port's trees are the JAX ones, leaf for leaf
    back = convert.flatten_tree(convert.to_jax_params(m))
    assert back.keys() == convert.flatten_tree(c["params"]).keys()
    stats = convert.flatten_tree(convert.to_jax_batch_stats(m))
    assert stats.keys() == convert.flatten_tree(c["stats"]).keys()
    assert (name == "SmaATUnet") == bool(stats)


EXPORTS = {
    "SmaATUnet": lambda c: jimport.export_smaat_state_dict(c["params"], c["stats"]),
    "ConvLSTM": lambda c: jimport.export_convlstm_state_dict(c["params"]),
    "TrajGRU": lambda c: jimport.export_trajgru_state_dict(c["params"]),
    "LPTQPN": lambda c: jimport.export_lptqpn_state_dict(c["params"], **LPTQPN_SMALL),
}


@pytest.mark.parametrize("name", sorted(SIZES))
def test_reference_importer_matches_the_jax_forward(name):
    """JAX's export of the params (and SmaAt's running statistics) in the
    reference's layout -> the port's importer -> the port's forward equals
    the JAX forward; a missing key raises. A ConvLSTM state_dict without
    peepholes (the reference's are frozen zeros, absent) loads zeros."""
    c = case(name)
    sd = {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v))
          for k, v in EXPORTS[name](c).items()}
    kw = LPTQPN_SMALL if name == "LPTQPN" else {}
    m = torch_import.load_reference_state_dict(name, port_model(name), sd, **kw)
    assert_close_rel(forward(m, c["x"]), c["want"])
    key = next(k for k in sd if not k.endswith(("Wci", "Wcf", "Wco")))
    with pytest.raises(KeyError, match=key[len("module."):]):
        torch_import.load_reference_state_dict(
            name, port_model(name), {k: v for k, v in sd.items() if k != key}, **kw)
    if name == "ConvLSTM":
        m = torch_import.load_reference_state_dict(
            name, m, {k: v for k, v in sd.items() if not k.endswith(("Wci", "Wcf", "Wco"))})
        assert all(float(p.detach().abs().max()) == 0 for n, p in m.named_parameters()
                   if n.endswith(("Wci", "Wcf", "Wco")))


def test_registry_builds_the_ported_models_and_refuses_the_rest():
    assert set(registry.MODEL_NAMES) == set(jregistry.MODEL_NAMES)
    assert set(registry.BASELINES) == set(registry.MODEL_NAMES) - {"ADNMUnet"}
    with pytest.raises(ValueError, match="unknown model"):
        registry.create_model("UNet3D", 5, 20, 6)
    with pytest.raises(ValueError, match="only supported for ADNMUnet"):
        registry.create_model("SmaATUnet", 5, 20, 6, refiner_remat=False)
    for name, s in SIZES.items():  # bf16 compute, as JAX's --bf16: fp32 out
        m = port_model(name)
        assert not hasattr(m, "check_compute_dtype")
        with torch.no_grad():
            assert m(torch.zeros(1, 5, 1, s, s, dtype=torch.bfloat16)).dtype == torch.float32


def test_convlstm_serves_only_its_own_frame_size():
    m = registry.create_model("ConvLSTM", 5, 2, 6, img_size=64)
    with pytest.raises(ValueError, match="peephole"):
        m(torch.zeros(1, 5, 1, 32, 32))
    other = registry.create_model("ConvLSTM", 5, 2, 6, img_size=32)
    with pytest.raises(RuntimeError, match="--img-size"):
        ckpt.load_model_state(other, m.state_dict(), "ckpt")
    with pytest.raises(ValueError, match="multiple of 32"):
        registry.create_model("ConvLSTM", 5, 2, 6, img_size=48)
    # TrajGRU's parameters do not depend on the frame size
    t = registry.create_model("TrajGRU", 5, 2, 6, img_size=64)
    assert t(torch.zeros(1, 5, 1, 32, 32)).shape == (1, 2, 1, 32, 32)


def test_smaat_trains_after_serving_in_inference_mode():
    """The upsample's cached interpolation matrices are made outside
    inference mode: a forward under ``torch.inference_mode`` (as
    ``predict.forecast`` serves) and then a backward of the same shapes."""
    m = registry.create_model("SmaATUnet", 5, 2, 6, img_size=32)
    x = torch.rand(1, 5, 1, 32, 32)
    with torch.inference_mode():
        m(x)
    m(x).sum().backward()
    assert m.inc.conv1.depthwise.weight.grad is not None
