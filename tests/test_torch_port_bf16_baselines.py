"""The six baselines of the PyTorch port in bf16 compute (the JAX package's
``--bf16``) against the JAX package in bf16, on the CPU: every module
output's dtype, the eval forward, one training step, BatchNorm's running
statistics, Dropout and DropPath in bf16, the CLIs with ``--bf16``, and
TrajGRU's warp of a one-pixel state (its deepest stage at 32^2).

The JAX package's bf16 is bf16 only up to its first fp32 parameter or
array in plain arithmetic, which promotes the activation: SmaAt-UNet's up
path after the fp32 interpolation matrices, ConvLSTM and TrajGRU after
their fp32 zero states, LPTQPN after its first attention's fp32
temperature, TransUnet after the fp32 position embeddings, SwinUnet after
its first flax LayerNorm. The port reproduces each site, module by module
(``capture_intermediates`` against forward hooks).

Sizes: every model at 32^2, 5 -> 3 frames; LPTQPN with one block per
level (``LPTQPN_SMALL``), TransUnet with ``TRANS_SMALL``'s ViT, the others
at full width; the training step with the dropout and DropPath rates at 0
on both sides. Every JAX parameter (and running statistic) is drawn with
numpy and carried into the port by ``convert.from_jax_params``; each JAX
model's bf16 step is compiled once per module, its forward's output the
step's.

Tolerances (``test_torch_port_bf16.py``'s yardstick): d, the L2 distance
between JAX in bf16 and fp32 on the same inputs, the fp32 end taken from
the port (held to JAX's fp32 within 1e-5 by the fp32 tests, which spares a
second compile a model); the port in bf16 within 2 d of JAX in bf16, never
below one bf16 rounding (2^-8 of the norm): the train-mode forward, the
step's loss and its whole gradient; BatchNorm's new running statistics
likewise, and fp32.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from adnm_tpu.models import lptqpn as jlptqpn
from adnm_tpu.models import registry as jregistry
from adnm_tpu.models import traj_gru as jtraj
from adnm_tpu.models import trans_unet as jtrans
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import predict
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.cli import validate as validate_cli
from adnm_tpu_torch.cli import visualize as visualize_cli
from adnm_tpu_torch.core import stochastic
from adnm_tpu_torch.models import registry, traj_gru, trans_unet
from adnm_tpu_torch.models.lptqpn import LPTQPN
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_baselines import LPTQPN_SMALL
from test_torch_port_bf16 import BF16_ROUNDING, dtype_name, port_call_dtypes
from test_torch_port_last_baselines import TRANS_SMALL, JaxSwinUnetRates0, narrow_clis  # noqa
from test_torch_port_layers import _draw, one_torch_thread  # noqa: F401 (a fixture)
from test_train_modes import _batches

CPU = torch.device("cpu")
SIZE = 32
T_OUT = 3
NAMES = ("SmaATUnet", "ConvLSTM", "TrajGRU", "LPTQPN", "TransUnet", "SwinUnet")
# the port's modules that flax does not capture under the same name: the
# cells JAX scans over time (``nn.scan``), and Dropout and DropPath, which
# flax names by their class
UNCAPTURED = (".cell", "drop")
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def jax_model(name: str):
    if name == "LPTQPN":
        return jlptqpn.LPTQPN(5, T_OUT, **LPTQPN_SMALL)
    if name == "TransUnet":
        return jtrans.TransUnet(T_OUT, img_size=SIZE, dropout=0.0, **TRANS_SMALL)
    if name == "SwinUnet":
        return JaxSwinUnetRates0(T_OUT, SIZE)
    return jregistry.create_model(name, 5, T_OUT, 6, img_size=SIZE)


def port_model(name: str):
    if name == "LPTQPN":
        return LPTQPN(5, T_OUT, **LPTQPN_SMALL)
    if name == "TransUnet":
        return trans_unet.TransUnet(T_OUT, img_size=SIZE, **TRANS_SMALL)
    return registry.create_model(name, 5, T_OUT, 6, img_size=SIZE)


def loaded(name: str, c: dict):
    m = stochastic.zero_rates(port_model(name))
    return convert.from_jax_params(m, c["params"], c["stats"] or None)


def fast_compiled(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's lowest backend optimisation
    level: half the compile time of these small CPU programs."""
    return jax.jit(fn).lower(*args).compile(FAST_COMPILE)(*args)


def random_variables(jm) -> tuple:
    """``random_params``' params and ``random_stats``' batch_stats, the same
    draws, from one shape evaluation of the init."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 5, 1, SIZE, SIZE)), train=False))
    rng = np.random.RandomState(0)
    params = convert.unflatten_tree({
        k: _draw(rng, k.rsplit("/", 1)[-1], v.shape)
        for k, v in convert.flatten_tree(jax.tree.map(
            lambda a: np.zeros(a.shape, np.float32), dict(shapes["params"]))).items()})
    flat = convert.flatten_tree(jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                             dict(shapes.get("batch_stats", {}))))
    rng = np.random.RandomState(1)
    stats = convert.unflatten_tree({
        k: (rng.uniform(-0.5, 0.5, v.shape) if k.endswith("mean")
            else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32) for k, v in flat.items()})
    return params, stats


_CASES: dict = {}


def case(name: str) -> dict:
    """Params, batch_stats, a batch of two clips, and from one JAX compile
    the bf16 training step (the JAX trainer's ``_grads_impl``: the inputs
    cast to bf16, the preset's loss on the fp32 output, batch_stats
    mutable): its loss, gradients, new running statistics and the
    train-mode forward's output."""
    if name not in _CASES:
        jm = jax_model(name)
        params, stats = random_variables(jm)
        (batch,) = _batches(1, 1, frames=5 + T_OUT, size=SIZE)
        loss_of = jget_preset(name, 5, T_OUT, 6, "Shanghai").loss_fn

        def step(p, bs, b):
            imgs, targets = b[:, :5].astype(jnp.bfloat16), b[:, 5:]

            def loss_fn(q):
                if bs:
                    o, mut = jm.apply({"params": q, "batch_stats": bs}, imgs, train=True,
                                      mutable=["batch_stats"])
                    return loss_of(o.astype(jnp.float32), targets), (o, mut["batch_stats"])
                o = jm.apply({"params": q}, imgs, train=True)
                return loss_of(o.astype(jnp.float32), targets), (o, bs)

            return jax.value_and_grad(loss_fn, has_aux=True)(p)

        (loss, (out, new_bs)), grads = fast_compiled(
            step, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats),
            jnp.asarray(batch))
        _CASES[name] = dict(params=params, stats=stats, batch=batch, jm=jm,
                            fwd=np.asarray(out.astype(jnp.float32)), fwd_dtype=dtype_name(out),
                            loss=float(loss), grads=convert.flatten_tree(jax.device_get(grads)),
                            new_stats=convert.flatten_tree(jax.device_get(new_bs)))
    return _CASES[name]


def check_distance(what: str, got, w16, w32):
    """||got - w16|| <= max(2 ||w16 - w32||, 2^-8 ||w16||)."""
    got, w16, w32 = (np.asarray(a, np.float64).ravel() for a in (got, w16, w32))
    d, e = np.linalg.norm(w16 - w32), np.linalg.norm(got - w16)
    assert e <= max(2 * d, BF16_ROUNDING * np.linalg.norm(w16)), (what, e, d)


def vector(flat: dict, keys) -> np.ndarray:
    return np.concatenate([np.ravel(np.asarray(flat[k], np.float64)) for k in keys])


def port_step(name: str, c: dict, dtype: torch.dtype) -> tuple:
    """The port's loss, gradients (JAX layout) and new running statistics of
    the step in ``dtype``."""
    t = Trainer(loaded(name, c), get_preset(name, 5, T_OUT, 6, "Shanghai"), 5, CPU, seed=0,
                compute_dtype=dtype)
    loss, grads = t.grads(c["batch"])
    assert all(g.dtype == torch.float32 for g in grads.values())
    return (float(loss), convert.flatten_tree(convert.to_jax_params(t.model, grads)),
            convert.flatten_tree(convert.to_jax_batch_stats(t.model)))


# -- dtypes ----------------------------------------------------------------------

def jax_module_dtypes(name: str, c: dict) -> dict:
    """{module path: sorted output dtypes} of the JAX eval forward in bf16,
    from flax's captured intermediates (shapes only, no compile)."""
    jm = c["jm"]
    v = {"params": jax.tree.map(jnp.asarray, c["params"])}
    if c["stats"]:
        v["batch_stats"] = jax.tree.map(jnp.asarray, c["stats"])

    def run(v, x):
        return jm.apply(v, x, train=False, mutable=["intermediates"],
                        capture_intermediates=lambda mdl, method: method == "__call__")

    _, state = jax.eval_shape(run, v, jnp.zeros((1, 5, 1, SIZE, SIZE), jnp.bfloat16))
    out = {}

    def walk(tree, path):
        for k, sub in tree.items():
            if k == "__call__":
                out[".".join(path)] = sorted({dtype_name(leaf) for call in sub
                                              for leaf in jax.tree_util.tree_leaves(call)})
            else:
                walk(sub, path + [k])

    walk(state["intermediates"], [])
    return out


@pytest.mark.parametrize("name", NAMES)
def test_every_module_output_has_the_dtype_flax_gives_it(name):
    c = case(name)
    want = jax_module_dtypes(name, c)
    got = {k: sorted({t for call in calls for t in call})
           for k, calls in port_call_dtypes(loaded(name, c).eval(),
                                            torch.zeros(1, 5, 1, SIZE, SIZE,
                                                        dtype=torch.bfloat16)).items()}
    unmatched = [n for n in got if n not in want]
    assert all(any(u in n for u in UNCAPTURED) for n in unmatched), unmatched
    assert all("Dropout_" in n for n in want if n not in got)
    compared = {n: got[n] for n in got if n in want}
    assert {n: want[n] for n in compared} == compared
    assert got[""] == ["float32"]  # every model's output is fp32 in JAX's bf16
    assert {t for ts in compared.values() for t in ts} == {"bfloat16", "float32"}


# -- values ------------------------------------------------------------------------
# d's fp32 end is the port's fp32 step: the fp32 tests hold it to JAX's
# fp32 within 1e-5 (test_torch_port_{train_,last_,}baselines.py), two
# orders below a bf16 distance, and it spares a second JAX compile a model.

@pytest.mark.parametrize("name", NAMES)
def test_bf16_forward_matches_jax_in_bf16(name):
    """The train-mode forward (BatchNorm on the batch's statistics; no
    dropout): fp32 out, as JAX's."""
    c = case(name)
    x = torch.from_numpy(c["batch"][:, :5])
    with torch.no_grad():
        got = loaded(name, c).train()(x.bfloat16())
        ref = loaded(name, c).train()(x)
    assert dtype_name(got) == c["fwd_dtype"] == "float32"
    check_distance("forward", got.numpy(), c["fwd"], ref.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_bf16_training_step_matches_jax_in_bf16(name):
    """The ``Trainer`` in bf16 compute (fp32 parameters and gradients): the
    loss, the whole gradient and, for the BatchNorm models, the new running
    statistics, which stay fp32."""
    c = case(name)
    loss, grads, stats = port_step(name, c, torch.bfloat16)
    loss32, grads32, stats32 = port_step(name, c, torch.float32)
    assert grads.keys() == c["grads"].keys()
    check_distance("loss", loss, c["loss"], loss32)
    keys = sorted(c["grads"])
    check_distance("gradient", vector(grads, keys), vector(c["grads"], keys),
                   vector(grads32, keys))
    assert bool(stats) == bool(c["stats"])
    if stats:
        assert all(v.dtype == np.float32 for v in stats.values())
        keys = sorted(c["new_stats"])
        check_distance("running statistics", vector(stats, keys), vector(c["new_stats"], keys),
                       vector(stats32, keys))


@pytest.mark.parametrize("h,w", [(1, 1), (1, 3), (4, 1)])
def test_trajgru_warp_of_a_one_pixel_axis_matches_jax(h, w):
    """TrajGRU's deepest state is 1 x 1 at 32^2 frames; ``grid_sample``'s
    grid has no spacing on an axis of one pixel, which the port pads with a
    zero pixel: the warp and its gradients as JAX's four-gather form (rtol
    1e-5, atol 1e-6, as ``test_torch_port_baselines.py``'s warp test)."""
    rng = np.random.RandomState(0)
    img = rng.randn(3, 2, h, w).astype(np.float32)
    flow = rng.uniform(-1.5, 1.5, (3, h, w, 2)).astype(np.float32)
    jimg = jnp.asarray(img.transpose(0, 2, 3, 1))
    want = np.asarray(jtraj.bilinear_warp(jimg, jnp.asarray(flow))).transpose(0, 3, 1, 2)
    dimg, dflow = jax.grad(lambda a, f: jtraj.bilinear_warp(a, f).sum(), (0, 1))(
        jimg, jnp.asarray(flow))
    timg, tflow = (torch.from_numpy(a).requires_grad_() for a in (img, flow))
    got = traj_gru.bilinear_warp(timg, tflow)
    got.sum().backward()
    for g, w_ in ((got.detach(), want), (timg.grad, np.asarray(dimg).transpose(0, 3, 1, 2)),
                  (tflow.grad, np.asarray(dflow))):
        np.testing.assert_allclose(g.numpy(), w_, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["Dropout", "DropPath"])
def test_dropout_and_droppath_scale_in_the_activation_dtype(kind):
    """In bf16 a kept value is ``x / keep`` rounded in bf16, as flax's
    ``nn.Dropout`` (and JAX's DropPath) compute it."""
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 32).astype(np.float32)).bfloat16()
    layer = getattr(stochastic, kind)(0.3).train()
    layer.generator = torch.Generator().manual_seed(0)
    y = layer(x)
    assert y.dtype == torch.bfloat16
    kept = y != 0
    assert 0 < int(kept.sum()) < x.numel()
    torch.testing.assert_close(y[kept], (x / 0.7)[kept], rtol=0, atol=0)
    jy = nn.Dropout(0.3, deterministic=False).apply({}, jnp.asarray(x.float().numpy(),
                                                                    jnp.bfloat16),
                                                    rngs={"dropout": jax.random.PRNGKey(0)})
    jkept = np.asarray(jy.astype(jnp.float32)) != 0
    assert jy.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jy.astype(jnp.float32))[jkept],
        np.asarray((jnp.asarray(x.float().numpy(), jnp.bfloat16) / 0.7)
                   .astype(jnp.float32))[jkept])


# -- the CLIs ------------------------------------------------------------------

def cli_args(name: str, root) -> list:
    return ["--model", name, "--synthetic", "--synthetic-len", "8", "--img-size", str(SIZE),
            "--batch-size", "2", "--device", "cpu", "--root", str(root), "--bf16"]


@pytest.mark.parametrize("name", ["SmaATUnet", "TransUnet"])
def test_clis_train_validate_visualize_and_predict_in_bf16(name, tmp_path, narrow_clis):
    """A BatchNorm model (SmaAt-UNet) and TransUnet (narrowed) with --bf16:
    fp32 parameters, optimizer state and running statistics in the
    checkpoint; predict serves it in bf16 with fp32 predictions."""
    out = train_cli.main(cli_args(name, tmp_path) + ["--epochs", "1", "--no-final-eval"])
    t = out["trainer"]
    assert t.compute_dtype == torch.bfloat16 and np.isfinite(out["logs"][0].train_loss)
    assert all(p.dtype == torch.float32 for p in t.model.parameters())
    assert all(b.dtype == torch.float32 for b in t.model.buffers())
    ckpt = best_ckpt_dir(str(tmp_path), "Shanghai", name)
    val = validate_cli.main(cli_args(name, tmp_path) + ["--ckpt", ckpt])
    assert val["preds"].dtype == np.float32 and np.isfinite(val["test_loss"])
    written = visualize_cli.main(cli_args(name, tmp_path) + [
        "--ckpt", ckpt, "--out", str(tmp_path / "pics"), "--max-samples", "1"])
    assert written
    x = tmp_path / "x.npy"
    np.save(x, val["gts"][0, :5])
    served = predict.main(["--model", name, "--input", str(x), "--img-size", str(SIZE),
                           "--device", "cpu", "--ckpt", ckpt, "--bf16",
                           "--output", str(tmp_path / "y.npy")])
    assert served.dtype == np.float32 and os.path.exists(tmp_path / "y.npy")
    model = predict.load_model(None, "cpu", ckpt=ckpt, model_name=name, img_size=SIZE,
                               compute_dtype=torch.bfloat16)
    with torch.no_grad():
        want = model(torch.from_numpy(val["gts"][:1, :5, None]).bfloat16()).float().numpy()
    np.testing.assert_array_equal(served, want)
