"""The PyTorch port's ADNM-UNet, Blocks, weight converter and predict CLI
against the JAX package, on the CPU.

The whole model runs at narrow widths (embed 8, refine 8, one wavelet
level) at 32^2, and at 128^2, where the JAX refiner switches to its
channel-major layout; in its bimamba configurations
(``linear_attn_duality=False``, ADN-SSD and VSSD mixers) at 32^2, where
the refiner's L = 1024 makes four chunks of the scan. Tolerance for the
whole model: rtol 1e-4 / atol 5e-5 on outputs of order 1, for fp32 sums
taken in another order through some 150 layers in a row (the measured gap
is below 1e-5). The predict CLI runs the full-width
``create_adnm_unet(5, 20, 6)`` at 32^2, and ``predict.load_model`` its
bimamba configuration.
"""

from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import predict
from adnm_tpu_torch.models import adnm_unet as model
from test_torch_port_layers import (  # noqa: F401 (one_torch_thread is a fixture)
    RTOL,
    check_nchw,
    jax_apply,
    one_torch_thread,
    rand,
    random_params,
)

MODEL_ATOL = 5e-5
REPO = pathlib.Path(__file__).resolve().parents[1]
NARROW = dict(embed_dim=(8,) * 6, refine_dim=(8,) * 4, wt_levels=(1, 1, 1),
              channels=5, out_channels=20)


def frames(b, size, seed=0):
    return np.random.RandomState(seed).rand(b, 5, 1, size, size).astype(np.float32)


@pytest.fixture(scope="module")
def narrow_params():
    return random_params(jmodel.ADNMUNet(**NARROW), jnp.asarray(frames(1, 32)), train=False)


@pytest.fixture(scope="module")
def vssd_params():
    return random_params(jmodel.ADNMUNet(**NARROW, mixer_type="vssd"), jnp.asarray(frames(1, 32)),
                         train=False)


# (mixer_type, linear_attn_duality): the configurations besides the default
SCAN_CONFIGS = [("adnssd", False), ("vssd", True), ("vssd", False)]


def test_schedule_headdim():
    assert [model.schedule_headdim(d) for d in (32, 128, 512, 768, 1024)] == [4, 8, 16, 24, 32]


@pytest.mark.parametrize("mode", ["plain", "residual_and_features"])
def test_block(mode):
    args = (rand(2, 16, 8, 8),) if mode == "plain" else \
        (rand(2, 8, 8, 8), rand(2, 8, 8, 8, seed=1), rand(2, 8, 8, 8, seed=2))
    check_nchw(jmodel.Block(16, 12, 4), model.Block(16, 12, 4), *args)


@pytest.mark.parametrize("mixer_type,duality", SCAN_CONFIGS)
def test_block_with_each_mixer_configuration(mixer_type, duality):
    kw = dict(linear_attn_duality=duality, mixer_type=mixer_type)
    args = (rand(2, 8, 8, 8), rand(2, 8, 8, 8, seed=1), rand(2, 8, 8, 8, seed=2))
    check_nchw(jmodel.Block(16, 12, 4, **kw), model.Block(16, 12, 4, **kw), *args)


def test_unknown_mixer_or_attention_raises():
    with pytest.raises(ValueError, match="mixer_type"):
        model.Block(16, 16, 4, mixer_type="mamba")
    with pytest.raises(ValueError, match="attn_type"):
        model.create_adnm_unet(5, 20, 6, attn_type="linear")


def test_block_norms_are_kernel_k1():
    from adnm_tpu_torch.core.layers import RMSNorm

    norms = [m for m in model.Block(16, 16, 4).modules() if isinstance(m, RMSNorm)]
    assert len(norms) == 2 and all(n.axis == 1 for n in norms)


def test_attention_block():
    check_nchw(jmodel.AttentionBlock(16, 8, headdim=4), model.AttentionBlock(16, 8, headdim=4),
               rand(2, 16, 4, 4))


@pytest.mark.parametrize("size", [32, 128])
def test_whole_model_matches_jax(size, narrow_params):
    """The parameter tree does not depend on the input size."""
    x = frames(2 if size == 32 else 1, size)
    want = np.asarray(jax_apply(jmodel.ADNMUNet(**NARROW), narrow_params, jnp.asarray(x),
                                train=False))
    m = convert.from_jax_params(model.ADNMUNet(**NARROW), narrow_params).eval()
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0], 20, 1, size, size)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=MODEL_ATOL)


@pytest.mark.parametrize("mixer_type", ["adnssd", "vssd"])
def test_whole_bimamba_model_matches_jax(mixer_type, narrow_params, vssd_params):
    """The bimamba ADN-SSD tree is the duality tree; VSSD has its own."""
    kw = dict(linear_attn_duality=False, mixer_type=mixer_type)
    params = narrow_params if mixer_type == "adnssd" else vssd_params
    x = frames(2, 32, seed=4)
    want = np.asarray(jax_apply(jmodel.ADNMUNet(**NARROW, **kw), params, jnp.asarray(x),
                                train=False))
    m = convert.from_jax_params(model.ADNMUNet(**NARROW, **kw), params).eval()
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 20, 1, 32, 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=MODEL_ATOL)


def _without(tree, path):
    flat = convert.flatten_tree(tree)
    del flat[path]
    return convert.unflatten_tree(flat)


def test_converter_is_strict_both_ways(narrow_params):
    flat = convert.flatten_tree(narrow_params)
    missing = "refiner/refiner2/mixer_0/in_proj/kernel"
    with pytest.raises(KeyError, match=missing):
        convert.from_jax_params(model.ADNMUNet(**NARROW), _without(narrow_params, missing))
    extra = convert.unflatten_tree({**flat, "decoder/e2d_3/gamma": np.ones(8, np.float32)})
    with pytest.raises(KeyError, match="decoder/e2d_3/gamma"):
        convert.from_jax_params(model.ADNMUNet(**NARROW), extra)
    bad = convert.unflatten_tree({**flat, "encoder/attn/gamma": np.ones(9, np.float32)})
    with pytest.raises(ValueError, match="encoder/attn/gamma"):
        convert.from_jax_params(model.ADNMUNet(**NARROW), bad)


def test_converter_is_strict_on_the_vssd_tree(vssd_params):
    m = model.ADNMUNet(**NARROW, mixer_type="vssd")
    flat = convert.flatten_tree(vssd_params)
    missing = "refiner/refiner2/mixer_0/conv2d/kernel"
    with pytest.raises(KeyError, match=missing):
        convert.from_jax_params(m, _without(vssd_params, missing))
    extra = convert.unflatten_tree({**flat, "encoder/encoder4/mixer_0/alpha2": np.ones(())})
    with pytest.raises(KeyError, match="encoder4/mixer_0/alpha2"):
        convert.from_jax_params(m, extra)
    bad = convert.unflatten_tree({**flat, "decoder/decoder1/mixer_0/A_log": np.ones(7)})
    with pytest.raises(ValueError, match="decoder1/mixer_0/A_log"):
        convert.from_jax_params(m, bad)
    with pytest.raises(KeyError, match="no leaf 'encoder/encoder4/mixer_0/"):
        convert.from_jax_params(model.ADNMUNet(**NARROW), vssd_params)  # ADN-SSD on a VSSD tree


def test_converter_sets_every_vssd_parameter(vssd_params):
    """VSSD reads every leaf of its own; only the Blocks' beta3/beta4 go unread."""
    m = model.ADNMUNet(**NARROW, mixer_type="vssd")
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(float("nan"))
    convert.from_jax_params(m, vssd_params)
    assert all(torch.isfinite(p).all() for p in m.parameters())
    n_flat = len(convert.flatten_tree(vssd_params))
    assert sum(1 for _ in m.parameters()) + 10 * 2 == n_flat


def test_converter_sets_every_port_parameter(narrow_params):
    """Only the leaves the JAX model never reads go unconsumed."""
    m = model.ADNMUNet(**NARROW)
    with torch.no_grad():
        for p in m.parameters():
            p.fill_(float("nan"))
    convert.from_jax_params(m, narrow_params)
    assert all(torch.isfinite(p).all() for p in m.parameters())
    n_port = sum(1 for _ in m.parameters())
    unread = [k for k in convert.flatten_tree(narrow_params)
              if k.endswith(("/beta3", "/beta4", "/mixer_0/alpha2")) and "/attn" not in k]
    assert n_port + len(unread) == len(convert.flatten_tree(narrow_params))
    assert len(unread) == 10 * 3  # ten Blocks: beta3, beta4 and the mixer's alpha2


def test_params_npz_round_trip(tmp_path, narrow_params):
    path = tmp_path / "p.npz"
    convert.save_params_npz(str(path), narrow_params)
    back = convert.flatten_tree(convert.load_params_npz(str(path)))
    flat = convert.flatten_tree(narrow_params)
    assert back.keys() == flat.keys()
    assert all(np.array_equal(back[k], flat[k]) for k in flat)


def test_predict_cli_reproduces_the_jax_forward(tmp_path):
    """Full-width create_adnm_unet(5, 20, 6) at 32^2 through
    ``python -m adnm_tpu_torch.cli.predict --device cpu --params``, with a
    chained rollout to 30 frames against the same chain in JAX."""
    jm = jmodel.create_adnm_unet(5, 20, 6)
    x = frames(2, 32, seed=3)
    params = random_params(jm, jnp.asarray(x[:1]), train=False)
    convert.save_params_npz(str(tmp_path / "p.npz"), params)
    np.save(tmp_path / "x.npy", x)
    out = tmp_path / "y.npy"
    got = predict.main(["--input", str(tmp_path / "x.npy"), "--output", str(out),
                        "--params", str(tmp_path / "p.npz"), "--device", "cpu",
                        "--img-size", "32", "--batch-size", "1", "--horizon", "30"])
    assert got.shape == (2, 30, 1, 32, 32)
    np.testing.assert_array_equal(np.load(out), got)
    (tmp_path / "p.npz").unlink()  # served: the full-width params

    fwd = jax.jit(lambda p, v: jm.apply({"params": p}, v, train=False))
    jp = jax.tree.map(jnp.asarray, params)
    first = np.asarray(fwd(jp, jnp.asarray(x)))
    second = np.asarray(fwd(jp, jnp.asarray(np.clip(first[:, -5:], 0.0, 1.0))))
    want = np.concatenate([first, second], axis=1)[:, :30]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=MODEL_ATOL)


def test_predict_load_model_builds_the_bimamba_configuration(tmp_path):
    """Full-width create_adnm_unet(5, 20, 6, linear_attn_duality=False) at
    32^2 through ``predict.load_model`` and ``predict.forecast`` on the CPU."""
    jm = jmodel.create_adnm_unet(5, 20, 6, linear_attn_duality=False)
    x = frames(1, 32, seed=5)
    params = random_params(jm, jnp.asarray(x), train=False)
    convert.save_params_npz(str(tmp_path / "p.npz"), params)
    cpu = torch.device("cpu")
    m = predict.load_model(str(tmp_path / "p.npz"), cpu, linear_attn_duality=False)
    assert not m.refiner.refiner1.mixer_0.linear_attn_duality
    got = predict.forecast(m, x, 1, cpu)
    want = np.asarray(jax_apply(jm, params, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=MODEL_ATOL)
    (tmp_path / "p.npz").unlink()  # served: the full-width params


def test_predict_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    np.save(tmp_path / "x.npy", frames(1, 32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict.main(["--input", str(tmp_path / "x.npy"), "--img-size", "32"])


def test_predict_cli_checks_the_input_shape(tmp_path):
    np.save(tmp_path / "x.npy", frames(1, 32))
    with pytest.raises(ValueError, match="expected"):
        predict.main(["--input", str(tmp_path / "x.npy"), "--img-size", "64", "--device", "cpu"])


FORBIDDEN = ("jax", "flax", "optax", "orbax", "adnm_tpu")


def test_port_never_imports_jax():
    """No module of the port names JAX or the JAX package, and importing
    the whole port in a fresh interpreter loads neither."""
    pkg = REPO / "adnm_tpu_torch"
    for path in pkg.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"
    mods = [f"adnm_tpu_torch.{p.relative_to(pkg).with_suffix('').as_posix().replace('/', '.')}"
            for p in pkg.rglob("*.py") if p.name != "__init__.py"]
    code = ("import sys; before = set(sys.modules)\n"
            + "".join(f"import {m}\n" for m in ["adnm_tpu_torch", *mods])
            + "new = set(sys.modules) - before\n"
            "bad = sorted(m for m in new if m.split('.')[0] in %r)\n"
            "assert not bad, bad\n" % (FORBIDDEN,))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
