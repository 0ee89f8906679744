"""The ADNM-UNet's remaining options in the PyTorch port against the JAX
package, on the CPU: MLA and its RoPE helpers, ``SimplePatchEmbed``,
``LayerToLayer``, ``ssd_state_update``, the whole model with
``attn_type="mla"``, ``simple_patch=True`` and ``compute_dead_features=True``,
one MLA training step, and the CLIs with ``--attn-type mla``.

Every JAX parameter is drawn by numpy from a seed and carried into the port
by ``convert.from_jax_params``; inputs come from numpy seeds. The models
are the TINY configuration of ``tests/test_train_modes.py`` at 32^2 (5 ->
2 frames), each JAX model compiled once per module.

Tolerances, fp32 on both sides with sums in other orders:
  * layers and MLA: rtol 1e-4, atol 1e-5 (``check_nchw``'s); the RoPE
    tables 1e-6 (the same fp32 formula; cos and sin of up to 1,023 rad);
  * the whole model: rtol 1e-4, atol 5e-5 (the port's model tolerance,
    ``test_torch_port_eval.py``);
  * ``ssd_state_update``: rtol 1e-5, atol 1e-6 against JAX (the same
    arithmetic), rtol 1e-4, atol 1e-5 token by token against the port's
    causal scan (``tests/test_ssd.py``'s);
  * the training step: the loss rtol 1e-5, each gradient leaf 1e-4
    relative L2 plus 1e-6 of the global norm (``test_torch_port_train.py``);
  * bf16: each activation's dtype equal to flax's; values within 2x JAX's
    own bf16-vs-fp32 distance, never below one bf16 rounding
    (``test_torch_port_bf16.py::check_bf16``).
"""

from __future__ import annotations

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.core import blocks as jblocks
from adnm_tpu.mixers import attention as jattention
from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu.ops import ssd as jssd
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import predict
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.cli import validate as validate_cli
from adnm_tpu_torch.cli import visualize as visualize_cli
from adnm_tpu_torch.core import blocks
from adnm_tpu_torch.core.layers import RMSNorm
from adnm_tpu_torch.mixers import attention
from adnm_tpu_torch.models import adnm_unet as model
from adnm_tpu_torch.ops import ssd
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_bf16 import check_bf16, jax_call_dtypes, port_call_dtypes
from test_torch_port_layers import (  # noqa: F401 (one_torch_thread is a fixture)
    check_nchw,
    jax_apply,
    one_torch_thread,
    rand,
    random_params,
)
from test_torch_port_train import assert_grads_close, flat_grads
from test_train_modes import TINY, _batches

CPU = torch.device("cpu")
TINY_KW = dict(channels=5, out_channels=2, kernel=(3, 3, 3), **TINY)
MODEL_RTOL, MODEL_ATOL = 1e-4, 5e-5
OPTIONS = {"mla": dict(attn_type="mla"), "simple_patch": dict(simple_patch=True),
           "dead_features": dict(compute_dead_features=True)}


def frames(b: int = 2, size: int = 32, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(b, 5, 1, size, size).astype(np.float32)


# -- MLA and its helpers -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_tables_match_jax(dtype):
    want = jattention._rope_cos_sin(1024, 64, 128000.0, getattr(jnp, dtype))
    got = attention._rope_cos_sin(1024, 64, 128000.0, getattr(torch, dtype))
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{dtype}"
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=1e-6 if dtype == "float32" else 2 ** -8)


def test_rope_rotation_deinterleaves_pairs_as_jax():
    q, k = rand(2, 3, 7, 64), rand(2, 1, 7, 64, seed=1)
    cos, sin = jattention._rope_cos_sin(7, 64, 128000.0)
    want = jattention._apply_rope(jnp.asarray(q), jnp.asarray(k), cos, sin)
    got = attention._apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                                *attention._rope_cos_sin(7, 64, 128000.0))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    x = rand(4, 10)
    np.testing.assert_array_equal(attention._rotate_half(torch.from_numpy(x)).numpy(),
                                  np.asarray(jattention._rotate_half(jnp.asarray(x))))


@pytest.mark.parametrize("dim", [8, 16, 128, 1024])
def test_generate_mla_config_matches_jax(dim):
    assert attention.generate_mla_config(dim, strict=False) == \
        jattention.generate_mla_config(dim, strict=False)
    with pytest.raises(ValueError, match="Unsupported"):
        attention.generate_mla_config(24)


@pytest.mark.parametrize("dim", [16, 128])
def test_mla_matches_jax(dim):
    cfg = jattention.generate_mla_config(dim, strict=False)
    x = rand(2, 24, dim)
    jm, pm = jattention.MLA(**cfg), attention.MLA(**cfg)
    params = random_params(jm, jnp.asarray(x))
    want = np.asarray(jax_apply(jm, params, jnp.asarray(x)))
    convert.from_jax_params(pm, params)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    norms = [m for m in pm.modules() if isinstance(m, RMSNorm)]
    assert [(n.axis, n.weight.shape[0], n.eps) for n in norms] == \
        [(-1, cfg["q_lora_rank"], 1e-6), (-1, cfg["kv_lora_rank"], 1e-6)]


def test_mla_in_bf16_matches_jax_in_bf16():
    cfg = jattention.generate_mla_config(16, strict=False)
    check_bf16(jattention.MLA(**cfg), attention.MLA(**cfg), rand(2, 24, 16))


def test_mla_attention_block_in_bf16_matches_jax_in_bf16():
    check_bf16(jmodel.AttentionBlock(16, 8, headdim=4, attn_type="mla"),
               model.AttentionBlock(16, 8, headdim=4, attn_type="mla"), rand(2, 16, 4, 4))


def test_mla_attention_block_matches_jax():
    check_nchw(jmodel.AttentionBlock(16, 8, headdim=4, attn_type="mla"),
               model.AttentionBlock(16, 8, headdim=4, attn_type="mla"), rand(2, 16, 4, 4))


# -- the factory's other options -------------------------------------------

@pytest.mark.parametrize("instance_norm", [True, False])
def test_simple_patch_embed_matches_jax(instance_norm):
    x = np.random.RandomState(0).rand(2, 5, 16, 16).astype(np.float32)
    jm = jblocks.SimplePatchEmbed(5, 8, 5, instance_norm)
    pm = blocks.SimplePatchEmbed(5, 8, 5, instance_norm)
    jx = jnp.asarray(np.moveaxis(x, 1, -1))
    params = random_params(jm, jx)
    want_x, want_res = jax_apply(jm, params, jx)
    convert.from_jax_params(pm, params)
    with torch.no_grad():
        got_x, got_res = pm(torch.from_numpy(x))
    np.testing.assert_allclose(got_x.numpy(), np.moveaxis(np.asarray(want_x), -1, 1),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got_res.numpy(), np.asarray(want_res))


@pytest.mark.parametrize("inputs", ["residual", "features", "none"])
def test_layer_to_layer_matches_jax(inputs):
    x = rand(2, 4, 8, 8)
    if inputs == "residual":
        jm, pm = jblocks.LayerToLayer(8, 6, if_res=True), blocks.LayerToLayer(8, 6, if_res=True)
        check_nchw(jm, pm, x, rand(2, 4, 8, 8, seed=1))
        return
    jm = jblocks.LayerToLayer(4, 8, instance_norm=False)
    pm = blocks.LayerToLayer(4, 8, instance_norm=False)
    if inputs == "none":
        check_nchw(jm, pm, x)
        return
    f = rand(2, 4, 8, 8, seed=2)
    jx, jf = jnp.asarray(np.moveaxis(x, 1, -1)), jnp.asarray(np.moveaxis(f, 1, -1))
    params = random_params(jm, jx, None, jf)
    want = np.moveaxis(np.asarray(jax_apply(jm, params, jx, None, jf)), -1, 1)
    convert.from_jax_params(pm, params)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), None, torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def state_update_case(seed: int = 7, b: int = 2, l: int = 12, h: int = 3, p: int = 4,
                      n: int = 5):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, h, p).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    B, C = (rng.randn(b, l, n).astype(np.float32) for _ in range(2))
    D = rng.randn(h).astype(np.float32)
    return x, dt, A, B, C, D


def test_ssd_state_update_matches_jax_and_rolls_out_the_causal_scan():
    x, dt, A, B, C, D = state_update_case()
    b, l, h, p = x.shape
    state_j, state_p = jnp.zeros((b, h, B.shape[-1], p)), torch.zeros(b, h, B.shape[-1], p)
    t = torch.from_numpy
    ys = []
    for i in range(l):
        state_j, yj = jssd.ssd_state_update(state_j, x[:, i], dt[:, i], A, B[:, i], C[:, i], D)
        state_p, yp = ssd.ssd_state_update(state_p, t(x[:, i]), t(dt[:, i]), t(A), t(B[:, i]),
                                           t(C[:, i]), t(D))
        np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state_p.numpy(), np.asarray(state_j), rtol=1e-5, atol=1e-6)
        ys.append(yp)
    # the port's causal scan in its sequence-minor layout: x (B, H, P, L), B/C (B, N, L)
    y_scan = ssd.ssd_naive_scan(t(x).permute(0, 2, 3, 1), t(dt).permute(0, 2, 1), t(A),
                                t(B).permute(0, 2, 1), t(C).permute(0, 2, 1), t(D))
    np.testing.assert_allclose(torch.stack(ys, dim=-1).numpy(), y_scan.numpy(), rtol=1e-4,
                               atol=1e-5)


# -- the whole model ---------------------------------------------------------

_PARAMS: dict = {}


def option_params(name: str) -> dict:
    if name not in _PARAMS:
        _PARAMS[name] = random_params(jmodel.ADNMUNet(**TINY_KW, **OPTIONS[name]),
                                      jnp.zeros((1, 5, 1, 32, 32)), train=True)
    return _PARAMS[name]


def port_model(name: str) -> model.ADNMUNet:
    pm = model.ADNMUNet(**TINY_KW, **OPTIONS[name])
    return convert.from_jax_params(pm, option_params(name)).eval()


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_model_option_matches_jax(name):
    x = frames()
    want = np.asarray(jax_apply(jmodel.ADNMUNet(**TINY_KW, **OPTIONS[name]), option_params(name),
                                jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_model(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_dead_features_change_the_tree_not_the_prediction():
    """From one weight set (the extra e2ds seeded), the model with the dead
    features predicts exactly what the model without them does; the
    reference importer carries e2ds 3..6 under the flag."""
    from adnm_tpu_torch.train import adnm_import

    dead = port_model("dead_features")
    tree = convert.to_jax_params(dead)
    live = model.ADNMUNet(**TINY_KW)
    convert.from_jax_params(live, {**tree, "decoder": {k: v for k, v in tree["decoder"].items()
                                                         if k not in {f"e2d_{i}" for i in
                                                                      range(3, 7)}}})
    x = torch.from_numpy(frames())
    with torch.no_grad():
        assert torch.equal(dead(x), live.eval()(x))
    cfg = dict(embed_dim=TINY["embed_dim"], refine_dim=TINY["refine_dim"],
               wt_levels=TINY["wt_levels"], headdim=TINY["headdim"],
               refine_headdim=TINY["refine_headdim"])
    sd = adnm_import.export_adnm_state_dict(tree, compute_dead_features=True, **cfg)
    assert {f"decoder.e2ds.{i}.gamma" for i in range(7)} <= set(sd)
    back = adnm_import.convert_adnm_state_dict(sd, compute_dead_features=True, **cfg)
    flat = convert.flatten_tree(back)
    for k, v in convert.flatten_tree(tree).items():
        if k in flat:
            np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert {k for k in flat if "/e2d_6/" in k}
    assert not any("e2ds.3" in k for k in adnm_import.export_adnm_state_dict(
        convert.to_jax_params(live), **cfg))


def test_mla_model_runs_k1_six_more_times_a_forward():
    """Two RMSNorms (kernel K1 on the card) at each of the three attention
    sites: 26 calls a forward instead of 20."""
    calls = []
    for name, kw in (("standard", {}), ("mla", OPTIONS["mla"])):
        pm = model.create_adnm_unet(5, 20, 6, **kw).eval()
        n = [0]
        hooks = [m.register_forward_hook(lambda *a: n.__setitem__(0, n[0] + 1))
                 for m in pm.modules() if isinstance(m, RMSNorm)]
        with torch.no_grad():
            pm(torch.from_numpy(frames(1)))
        for hk in hooks:
            hk.remove()
        calls.append(n[0])
    assert calls == [20, 26]


def test_mla_model_activations_have_the_dtypes_jax_gives_them():
    """Every module call of the TINY MLA model in bf16 with a flax
    counterpart has the dtypes of flax's intermediates."""
    params = option_params("mla")
    x = frames(1)
    want = jax_call_dtypes(jmodel.ADNMUNet(**TINY_KW, **OPTIONS["mla"]), params,
                           jnp.asarray(x).astype(jnp.bfloat16))
    got = port_call_dtypes(port_model("mla"), torch.from_numpy(x).bfloat16())
    unmatched = [n for n in got if n not in want]
    assert all(".mixer_" in n for n in unmatched), unmatched
    compared = {n: got[n] for n in got if n in want}
    assert sum(".attn_layer.q_down_norm" in n for n in compared) == 3
    assert {n: want[n] for n in compared} == compared


# -- training ----------------------------------------------------------------

def test_mla_step_loss_and_every_gradient_match_jax():
    """One step's loss (the ADNMUnet preset's, train mode) and every
    gradient against ``jax.value_and_grad`` of the JAX trainer's loss."""
    params = option_params("mla")
    (batch,) = _batches(1, 2)
    jm = jmodel.ADNMUNet(**TINY_KW, **OPTIONS["mla"])
    preset = jget_preset("ADNMUnet", 5, 2, 6, "Shanghai")

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(batch[:, :5]), train=True)
        return preset.loss_fn(out.astype(jnp.float32), jnp.asarray(batch[:, 5:]))

    loss_want, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    t = Trainer(model.ADNMUNet(**TINY_KW, **OPTIONS["mla"]),
                get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, CPU, seed=0)
    convert.from_jax_params(t.model, params)
    loss, got = t.grads(batch)
    np.testing.assert_allclose(float(loss), float(loss_want), rtol=1e-5)
    assert_grads_close(flat_grads(t, got), convert.flatten_tree(jax.device_get(grads)))


# -- the CLIs ------------------------------------------------------------------

def cli_args(root, *extra):
    return ["--synthetic", "--synthetic-len", "8", "--img-size", "32", "--batch-size", "2",
            "--device", "cpu", "--root", str(root), "--attn-type", "mla", *extra]


@pytest.fixture(scope="module")
def mla_snapshot(tmp_path_factory):
    """One epoch of the train CLI with ``--attn-type mla`` (fp32) and its
    epoch snapshot, shared by the CLI tests: a full-width snapshot with its
    AdamW state is 870 MB."""
    root = tmp_path_factory.mktemp("mla")
    out = train_cli.main(cli_args(root, "--epochs", "1", "--save-every", "1"))
    x = root / "x.npy"
    np.save(x, frames(1)[0, :, 0])
    yield out, root, str(root / "model_params/Shanghai/ADNMUnet/ADNMUnet_best_epoch1"), x
    shutil.rmtree(root)  # after the module's last test: the snapshot is 851 MB


def test_train_cli_trains_mla_in_fp32_and_bf16(mla_snapshot, tmp_path):
    out, _, _, _ = mla_snapshot
    trainer = out["trainer"]
    assert isinstance(trainer.model.encoder.attn.attn_layer, attention.MLA)
    assert np.isfinite(out["logs"][0].train_loss) and trainer.step == 2
    assert set(out["metrics"]["threshold_metrics"]) == {20, 30, 35, 40}
    bf16 = train_cli.main(cli_args(tmp_path, "--epochs", "1", "--bf16", "--no-final-eval"))
    assert bf16["trainer"].compute_dtype == torch.bfloat16
    assert np.isfinite(bf16["logs"][0].train_loss) and bf16["trainer"].step == 2


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_clis_validate_visualize_and_serve_an_mla_snapshot(mla_snapshot, tmp_path, bf16):
    """validate, visualize and predict with ``--attn-type mla`` on the
    snapshot, in fp32 and in bf16 compute; predict serves what the model
    loaded from the snapshot computes, and a standard model refuses it."""
    _, root, snap, x = mla_snapshot
    extra = ["--bf16"] if bf16 else []
    val = validate_cli.main(cli_args(root, "--ckpt", snap, *extra))
    assert np.isfinite(val["test_loss"]) and val["preds"].shape[1:] == (20, 32, 32)
    visualize_cli.main(cli_args(root, "--ckpt", snap, "--out", str(tmp_path / "pics"),
                                "--max-samples", "1", *extra))
    assert list((tmp_path / "pics").iterdir())
    y = predict.main(["--input", str(x), "--output", str(tmp_path / "y.npy"), "--img-size", "32",
                      "--device", "cpu", "--ckpt", snap, "--attn-type", "mla", *extra])
    assert y.shape == (1, 20, 1, 32, 32) and np.isfinite(y).all()
    dtype = torch.bfloat16 if bf16 else torch.float32
    m = predict.load_model(None, "cpu", ckpt=snap, compute_dtype=dtype, img_size=32,
                           attn_type="mla")
    want = predict.forecast(m, np.load(x)[None, :, None], 4, CPU, compute_dtype=dtype)
    np.testing.assert_array_equal(y, want)
    with pytest.raises(RuntimeError, match="attn_layer"):  # a standard model refuses it
        predict.main(["--input", str(x), "--output", str(tmp_path / "z.npy"), "--img-size",
                      "32", "--device", "cpu", "--ckpt", snap])
