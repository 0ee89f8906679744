"""The LAPS task in the PyTorch port against the JAX package, on the CPU:
its synthetic clips and splits, ``laps_evaluate``, the native decode-resize
(against JAX's library and against ``F.interpolate``) and an h5 clip through
both datasets, the ADNM-UNet's LAPS branch (``create_adnm_unet(5, 3, 60)``:
no InstanceNorm, kernels (5, 3, 3), refiner widths halved at its last two
Blocks, 3 output frames) in the duality and bimamba configurations and a
training step, and the four CLIs with ``--dataset LAPS``.

The model is the TINY configuration of ``tests/test_train_modes.py`` with
the LAPS branch's options (``LAPS_TINY``), every weight drawn by numpy and
carried into the port by ``convert.from_jax_params``; the JAX step (whose
forward is the duality model's) and the bimamba forward are compiled once
per module. The CLIs run the LAPS branch at TINY widths too
(``narrow_adnm``): a full-width LAPS checkpoint with its AdamW state takes
870 MB; the card runs it at full width (``chip_smoke.py`` phase 6f).

Tolerances: the forward as ``test_torch_port_model.py``'s whole model
(rtol 1e-4, atol 5e-5); the step as ``test_torch_port_train.py``'s (loss
1e-5 relative; each gradient leaf 1e-4 relative L2 plus 1e-6 of the global
norm); the clips, splits, evaluator dicts and the native library against
JAX's exactly (the native decode at most 1e-6, the same source built with
the same flags); the native decode against ``F.interpolate`` 1e-6.
"""

from __future__ import annotations

import math
import os
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.data import laps as jlaps
from adnm_tpu.data import native as jnative
from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import common, predict
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.cli import validate as validate_cli
from adnm_tpu_torch.cli import visualize as visualize_cli
from adnm_tpu_torch.data import laps, native, shanghai
from adnm_tpu_torch.models import adnm_unet as model
from adnm_tpu_torch.ops import _build
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_bf16_baselines import fast_compiled
from test_torch_port_layers import RTOL, one_torch_thread, random_params  # noqa: F401
from test_torch_port_train import assert_grads_close
from test_train_modes import TINY, _batches

CPU = torch.device("cpu")
MODEL_ATOL = 5e-5
LAPS_TINY = dict(channels=5, out_channels=3, kernel=(5, 3, 3), instance_norm=False,
                 **{**TINY, "refine_dim": (8, 8, 4, 4)})
SIZE = 32


def test_factory_takes_the_laps_branch():
    """``create_adnm_unet(5, 3, 60)`` builds what JAX's does: JAX's tree less
    the 0-d gates it creates and never reads (``convert.unread_leaves``), no
    InstanceNorm, (5, 3, 3) kernels, refiner widths (32, 32, 16, 16)."""
    m = model.create_adnm_unet(5, 3, 60, img_size=SIZE)
    jm = jmodel.create_adnm_unet(5, 3, 60)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 5, 1, SIZE, SIZE)), train=False))
    want = sum(math.prod(s.shape) for s in jax.tree_util.tree_leaves(shapes["params"]))
    unread = convert.unread_leaves(m)
    assert sum(p.numel() for p in m.parameters()) == want - len(unread) == 72_471_815
    assert (jm.instance_norm, tuple(jm.kernel), tuple(jm.refine_dim)) == (
        False, (5, 3, 3), (32, 32, 16, 16))
    assert not any(type(x).__name__ == "InstanceNorm" for x in m.modules())


# -- data --------------------------------------------------------------------

def test_synthetic_clips_and_splits_equal_jax():
    got = laps.make_laps_datasets(None, SIZE, synthetic_len=12)
    want = jlaps.make_laps_datasets(None, SIZE, synthetic_len=12)
    for g, w in zip(got, want):
        assert len(g) == len(w) and g._indices == w._indices
        for i in range(len(w)):
            assert g[i].shape == (8, SIZE, SIZE)
            np.testing.assert_array_equal(g[i], w[i])


def assert_same_table(got: dict, want: dict):
    """Equal ``laps_evaluate`` dicts, a NaN equal to a NaN."""
    assert got.keys() == want.keys()
    for thr in want:
        assert got[thr].keys() == want[thr].keys()
        for k, w in want[thr].items():
            assert got[thr][k] == w or (np.isnan(got[thr][k]) and np.isnan(w)), (thr, k)


def test_laps_evaluate_equals_jax(capsys):
    rng = np.random.RandomState(3)
    preds = rng.uniform(0, 1, (4, 3, 16, 16)).astype(np.float32)
    gts = rng.uniform(0, 1, (4, 3, 16, 16)).astype(np.float32) ** 2
    preds[0] = 0.0  # no hits at all in one clip
    got = laps.laps_evaluate(preds, gts)
    printed = capsys.readouterr().out
    want = jlaps.laps_evaluate(preds, gts)
    assert printed == capsys.readouterr().out and printed.count("mm CSI:") == 5
    assert got.keys() == set(laps.LAPS_THRESHOLDS)
    assert_same_table(got, want)
    # no prediction reaches the threshold: POD undefined, FAR 1, as in JAX
    high = laps.laps_evaluate(preds * 0.05, gts, (0.5,), verbose=False)[0.5]
    assert np.isnan(high["POD"]) and high["FAR"] == 1.0
    assert_same_table({0.5: high}, jlaps.laps_evaluate(preds * 0.05, gts, (0.5,), verbose=False))


@pytest.fixture(scope="module")
def radar_clip():
    """A random uint8 clip at the h5's frame size, 565 x 784 (range 0..70)."""
    return np.random.RandomState(0).randint(0, 71, (3, 565, 784)).astype(np.uint8)


def test_native_decode_equals_jax_and_interpolate(radar_clip):
    got = native.decode_resize_clip(radar_clip, 256)
    assert got.dtype == np.float32 and got.shape == (3, 256, 256)
    want = jnative.decode_resize_clip(radar_clip, 256)
    assert want is not None
    assert np.abs(got - want).max() <= 1e-6
    plain = shanghai._resize_bilinear_antialias(radar_clip.astype(np.float32) / 255.0, 256)
    assert np.abs(got - plain).max() <= 1e-6


def test_native_switch_and_a_failed_build_raises(radar_clip, tmp_path, monkeypatch):
    """``ADNM_NATIVE=0`` selects ``F.interpolate``; a source that does not
    compile raises, with no quiet fall-back."""
    monkeypatch.setenv("ADNM_NATIVE", "0")
    plain = shanghai._resize_bilinear_antialias(radar_clip.astype(np.float32) / 255.0, 64)
    np.testing.assert_array_equal(shanghai.decode_clip(radar_clip, 64), plain)
    monkeypatch.setenv("ADNM_NATIVE", "1")
    (tmp_path / "radar_io.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        shanghai.decode_clip(radar_clip, 64)


def test_h5_clips_decode_as_in_jax(tmp_path):
    """An h5 file in Shanghai's layout through both packages' LAPS datasets:
    the splits and every clip (the native decode on both sides)."""
    path = tmp_path / "laps.h5"
    rng = np.random.RandomState(1)
    with h5py.File(path, "w") as f:
        g = f.create_group("train")
        g["all_len"] = 7
        for i in range(7):
            g[str(i)] = rng.randint(0, 71, (25, 40, 56)).astype(np.uint8)
    for split in ("train", "test"):
        got = laps.LAPSDataset(str(path), 16, split)
        want = jlaps.LAPSDataset(str(path), 16, split)
        assert got._indices == want._indices
        for i in range(len(want)):
            assert np.abs(got[i] - want[i]).max() <= 1e-6


# -- the LAPS ADNM-UNet --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_laps():
    """Params, a batch, JAX's training step on it (the JAX trainer's loss:
    the LAPS preset's on the fp32 output of the forward; its loss, its
    gradients and the forward's output) and the bimamba configuration's
    forward, two compiles. The model has no BatchNorm or dropout: train and
    eval mode compute the same forward."""
    jm = jmodel.ADNMUNet(**LAPS_TINY)
    params = random_params(jm, jnp.zeros((1, 5, 1, SIZE, SIZE)), train=True)
    preset = jget_preset("ADNMUnet", 5, 3, 60, "LAPS")
    (batch,) = _batches(1, 2, frames=8, size=SIZE)
    p, imgs, targets = jax.tree.map(jnp.asarray, params), batch[:, :5], batch[:, 5:]

    def loss_fn(q):
        out = jm.apply({"params": q}, imgs, train=True)
        return preset.loss_fn(out.astype(jnp.float32), targets), out

    (loss, duality), grads = fast_compiled(jax.value_and_grad(loss_fn, has_aux=True), p)
    jbi = jmodel.ADNMUNet(**LAPS_TINY, linear_attn_duality=False)
    bimamba = fast_compiled(lambda q: jbi.apply({"params": q}, imgs, train=False), p)
    return dict(params=params, batch=batch, duality=np.asarray(duality),
                bimamba=np.asarray(bimamba), loss=float(loss),
                grads=convert.flatten_tree(jax.device_get(grads)))


@pytest.mark.parametrize("duality", [True, False], ids=["duality", "bimamba"])
def test_laps_branch_forward_matches_jax(duality, jax_laps):
    m = model.ADNMUNet(**LAPS_TINY, linear_attn_duality=duality)
    m = convert.from_jax_params(m, jax_laps["params"]).eval()
    with torch.no_grad():
        got = m(torch.from_numpy(jax_laps["batch"][:, :5])).numpy()
    assert got.shape == (2, 3, 1, SIZE, SIZE)
    want = jax_laps["duality" if duality else "bimamba"]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=MODEL_ATOL)


def test_laps_training_step_matches_jax(jax_laps):
    """One step's loss and every gradient with the LAPS preset (en_rainfall
    loss; the clip and AdamW come after the gradients) through the port's
    ``Trainer``."""
    t = Trainer(model.ADNMUNet(**LAPS_TINY), get_preset("ADNMUnet", 5, 3, 60, "LAPS"), 5, CPU,
                seed=0)
    convert.from_jax_params(t.model, jax_laps["params"])
    loss, got = t.grads(jax_laps["batch"])
    np.testing.assert_allclose(float(loss), jax_laps["loss"], rtol=1e-5)
    assert_grads_close(convert.flatten_tree(convert.to_jax_params(t.model, got)),
                       jax_laps["grads"])


def test_chip_smoke_times_k2_at_the_laps_refiner_shape(monkeypatch):
    """The LAPS bimamba model at 64^2 on the CPU: with L scaled to 256^2,
    the (heads, L) that reach K2 are the Shanghai model's (``K2_SHAPES``)
    and ``K2_LAPS``, the 16-channel refiner Blocks' 4 heads a path, which
    chip_smoke.py checks and times; 20 calls a forward."""
    import chip_smoke
    from adnm_tpu_torch.mixers import ssd_mixer
    from adnm_tpu_torch.ops import ssd

    seen = []

    def recording(x, dt, A, B, C, D, chunk_size=256, reverse=False):
        seen.append((x.shape[1], 16 * x.shape[-1]))
        return ssd.ssd_chunked_scan(x, dt, A, B, C, D, chunk_size, reverse)

    monkeypatch.setattr(ssd_mixer, "ssd_chunked_scan", recording)
    m = predict.load_model(None, CPU, dataset="LAPS", img_size=64, linear_attn_duality=False)
    with torch.inference_mode():
        m(torch.zeros(1, 5, 1, 64, 64))
    assert len(seen) == chip_smoke.K2_PER_FORWARD
    assert set(seen) - set(chip_smoke.K2_SHAPES) == {chip_smoke.K2_LAPS}


# -- the CLIs ------------------------------------------------------------------

@pytest.fixture
def narrow_adnm(monkeypatch):
    """The CLIs' registry with the LAPS ADNM-UNet at LAPS_TINY's widths."""
    real = common.create_model

    def create(name, input_frames, output_frames, frame_interval, img_size=256, **kw):
        if name == "ADNMUnet":
            assert (input_frames, output_frames, frame_interval) == (5, 3, 60)
            return model.ADNMUNet(**LAPS_TINY, **kw)
        return real(name, input_frames, output_frames, frame_interval, img_size=img_size, **kw)

    for module in (common, predict):
        monkeypatch.setattr(module, "create_model", create)


def cli_args(name: str, root) -> list:
    return ["--model", name, "--dataset", "LAPS", "--synthetic", "--synthetic-len", "8",
            "--img-size", str(SIZE), "--batch-size", "2", "--device", "cpu", "--root", str(root)]


@pytest.mark.parametrize("name", ["ADNMUnet", "ConvLSTM"])
def test_four_clis_run_the_laps_task(name, tmp_path, capsys, narrow_adnm):
    """train (its LAPS table is JAX's ``laps_evaluate`` of the test split's
    predictions), validate (3 frames, LAPS thresholds), visualize (every
    frame) and predict on the epoch snapshot."""
    out = train_cli.main(cli_args(name, tmp_path) + ["--epochs", "1", "--save-every", "1"])
    assert out["trainer"].step == 2 and np.isfinite(out["test_loss"])
    snapshot = best_ckpt_dir(str(tmp_path), "LAPS", name)
    if name == "ADNMUnet":  # the save gate keeps epoch 1 out of the best checkpoint
        snapshot += "_epoch1"
    val = validate_cli.main(cli_args(name, tmp_path) + ["--ckpt", snapshot])
    assert val["preds"].shape[1:] == (3, SIZE, SIZE)
    assert set(val["metrics"]["threshold_metrics"]) == set(laps.LAPS_THRESHOLDS)
    printed = capsys.readouterr().out
    assert_same_table(out["metrics"], jlaps.laps_evaluate(val["preds"], val["gts"],
                                                          verbose=False))
    assert "0.1mm CSI:" in printed and "0.8mm CSI:" in printed and "FAR:" in printed
    written = visualize_cli.main(cli_args(name, tmp_path) + [
        "--ckpt", snapshot, "--out", str(tmp_path / "pics"), "--max-samples", "1"])
    assert written and os.path.exists(os.path.join(written[0], f"{name}.png"))
    x = tmp_path / "x.npy"
    np.save(x, np.random.RandomState(5).rand(5, SIZE, SIZE).astype(np.float32))
    served = predict.main(["--model", name, "--dataset", "LAPS", "--input", str(x),
                           "--img-size", str(SIZE), "--device", "cpu", "--ckpt", snapshot,
                           "--output", str(tmp_path / "y.npy")])
    assert served.shape == (1, 3, 1, SIZE, SIZE) and np.isfinite(served).all()
    shutil.rmtree(tmp_path / "model_params")  # checked: the epoch snapshot
