"""The port's evaluation, visualisation and serving path against the JAX
package, on the CPU: SSIM, the streaming evaluator, LPIPS, the radar
strips, the metrics logger, the reference importer, the TF32 switch of the
entry points, and the train -> validate -> predict -> visualize CLIs.

Tolerances, each for fp32 on both sides:
  * SSIM per frame 1e-5 absolute against JAX (sums of 121 taps in another
    order on values up to 90^2, then ratios of order 1), and 2e-4 against
    cv2's float64 filter2D, the bound the JAX package's own test holds;
  * contingency counts exactly equal (floor and compare are exact), so
    CSI/POD/HSS/FAR, float64 ratios of the same integers, within 1e-12;
    RMSE and SSIM, means of fp32 per-frame values, within 1e-5 relative;
  * LPIPS 1e-5 (five convolutions deep, distances of order 0.1-1);
  * the whole TINY model's forward: the port's model tolerance of
    ``tests/test_torch_port_model.py`` (rtol 1e-4, atol 5e-5); the counts
    may then differ only at pixels where the two forwards straddle a
    threshold, and by exactly those.
The JAX trainer is built once per module and the train CLI runs once.
"""

from __future__ import annotations

import ast
import json
import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.metrics import evaluator as jevaluator
from adnm_tpu.metrics import lpips_jax as jlpips
from adnm_tpu.metrics import ssim as jssim
from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu.train import adnm_import as jimport
from adnm_tpu.utils import logging as jlogging
from adnm_tpu.viz import colormap as jcolormap
from adnm_tpu.viz import render as jrender
from adnm_tpu_torch import convert, device
from adnm_tpu_torch.cli import common, predict
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.cli import validate as validate_cli
from adnm_tpu_torch.cli import visualize as visualize_cli
from adnm_tpu_torch.metrics import evaluator, lpips, ssim
from adnm_tpu_torch.models import adnm_unet as model
from adnm_tpu_torch.train import adnm_import
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from adnm_tpu_torch.utils import logging as plogging
from adnm_tpu_torch.utils import profiling
from adnm_tpu_torch.viz import colormap, render
from test_torch_port_layers import (  # noqa: F401 (one_torch_thread is a fixture)
    jax_apply,
    one_torch_thread,
    random_params,
)
from chip_smoke import png_header
from test_train_modes import TINY, _batches

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parents[1]
TINY_KW = dict(channels=5, out_channels=2, kernel=(3, 3, 3), **TINY)
THRESHOLDS = (20, 30, 35, 40)
SSIM_ATOL = 1e-5
SSIM_CV2_ATOL = 2e-4
RATIO_RTOL = 1e-12
MEAN_RTOL = 1e-5
LPIPS_ATOL = 1e-5
MODEL_RTOL, MODEL_ATOL = 1e-4, 5e-5
CELLS = ("hits", "misses", "falsealarms", "correctnegs")


@pytest.fixture(scope="module")
def params():
    return random_params(jmodel.ADNMUNet(**TINY_KW), jnp.zeros((1, 5, 1, 32, 32)), train=True)


@pytest.fixture(scope="module")
def clips():
    """Two synthetic 7-frame clips (5 in, 2 out) at 32^2, and the JAX
    model's forward of their inputs."""
    return _batches(1, 2)[0]


@pytest.fixture(scope="module")
def jax_preds(params, clips):
    out = jax_apply(jmodel.ADNMUNet(**TINY_KW), params, jnp.asarray(clips[:, :5]), train=False)
    return np.asarray(out)[:, :, 0]


def port_trainer(params) -> Trainer:
    t = Trainer(model.ADNMUNet(**TINY_KW), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, CPU,
                seed=0)
    convert.from_jax_params(t.model, params)
    return t


def evaluators():
    """(port, JAX) evaluators with LPIPS off."""
    ours = evaluator.SimplifiedEvaluator(20, 90, THRESHOLDS, lpips_fn=False, device="cpu")
    ours.lpips_fn = None
    ref = jevaluator.SimplifiedEvaluator(20, 90, THRESHOLDS, lpips_fn=False)
    ref.lpips_fn = None
    return ours, ref


def assert_results_match(got: dict, want: dict):
    for thr in THRESHOLDS:
        g, w = got["threshold_metrics"][thr], want["threshold_metrics"][thr]
        for k in ("TP", "TN", "FP", "FN"):
            assert g[k] == w[k], (thr, k)
        for k in ("CSI", "POD", "HSS"):
            np.testing.assert_allclose(g[k], w[k], rtol=RATIO_RTOL, err_msg=f"{thr} {k}")
    np.testing.assert_allclose(got["FAR"], want["FAR"], rtol=RATIO_RTOL)
    for k in ("RMSE", "SSIM"):
        np.testing.assert_allclose(got[k], want[k], rtol=MEAN_RTOL, err_msg=k)
    assert got["LPIPS_available"] == want["LPIPS_available"]


# -- SSIM -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 1, 48, 40), (4, 64, 64)])
def test_ssim_matches_jax(shape):
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 90, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 8, shape), 0, 90).astype(np.float32)
    got = ssim.cv2_parity_ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jssim.cv2_parity_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == shape[:-2] and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=SSIM_ATOL)
    k = ssim.gaussian_kernel_11_15()
    np.testing.assert_allclose(k.numpy(), jssim.gaussian_kernel_11_15(), rtol=1e-15)
    np.testing.assert_array_equal(torch.outer(k, k).float().numpy(),
                                  jssim._WINDOW.astype(np.float32))


def test_ssim_matches_cv2_filter2d():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 90, (48, 48)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 5, a.shape), 0, 90).astype(np.float32)
    window = np.outer(cv2.getGaussianKernel(11, 1.5), cv2.getGaussianKernel(11, 1.5).T)

    def filt(img):
        return cv2.filter2D(img, -1, window)[5:-5, 5:-5]

    x, y = a.astype(np.float64), b.astype(np.float64)
    mu1, mu2 = filt(x), filt(y)
    s1, s2, s12 = filt(x * x) - mu1**2, filt(y * y) - mu2**2, filt(x * y) - mu1 * mu2
    c1, c2 = (0.01 * 90) ** 2, (0.03 * 90) ** 2
    want = (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1**2 + mu2**2 + c1) * (s1 + s2 + c2))).mean()
    got = float(ssim.cv2_parity_ssim(torch.from_numpy(a)[None], torch.from_numpy(b)[None])[0])
    np.testing.assert_allclose(got, want, atol=SSIM_CV2_ATOL)
    same = ssim.cv2_parity_ssim(torch.from_numpy(a)[None], torch.from_numpy(a)[None])
    assert float(same[0]) == pytest.approx(1.0, abs=SSIM_ATOL)


# -- the evaluator ----------------------------------------------------------

def on_the_thresholds(rng, shape) -> np.ndarray:
    """Frames whose pixels sit on k/90 (fp32) for k next to every threshold,
    and on values whose fp32 product with 90 lands just below one."""
    ks = np.array([k + d for k in THRESHOLDS for d in (-1, 0, 1)] + [0, 90], np.float32)
    on = ks / np.float32(90)
    below = np.nextafter(on, np.float32(0))
    pool = np.concatenate([on, below]).astype(np.float32)
    return rng.choice(pool, size=shape).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "on_the_thresholds"])
def test_evaluator_streams_two_batches_as_jax(case):
    rng = np.random.default_rng(2)
    shape = (3, 4, 32, 32)
    if case == "random":
        gt = rng.uniform(-0.1, 1.1, shape).astype(np.float32)  # clipped to [0, 1]
        pred = np.clip(gt + rng.normal(0, 0.2, shape), 0, 1).astype(np.float32)
    else:
        gt, pred = on_the_thresholds(rng, shape), on_the_thresholds(rng, shape)
    ours, ref = evaluators()
    for sl in (slice(0, 2), slice(2, 3)):
        ours.evaluate(pred[sl], gt[sl])  # the CLIs' (preds, gts) orientation
        ref.evaluate(pred[sl], gt[sl])
    assert ours.total == ref.total == 3
    for thr in THRESHOLDS:
        for cell in CELLS:
            assert ours.metrics[thr][cell] == ref.metrics[thr][cell], (thr, cell)
    for k in ("mae", "mse", "ssim"):
        np.testing.assert_allclose(ours.losses[k], ref.losses[k], rtol=MEAN_RTOL, atol=SSIM_ATOL,
                                   err_msg=k)
    got, want = ours.done(), ref.done()
    assert_results_match(got, want)
    assert np.isnan(got["LPIPS"]) and not got["LPIPS_available"]
    if case == "on_the_thresholds":  # every threshold is hit and missed
        for thr in THRESHOLDS:
            m = got["threshold_metrics"][thr]
            assert min(m["TP"], m["TN"], m["FP"], m["FN"]) > 0
    ours.reset()
    assert ours.total == 0 and ours.losses["mse"] == [] and ours.metrics[20]["hits"] == []


def test_evaluator_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluator.SimplifiedEvaluator(20, 90)


def test_uint8_wire_ground_truths_are_jax_bit_for_bit(params):
    """Every one of the 256 levels on the uint8 wire: the port's collected
    ground truths equal, in every bit, the JAX trainer's, which divides by
    255 (adnm_tpu/train/loop.py:555-557; x * (1/255) differs from it in the
    last bit at 126 levels), so both evaluators count alike."""
    rng = np.random.default_rng(4)
    q = np.empty((2, 7, 1, 32, 32), np.uint8)
    q[:, :5] = rng.integers(0, 256, (2, 5, 1, 32, 32))
    q[:, 5:] = (np.arange(2 * 2 * 32 * 32) % 256).reshape(2, 2, 1, 32, 32)
    _, preds, gts = port_trainer(params).eval_epoch([q], collect=True)
    jgts = q[:, 5:, 0].astype(np.float32) / 255.0
    assert gts.dtype == np.float32 and gts.shape == (2, 2, 32, 32)
    np.testing.assert_array_equal(gts, jgts)
    assert set(np.rint(gts * 255).astype(int).ravel()) == set(range(256))
    ours, ref = evaluators()
    ours.evaluate(preds, gts)
    ref.evaluate(preds, jgts)
    for thr in THRESHOLDS:
        for cell in CELLS:
            assert ours.metrics[thr][cell] == ref.metrics[thr][cell], (thr, cell)


def test_the_slice_evaluates_as_jax(params, clips, jax_preds):
    """The TINY model's predictions on two synthetic clips from the same
    params (the port's eval_epoch, the JAX forward), then each package's
    evaluator."""
    _, preds, gts = port_trainer(params).eval_epoch([clips], collect=True)
    jpreds = jax_preds
    np.testing.assert_allclose(preds, jpreds, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_array_equal(gts, clips[:, 5:, 0])
    ours, ref = evaluators()
    ours.evaluate(preds, gts)
    ref.evaluate(jpreds, gts)
    # obs comes from the predictions (the reference orientation): a pixel
    # whose two predictions straddle a threshold moves between the
    # observed and the unobserved cells, and nothing else may move
    level = np.floor(np.clip(preds, 0, 1) * np.float32(90))
    jlevel = np.floor(np.clip(jpreds, 0, 1) * np.float32(90))
    sim_all = np.floor(np.clip(gts, 0, 1) * np.float32(90))
    straddles = 0
    for thr in THRESHOLDS:
        obs, jobs, sim = level >= thr, jlevel >= thr, sim_all >= thr
        straddles += int((obs != jobs).sum())
        want_delta = [(o & s).sum((-2, -1)) - (jo & s).sum((-2, -1))
                      for o, jo, s in ((obs, jobs, sim), (obs, jobs, ~sim),
                                       (~obs, ~jobs, sim), (~obs, ~jobs, ~sim))]
        for cell, delta in zip(CELLS, want_delta):
            got = np.array(ours.metrics[thr][cell]) - np.array(ref.metrics[thr][cell])
            np.testing.assert_array_equal(got, delta, err_msg=f"{thr} {cell}")
    print(f"pixels straddling a threshold: {straddles} of {level.size * len(THRESHOLDS)}")
    for k in ("mae", "mse", "ssim"):
        np.testing.assert_allclose(ours.losses[k], ref.losses[k], rtol=MEAN_RTOL, atol=SSIM_ATOL,
                                   err_msg=k)


# -- LPIPS ------------------------------------------------------------------

def lpips_weights(path) -> str:
    rng = np.random.default_rng(5)
    arrays = {}
    for i, (cout, k, cin) in enumerate([(64, 11, 3), (192, 5, 64), (384, 3, 192),
                                        (256, 3, 384), (256, 3, 256)]):
        arrays[f"conv{i}_w"] = rng.normal(0, 0.05, (cout, cin, k, k)).astype(np.float32)
        arrays[f"conv{i}_b"] = rng.normal(0, 0.01, (cout,)).astype(np.float32)
        arrays[f"lin{i}_w"] = rng.uniform(0, 0.1, (1, cout, 1, 1)).astype(np.float32)
    np.savez(path, **arrays)
    return str(path)


def test_lpips_matches_jax_with_random_weights(tmp_path, monkeypatch):
    path = lpips_weights(tmp_path / "lpips_alex.npz")
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (2, 2, 64, 64)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = lpips.LpipsAlex(path)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jlpips.LpipsAlex(path)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == (2, 2) and np.all(got > 0)
    np.testing.assert_allclose(got, want, atol=LPIPS_ATOL)
    # through the evaluators, which load the weights named by the variable
    monkeypatch.setenv("ADNM_LPIPS_WEIGHTS", path)
    ours = evaluator.SimplifiedEvaluator(2, 90, device="cpu")
    ref = jevaluator.SimplifiedEvaluator(2, 90)
    ours.evaluate(a, b)
    ref.evaluate(a, b)
    r_ours, r_ref = ours.done(), ref.done()
    assert r_ours["LPIPS_available"] and r_ref["LPIPS_available"]
    np.testing.assert_allclose(r_ours["LPIPS"], r_ref["LPIPS"], atol=LPIPS_ATOL)


def test_lpips_without_weights_is_nan_and_flagged(monkeypatch):
    monkeypatch.delenv("ADNM_LPIPS_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="ADNM_LPIPS_WEIGHTS"):
        lpips.default_lpips()
    with pytest.warns(UserWarning, match="LPIPS disabled"):
        ours = evaluator.SimplifiedEvaluator(2, 90, device="cpu")
    x = np.random.default_rng(7).uniform(0, 1, (1, 2, 16, 16)).astype(np.float32)
    ours.evaluate(x, x)
    res = ours.done()
    assert np.isnan(res["LPIPS"]) and res["LPIPS_available"] is False
    assert np.isfinite(res["SSIM"]) and res["RMSE"] == 0.0


# -- strips, logging, profiling ---------------------------------------------

def test_gray2color_equals_jax():
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(colormap.gray2color(img), jcolormap.gray2color(img))
    assert (colormap.BOUNDS, colormap.THRESHOLDS) == (jcolormap.BOUNDS, jcolormap.THRESHOLDS)
    np.testing.assert_array_equal(colormap.COLOR_MAP, jcolormap.COLOR_MAP)


@pytest.mark.parametrize("even", [False, True])
def test_strips_are_pixel_equal_to_jax(tmp_path, even):
    from PIL import Image

    rng = np.random.default_rng(8)
    pred, gt = rng.uniform(0, 1, (20, 16, 24)), rng.uniform(0, 1, (20, 16, 24))
    inp = rng.uniform(0, 1, (5, 16, 24))
    for pkg, out in ((render, tmp_path / "port"), (jrender, tmp_path / "jax")):
        pkg.vis_res(pred, gt_seq=gt, input_seq=inp, save_path=str(out), pic_name="m",
                    even_index_only=even)
        pkg.vis_res_1b1(pred[:3], save_path=str(out / "1b1"))
    names = ["m.png", "gt.png", "input.png"] + [f"1b1/gt{i}.png" for i in range(3)]
    for name in names:
        got, want = Image.open(tmp_path / "port" / name), Image.open(tmp_path / "jax" / name)
        assert got.mode == want.mode == "RGBA" and got.size == want.size, name
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=name)
    frames = 10 if even else 20
    assert Image.open(tmp_path / "port" / "m.png").size == (frames * 24 + (frames - 1) * 10, 16)


def test_write_png_decodes_with_pil(tmp_path):
    from PIL import Image

    img = np.random.default_rng(9).integers(0, 256, (5, 7, 4)).astype(np.uint8)
    render.write_png(str(tmp_path / "x.png"), img)
    back = Image.open(tmp_path / "x.png")
    assert back.mode == "RGBA" and png_header(str(tmp_path / "x.png")) == (7, 5, 6)
    np.testing.assert_array_equal(np.asarray(back), img)
    for bad in (img.astype(np.float32), img[:, :, :3], img[:, :, 0]):
        with pytest.raises(ValueError, match="uint8"):
            render.write_png(str(tmp_path / "y.png"), bad)


def test_metrics_logger_lines_carry_jax_keys(tmp_path, capsys):
    fields = dict(epoch=1, train_loss=np.float32(0.5), val_loss=0.25, steps=3)
    for pkg, name in ((plogging, "port.jsonl"), (jlogging, "jax.jsonl")):
        pkg.MetricsLogger(str(tmp_path / "sub" / name), echo=True).log(**fields)
    port, ref = ((tmp_path / "sub" / n).read_text().splitlines() for n in ("port.jsonl",
                                                                         "jax.jsonl"))
    (p,), (j,) = (json.loads(x) for x in port), (json.loads(x) for x in ref)
    assert p.keys() == j.keys() == {*fields, "ts"}
    assert {k: p[k] for k in fields} == {k: j[k] for k in fields}
    assert capsys.readouterr().out.count('"epoch": 1') == 2


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as d:
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert d == str(tmp_path / "trace") and trace["traceEvents"]
    lines = []
    with profiling.step_timer("s", log_fn=lines.append) as box:
        pass
    assert box["seconds"] >= 0 and lines[0].startswith("[s] ")


# -- the entry points' precision and what they import -----------------------

@pytest.fixture
def tf32_on():
    """TF32 allowed, as PyTorch starts for cuDNN; put back afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_resolve_device_turns_tf32_off(tf32_on):
    assert device.tf32_enabled()
    assert device.resolve_device("cpu") == CPU
    assert not device.tf32_enabled()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    for api in (torch.backends.cuda.matmul, torch.backends.cudnn.conv):
        if hasattr(api, "fp32_precision"):
            assert api.fp32_precision == "ieee"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device.resolve_device("cuda")


def test_build_turns_tf32_off(tf32_on, tmp_path):
    import argparse

    p = argparse.ArgumentParser()
    common.add_common_args(p)
    args = p.parse_args(["--synthetic", "--img-size", "32", "--root", str(tmp_path),
                         "--device", "cpu"])
    trainer, loaders, shape = common.build(args)
    assert len(loaders) == 3 and shape == (5, 20, 6, THRESHOLDS)
    assert trainer.device == CPU and not device.tf32_enabled()
    with pytest.raises(ValueError, match="halvings"):
        common.build(p.parse_args(["--img-size", "48", "--device", "cpu"]))


def test_resolve_ckpt_takes_the_flag_then_the_best_checkpoint(tmp_path, capsys):
    best = pathlib.Path(best_ckpt_dir(str(tmp_path), "Shanghai", "ADNMUnet"))
    flag = tmp_path / "given"
    assert common.resolve_ckpt(str(flag), str(tmp_path), "missing {}") is None
    assert common.resolve_ckpt(None, str(tmp_path), "missing {}") is None
    assert capsys.readouterr().out.splitlines() == [f"missing {flag}", f"missing {best}"]
    best.parent.mkdir(parents=True)
    best.touch()
    flag.touch()
    assert common.resolve_ckpt(str(flag), str(tmp_path), "missing {}") == str(flag)
    assert common.resolve_ckpt(None, str(tmp_path), "missing {}") == str(best)
    assert capsys.readouterr().out == ""


def test_predict_load_model_turns_tf32_off(tf32_on):
    predict.load_model(None, "cpu")
    assert not device.tf32_enabled()


def test_port_imports_no_pil_or_cv2():
    files = [*(REPO / "adnm_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in ("PIL", "cv2", "jax", "adnm_tpu"), \
                    f"{path}: imports {n}"


# -- the reference importer -------------------------------------------------

def test_adnm_importer_carries_the_reference_state_dict(params, clips, jax_preds):
    """JAX's export of the TINY model's params -> the port's importer -> the
    port's forward equals the JAX forward; the port's export round-trips
    key for key; a missing key raises."""
    cfg = dict(TINY)
    sd = jimport.export_adnm_state_dict(params, **cfg)
    m = convert.from_jax_params(model.ADNMUNet(**TINY_KW),
                                adnm_import.convert_adnm_state_dict(sd, **cfg))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(clips[:, :5])).numpy()[:, :, 0]
    np.testing.assert_allclose(got, jax_preds, rtol=1e-5, atol=1e-5)
    back = adnm_import.export_adnm_state_dict(convert.to_jax_params(m), **cfg)
    assert list(back) == list(sd)
    # the leaves the JAX model never reads come back as their init value
    unread = set(convert.unread_leaves(m))
    names = adnm_import.adnm_name_map(**cfg)
    assert sum(names[k][0] in unread for k in sd) == len(unread) > 0
    for k in sd:
        if names[k][0] not in unread:
            np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    torch_sd = {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    flat = convert.flatten_tree(adnm_import.convert_adnm_state_dict(torch_sd, **cfg))
    ref_flat = convert.flatten_tree(jimport.convert_adnm_state_dict(sd, **cfg))
    assert flat.keys() == ref_flat.keys()
    assert all(np.array_equal(flat[k], ref_flat[k]) for k in flat)
    missing = dict(sd)
    del missing["decoder.fusion.att3.bias"]
    with pytest.raises(KeyError, match="att3.bias"):
        adnm_import.convert_adnm_state_dict(missing, **cfg)


# -- the CLIs, on the CPU, at 32^2 ------------------------------------------

CLI_ARGS = ["--synthetic", "--synthetic-len", "8", "--img-size", "32", "--batch-size", "2",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the full-width model through the train CLI, with an
    epoch snapshot; the final protocol evaluates the trained weights (the
    best checkpoint is gated to epochs > 34)."""
    root = tmp_path_factory.mktemp("run")
    out = train_cli.main(CLI_ARGS + ["--epochs", "1", "--save-every", "1", "--root", str(root)])
    snapshot = best_ckpt_dir(str(root), "Shanghai", "ADNMUnet") + "_epoch1"
    yield root, snapshot, out
    shutil.rmtree(root)  # after the module's last test: the snapshot is 851 MB


def test_train_cli_ends_with_the_csi_table(trained, capsys):
    root, snapshot, out = trained
    res = out["metrics"]
    assert pathlib.Path(snapshot).exists()
    assert set(res["threshold_metrics"]) == set(THRESHOLDS)
    for m in res["threshold_metrics"].values():
        assert m["TP"] + m["FN"] + m["FP"] + m["TN"] == 20 * 32 * 32  # one test clip
    assert np.isfinite([res["RMSE"], res["SSIM"], res["FAR"]]).all()
    assert np.isnan(res["LPIPS"]) and not res["LPIPS_available"]
    (line,) = (root / "results" / "Shanghai" / "ADNMUnet_train.jsonl").read_text().splitlines()
    assert set(json.loads(line)) == {"epoch", "train_loss", "val_loss", "test_loss", "lr",
                                     "grad_norm", "clip_threshold", "clip_ratio", "steps",
                                     "seconds", "ts"}


@pytest.fixture(scope="module")
def validated(trained):
    root, snapshot, _ = trained
    return validate_cli.main(CLI_ARGS + ["--root", str(root), "--ckpt", snapshot])


def test_validate_cli_reproduces_the_train_clis_figures(trained, validated, capsys):
    root, snapshot, out = trained
    got = validated
    assert got["trainer"].device == CPU and got["preds"].shape == (1, 20, 32, 32)
    want = out["metrics"]
    for thr in THRESHOLDS:
        g, w = got["metrics"]["threshold_metrics"][thr], want["threshold_metrics"][thr]
        assert {k: g[k] for k in ("TP", "FN", "FP", "TN")} == \
            {k: w[k] for k in ("TP", "FN", "FP", "TN")}
    assert got["metrics"]["RMSE"] == want["RMSE"] and got["metrics"]["SSIM"] == want["SSIM"]
    assert got["test_loss"] == out["test_loss"]
    capsys.readouterr()
    fresh = validate_cli.main(CLI_ARGS + ["--root", str(root)])  # no best checkpoint
    text = capsys.readouterr().out
    assert "evaluating fresh init" in text and "POD:" in text and "LPIPS: UNAVAILABLE" in text
    assert fresh["metrics"]["RMSE"] != want["RMSE"]


def test_predict_cli_serves_the_train_clis_checkpoint(trained, validated, tmp_path, capsys):
    root, snapshot, _ = trained
    val = validated
    from adnm_tpu_torch.data.shanghai import ShanghaiDataset

    clip = ShanghaiDataset(None, 32, "test", synthetic_len=8)[0]
    np.save(tmp_path / "x.npy", clip[:5])
    args = ["--input", str(tmp_path / "x.npy"), "--output", str(tmp_path / "y.npy"),
            "--img-size", "32", "--device", "cpu", "--png", str(tmp_path / "png")]
    got = predict.main(args + ["--ckpt", snapshot])
    assert f"loaded checkpoint: {snapshot}" in capsys.readouterr().out
    np.testing.assert_allclose(got[0, :, 0], val["preds"][0], rtol=0, atol=1e-5)
    strips = tmp_path / "png" / "sample0"
    assert png_header(str(strips / "pred.png")) == (20 * 32 + 19 * 10, 32, 6)
    assert png_header(str(strips / "input.png")) == (5 * 32 + 4 * 10, 32, 6)
    # without --ckpt: the best checkpoint under --root, else the seeded init
    seeded = predict.main(args + ["--root", str(root)])
    assert "predicting with fresh init" in capsys.readouterr().out
    assert not np.allclose(seeded, got)


def test_load_model_serves_a_bimamba_checkpoint(tmp_path):
    from adnm_tpu_torch.train import checkpoint as ckpt

    src = model.create_adnm_unet(5, 20, 6, linear_attn_duality=False)
    ckpt.save_state(str(tmp_path / "c"), {"params": src.state_dict(), "step": 0})
    m = predict.load_model(None, "cpu", ckpt=str(tmp_path / "c"), linear_attn_duality=False)
    for (name, p), q in zip(src.state_dict().items(), m.state_dict().values()):
        assert torch.equal(p, q), name
    with pytest.raises(RuntimeError, match="state_dict"):  # the VSSD mixer's own layout
        predict.load_model(None, "cpu", ckpt=str(tmp_path / "c"), linear_attn_duality=False,
                           mixer_type="vssd")
    (tmp_path / "c").unlink()  # checked: a full-width checkpoint


def test_visualize_cli_writes_strips(trained, tmp_path, capsys):
    root, snapshot, _ = trained
    written = visualize_cli.main(CLI_ARGS + ["--root", str(root), "--ckpt", snapshot,
                                             "--out", str(tmp_path), "--max-samples", "2"])
    assert written == [str(tmp_path / "ADNMUnet" / "sample0")]  # the test split's one clip
    d = written[0]
    assert png_header(f"{d}/ADNMUnet.png") == (10 * 32 + 9 * 10, 32, 6)  # every second frame
    assert png_header(f"{d}/gt.png") == (10 * 32 + 9 * 10, 32, 6)
    assert png_header(f"{d}/input.png") == (5 * 32 + 4 * 10, 32, 6)
    # without --ckpt and without a best checkpoint: the fresh init, said so
    written = visualize_cli.main(CLI_ARGS + ["--root", str(tmp_path), "--out", str(tmp_path),
                                             "--max-samples", "1"])
    assert "rendering fresh init" in capsys.readouterr().out and len(written) == 1
