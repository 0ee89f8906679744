"""The PyTorch port's training path against the JAX package, on the CPU.

The model is the TINY configuration of ``tests/test_train_modes.py`` (32^2,
5 -> 2 frames, kernel (3, 3, 3), widths 8), with every weight drawn by
numpy and carried into the port by ``convert.from_jax_params``; the port's
gradients go back to the JAX tree through ``convert.to_jax_params`` and
are compared leaf by leaf. Each JAX trainer is built once per module.

Tolerances. Gradients: fp32 on both sides, sums in another order through
some 60 layers forward and back; leaves are compared by relative L2 error
(1e-4) and elementwise with an atol of 1e-4 of the leaf's largest entry.
Trajectories: AdamW at eps = 1e-9 turns an update into about
lr * sign(g), so a rounding-level difference in a near-zero gradient flips
a parameter by 2 * lr; after three steps the parameters are held to the
sign-flip band of ``test_train_modes.py`` (atol 3e-3 at lr 1e-3).
"""

from __future__ import annotations

import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.data import loader as jloader
from adnm_tpu.data import shanghai as jshanghai
from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu.train import Trainer as JTrainer
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.data import loader, shanghai
from adnm_tpu_torch.models import adnm_unet as model
from adnm_tpu_torch.train import checkpoint as ckpt
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_layers import one_torch_thread, random_params  # noqa: F401 (a fixture)
from test_train_modes import TINY, _batches

CPU = torch.device("cpu")
TINY_KW = dict(channels=5, out_channels=2, kernel=(3, 3, 3), **TINY)
GRAD_RTOL = 1e-4  # relative L2 error of one leaf's gradient
GRAD_ATOL = 1e-6  # L2 error of one leaf, relative to the global gradient norm
SMALL_LEAF = 64  # bf16: gradient tensors of fewer values are held as one vector


# the leaves the JAX model creates and never reads
UNREAD = frozenset(convert.unread_leaves(model.ADNMUNet(**TINY_KW)))


def unread(key: str) -> bool:
    return key in UNREAD


@pytest.fixture(scope="module")
def params():
    return random_params(jmodel.ADNMUNet(**TINY_KW), jnp.zeros((1, 5, 1, 32, 32)), train=True)


@pytest.fixture(scope="module")
def jax_trainer(params):
    t = JTrainer(jmodel.ADNMUNet(**TINY_KW), jget_preset("ADNMUnet", 5, 2, 6, "Shanghai"),
                 input_frames=5, output_frames=2, img_size=32, seed=0)
    t.state = t.state.replace(params=jax.tree.map(jnp.asarray, params))
    return t


@pytest.fixture(scope="module")
def jax_grads(jax_trainer):
    (batch,) = _batches(1, 2)
    loss, grads, _ = jax.jit(jax_trainer._grads_impl)(jax_trainer.state, batch)
    return batch, float(loss), convert.flatten_tree(jax.device_get(grads))


def port_trainer(params, **kw) -> Trainer:
    mkw = {k: kw.pop(k) for k in ("refiner_remat", "linear_attn_duality") if k in kw}
    t = Trainer(model.ADNMUNet(**TINY_KW, **mkw), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"),
                5, CPU, seed=0, **kw)
    convert.from_jax_params(t.model, params)
    return t


def flat_grads(t: Trainer, grads) -> dict:
    return convert.flatten_tree(convert.to_jax_params(t.model, grads))


def assert_grads_close(got: dict, want: dict, rtol: float = GRAD_RTOL):
    """Leaf by leaf: ||g - w|| <= rtol ||w|| + GRAD_ATOL ||all of w||. The
    second term covers the gates whose gradients are rounding-sized."""
    assert got.keys() == want.keys()
    total = float(np.sqrt(sum(np.sum(np.square(w)) for w in want.values())))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        err, norm = float(np.linalg.norm(g - w)), float(np.linalg.norm(w))
        assert err <= rtol * norm + GRAD_ATOL * total, (k, err, norm, total)


def test_loss_and_every_gradient_match_jax(params, jax_grads):
    batch, loss_want, want = jax_grads
    t = port_trainer(params)
    loss, grads = t.grads(batch)
    np.testing.assert_allclose(float(loss), loss_want, rtol=1e-5)
    assert_grads_close(flat_grads(t, grads), want)
    # the leaves the JAX model never reads get no gradient on either side
    assert not any(np.any(want[k]) for k in want if unread(k))


def test_bf16_loss_and_every_gradient_match_the_jax_trainer_in_bf16(params, jax_trainer,
                                                                     jax_grads):
    """The trainer in bf16 compute (fp32 parameters and gradients) against
    this module's JAX trainer with ``compute_dtype`` bfloat16 (only
    ``_split_batch`` reads it). Yardstick: d, JAX's own bf16-vs-fp32
    distance (against ``jax_grads``); the port within 2 d of JAX in bf16,
    never below one bf16 rounding (2^-8): the loss, the whole gradient,
    each gradient tensor of at least SMALL_LEAF values, and the smaller ones
    (gates, norm weights, biases) as one vector. A tensor of a few values
    has no distance of its own to speak of: its d is a handful of rounding
    errors, as likely near 0 as not (a gate's d was 9e-8 beside 6e-6 from
    the port)."""
    batch, loss32, want32 = jax_grads
    jax_trainer.compute_dtype = jnp.bfloat16
    try:
        loss16, grads16, _ = jax.jit(jax_trainer._grads_impl)(jax_trainer.state, batch)
    finally:
        jax_trainer.compute_dtype = jnp.float32
    want16 = convert.flatten_tree(jax.device_get(grads16))
    t = port_trainer(params, compute_dtype=torch.bfloat16)
    loss, grads = t.grads(batch)
    assert all(g.dtype == torch.float32 for g in grads.values())
    got = flat_grads(t, grads)
    assert got.keys() == want16.keys()

    def check(name, g, w16, w32):
        g, w16, w32 = (np.asarray(a, np.float64).ravel() for a in (g, w16, w32))
        d, e = np.linalg.norm(w16 - w32), np.linalg.norm(g - w16)
        assert e <= max(2 * d, 2.0 ** -8 * np.linalg.norm(w16)), (name, e, d)

    check("loss", float(loss), float(loss16), loss32)
    leaves = [(k, got[k], want16[k], want32[k]) for k in want16]
    for k, g, w16, w32 in leaves:
        if np.size(w16) >= SMALL_LEAF:
            check(k, g, w16, w32)
    for name, keep in (("small leaves", lambda n: n < SMALL_LEAF), ("all", lambda n: True)):
        check(name, *(np.concatenate([np.ravel(leaf[i]) for leaf in leaves if keep(np.size(leaf[2]))])
                      for i in (1, 2, 3)))


def test_three_step_trajectory_stays_in_the_sign_flip_band(params, jax_trainer):
    batches = _batches(3, 2)
    state0 = jax_trainer.state
    jax_trainer.state = jax.tree.map(jnp.copy, state0)  # train_epoch donates the state
    try:
        want = jax_trainer.train_epoch(list(batches), lr=1e-3, clip_norm=0.025)
        want_params = convert.flatten_tree(jax.device_get(jax_trainer.state.params))
    finally:
        jax_trainer.state = state0
    t = port_trainer(params)
    got = t.train_epoch(list(batches), lr=1e-3, clip_norm=0.025)
    assert got["steps"] == want["steps"] == 3 and t.step == 3
    assert got["clip_ratio"] == want["clip_ratio"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=5e-3)
    np.testing.assert_allclose(got["avg_grad_norm"], want["avg_grad_norm"], rtol=2e-2)
    got_params = convert.flatten_tree(convert.to_jax_params(t.model))
    assert got_params.keys() == want_params.keys()
    for k in filter(lambda k: not unread(k), want_params):
        np.testing.assert_allclose(got_params[k], want_params[k], rtol=1e-2, atol=3e-3,
                                   err_msg=k)


def test_global_norm_and_clip_match_the_jax_step(params, jax_trainer):
    """One step: the global fp32 gradient norm, the clip scale and the AdamW
    update (its first step moves each parameter by about lr)."""
    (batch,) = _batches(1, 2)
    # the step train_epoch compiled; it donates the copy of the state
    _, loss_w, gnorm_w = jax_trainer._train_step(jax.tree.map(jnp.copy, jax_trainer.state),
                                                 batch, jnp.float32(1e-3), jnp.float32(0.025))
    t = port_trainer(params)
    before = {n: p.detach().clone() for n, p in t.model.named_parameters()}
    loss, gnorm = t.train_step(torch.from_numpy(batch), 1e-3, 0.025)
    np.testing.assert_allclose(float(loss), float(loss_w), rtol=1e-5)
    np.testing.assert_allclose(float(gnorm), float(gnorm_w), rtol=1e-4)
    moved = max(float((p.detach() - before[n]).abs().max())
                for n, p in t.model.named_parameters())
    assert 5e-4 < moved < 1.5e-3


def test_accumulated_gradients_equal_the_full_batch(params):
    (batch,) = _batches(1, 4)
    full, acc = port_trainer(params), port_trainer(params, accum_steps=2)
    loss_f, g_f = full.grads(batch)
    loss_a, g_a = acc.grads(batch)
    np.testing.assert_allclose(float(loss_a), float(loss_f), rtol=1e-5)
    assert_grads_close(flat_grads(acc, g_a), flat_grads(full, g_f), rtol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        acc.grads(batch[:3])


@pytest.mark.parametrize("remat_forward", [False, True])
def test_remat_gives_the_same_gradients(params, remat_forward):
    """Refiner remat on and off, and the whole forward under checkpoint:
    the recompute repeats the same fp32 operations."""
    (batch,) = _batches(1, 2)
    off = port_trainer(params, refiner_remat=False)
    on = port_trainer(params, refiner_remat=True, remat_forward=remat_forward)
    assert on.model.refiner.remat and not off.model.refiner.remat
    loss_off, g_off = off.grads(batch)
    loss_on, g_on = on.grads(batch)
    assert float(loss_on) == float(loss_off)
    for name in g_off:
        torch.testing.assert_close(g_on[name], g_off[name], rtol=1e-6, atol=1e-9)


def test_uint8_wire_format_matches_the_float_path_on_quantized_data(params):
    (fbatch,) = _batches(1, 2)
    q = np.clip(np.rint(fbatch * 255.0), 0, 255).astype(np.uint8)
    f = q.astype(np.float32) * np.float32(1.0 / 255.0)
    t = port_trainer(params)
    loss_u, g_u = t.grads(q)
    g_u = {k: v.clone() for k, v in g_u.items()}
    loss_f, g_f = t.grads(f)
    np.testing.assert_allclose(float(loss_u), float(loss_f), rtol=1e-6)
    for name in g_f:
        torch.testing.assert_close(g_u[name], g_f[name], rtol=1e-4, atol=1e-7)
    loss, preds, gts = t.eval_epoch([q], collect=True)
    assert np.isfinite(loss) and preds.shape == gts.shape == (2, 2, 32, 32)
    np.testing.assert_allclose(gts, q[:, 5:, 0].astype(np.float32) / 255.0, rtol=1e-6)


def test_preset_matches_jax_for_forty_epochs():
    for interval in (6, 30):  # instance norm on and off
        want, got = (f("ADNMUnet", 5, 20, interval, "Shanghai") for f in (jget_preset, get_preset))
        assert (got.epochs, got.early_stop, got.clip_schedule.save_epoch, got.weight_decay,
                got.adam_eps, got.base_lr) == (want.epochs, want.early_stop, want.save_epoch,
                                               want.weight_decay, want.adam_eps, want.base_lr)
        assert want.norm_clip and want.save_epoch_gated and want.if_early_stop
        assert got.clip_schedule.__dict__ == want.clip_schedule.__dict__
        for epoch in range(1, 41):
            assert got.lr_at_epoch(epoch, 40) == want.lr_at_epoch(epoch, 40)
            for prev in (0.0, 0.0123, 1.7):
                assert got.clip_schedule.threshold(epoch, prev) == \
                    want.clip_schedule.threshold(epoch, prev)
    for name in ("TransUnet", "SwinUnet"):  # SmaAt-UNet's SGD preset, no early stop
        want, got = (f(name, 5, 20, 6, "Shanghai") for f in (jget_preset, get_preset))
        fields = ("opt_family", "base_lr", "momentum", "weight_decay", "if_early_stop",
                  "early_stop", "norm_clip", "save_epoch_gated", "epochs")
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
        assert got.lr_at_epoch is None and want.lr_at_epoch is None


def test_adamw_is_optax_adamw():
    """Three AdamW steps with optax's constants: decoupled decay, eps
    outside the square root."""
    import optax

    rng = np.random.RandomState(0)
    p0, grads = rng.randn(64).astype(np.float32), rng.randn(3, 64).astype(np.float32) * 1e-3
    tx = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-9, weight_decay=1e-2)
    pj, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = get_preset("ADNMUnet", 5, 20, 6, "Shanghai").make_optimizer([pt])
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-8)


def test_synthetic_clips_and_loader_order_equal_jax():
    for raw in (0, 7, 20_003):
        np.testing.assert_array_equal(
            shanghai._synthetic_clip(np.random.default_rng(raw), 7, 32),
            jshanghai._synthetic_clip(np.random.default_rng(raw), 7, 32))
    kw = dict(img_size=16, split="train", synthetic_len=20, seq_len=3)
    ds, jds = shanghai.ShanghaiDataset(None, **kw), jshanghai.ShanghaiDataset(None, **kw)
    assert len(ds) == len(jds) == 14
    for split, n in (("val", 3), ("test", 3)):
        assert len(shanghai.ShanghaiDataset(None, 16, split, synthetic_len=20)) == n
    for shuffle, drop_last in ((True, True), (False, False)):
        ld = loader.BatchLoader(ds, 4, shuffle=shuffle, drop_last=drop_last, seed=5)
        jld = jloader.BatchLoader(jds, 4, shuffle=shuffle, drop_last=drop_last, seed=5)
        assert len(ld) == len(jld)
        for _ in range(2):  # two epochs: the shuffle reseeds with seed + epoch
            got, want = list(ld), list(jld)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("size, levels, atol", [(64, None, 2e-3), (256, 70, 1e-5)])
def test_resize_matches_jax_image_resize(size, levels, atol):
    """F.interpolate(bilinear, antialias) against jax.image.resize at the
    Shanghai downscale (565 x 784 -> 64, and -> 256, the loader's wire size,
    on radar-like frames of integers 0-70 over 255) and an upscale. Both
    filter with a triangle kernel widened by the scale; they differ in fp32
    rounding of the weights and sums, and at 64 by up to 2e-3 where torch's
    kernel support stops a fraction of a pixel sooner at the downscaled
    edges. At 256 they agree to 6e-8 on these frames (2.4e-7 on uniform
    random ones), far under one uint8 level (3.9e-3)."""
    rng = np.random.RandomState(0)
    if levels is None:
        frames = rng.rand(2, 565, 784).astype(np.float32)
    else:
        frames = (rng.randint(0, levels + 1, (2, 565, 784)) / 255).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(frames), (2, size, size), "bilinear",
                                       antialias=True))
    got = shanghai._resize_bilinear_antialias(frames, size)
    assert got.shape == (2, size, size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol)
    small = rng.rand(1, 20, 20).astype(np.float32)
    np.testing.assert_allclose(
        shanghai._resize_bilinear_antialias(small, 32),
        np.asarray(jax.image.resize(jnp.asarray(small), (1, 32, 32), "bilinear",
                                    antialias=True)), atol=1e-5)


def test_checkpoint_round_trip_keeps_the_targets_missing_keys(params, tmp_path):
    (batch,) = _batches(1, 2)
    t = port_trainer(params)
    t.train_step(torch.from_numpy(batch), 1e-3, 0.025)
    path = ckpt.best_ckpt_dir(str(tmp_path), "Shanghai", "ADNMUnet")
    assert path.endswith(os.path.join("model_params", "Shanghai", "ADNMUnet", "ADNMUnet_best"))
    ckpt.save_state(path, t.state_dict())
    fresh = port_trainer(params)
    fresh.load(path)
    assert fresh.step == 1
    for (name, p), q in zip(t.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(p, q), name
    # the optimizer's moments came back: the next step is the same
    t.train_step(torch.from_numpy(batch), 1e-3, 0.025)
    fresh.train_step(torch.from_numpy(batch), 1e-3, 0.025)
    for p, q in zip(t.model.parameters(), fresh.model.parameters()):
        assert torch.equal(p, q)
    # a file without a key leaves the target's value
    ckpt.save_state(str(tmp_path / "params_only"), {"params": t.model.state_dict()})
    merged = ckpt.restore_state(str(tmp_path / "params_only"), {"params": {}, "step": 7})
    assert merged["step"] == 7 and merged["params"].keys() == t.model.state_dict().keys()


def test_reference_init_changes_the_jax_leaf_set(params):
    """The same leaves as JAX's ``apply_reference_init``: Dense kernels
    redrawn (trunc-normal 0.02 within 2 std, or the rescaled kaiming
    bound for out_proj/fc2), their biases zeroed, everything else kept."""
    want = convert.flatten_tree(jax.device_get(
        jmodel.apply_reference_init(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(1))))
    flat = convert.flatten_tree(params)
    changed_jax = {k for k in flat if not np.array_equal(flat[k], want[k])}
    assert not any(unread(k) for k in changed_jax)
    m = convert.from_jax_params(model.ADNMUNet(**TINY_KW), params)
    model.apply_reference_init(m, torch.Generator().manual_seed(1))
    got = convert.flatten_tree(convert.to_jax_params(m))
    changed_port = {k for k in flat if not unread(k) and not np.array_equal(flat[k], got[k])}
    assert changed_port == changed_jax and len(changed_port) > 20
    for k in changed_port:
        leaf = k.rsplit("/", 1)[1]
        if leaf == "bias":
            assert not got[k].any(), k
            continue
        assert leaf == "kernel" and got[k].ndim == 2, k
        if k.split("/")[-2] in ("out_proj", "fc2"):
            bound = 1.0 / math.sqrt(got[k].shape[0]) / math.sqrt(3)
        else:
            bound = 0.04
            assert 0.01 < got[k].std() < 0.03 or got[k].size < 50, k
        assert np.abs(got[k]).max() <= bound * (1 + 1e-6), k


def test_to_jax_params_round_trips_and_is_strict(params):
    m = convert.from_jax_params(model.ADNMUNet(**TINY_KW), params)
    back = convert.flatten_tree(convert.to_jax_params(m))
    flat = convert.flatten_tree(params)
    assert back.keys() == flat.keys()
    for k in flat:
        if unread(k):  # their JAX init value
            assert np.all(back[k] == 1.0), k
        else:
            np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    grads = {n: torch.zeros_like(p) for n, p in m.named_parameters()}
    name = next(iter(grads))
    with pytest.raises(KeyError):
        convert.to_jax_params(m, {k: v for k, v in grads.items() if k != name})
    with pytest.raises(ValueError, match=name):
        convert.to_jax_params(m, {**grads, name: torch.zeros(3)})


def test_train_cli_end_to_end_and_resume(tmp_path, capsys):
    """The full-width create_adnm_unet(5, 20, 6) at 32^2 through the CLI:
    one epoch of 2 steps, validation, an epoch snapshot (--save-every), the
    final test loss and CSI table; then --resume from a best checkpoint. The preset saves
    the best checkpoint only after epoch 34 (the reference's save gate), so
    one epoch writes none and the final protocol keeps the trained weights."""
    args = ["--synthetic", "--synthetic-len", "8", "--img-size", "32", "--batch-size", "2",
            "--epochs", "1", "--root", str(tmp_path), "--device", "cpu"]
    out = train_cli.main(args + ["--save-every", "1"])
    (log,) = out["logs"]
    trainer = out["trainer"]
    assert trainer.step == 2 and np.isfinite(log.train_loss) and np.isfinite(log.val_loss)
    assert np.isfinite(out["test_loss"]) and out["test_loss"] > 0
    path = ckpt.best_ckpt_dir(str(tmp_path), "Shanghai", "ADNMUnet")
    assert not os.path.exists(path) and os.path.exists(path + "_epoch1")
    assert (tmp_path / "results" / "Shanghai" / "ADNMUnet_train.jsonl").exists()
    text = capsys.readouterr().out
    assert "20mm CSI:" in text and "40mm CSI:" in text and "HSS:" in text and "FAR:" in text
    assert "LPIPS: UNAVAILABLE" in text and set(out["metrics"]["threshold_metrics"]) == \
        {20, 30, 35, 40}
    ckpt.save_state(path, trainer.state_dict())
    again = train_cli.main(args + ["--resume", "--no-final-eval"])
    assert again["trainer"].step == 4 and again["test_loss"] is None
    assert "resumed from" in capsys.readouterr().out
    shutil.rmtree(tmp_path / "model_params")  # checked: 1.7 GB of full-width checkpoints


def test_train_cli_refuses_what_is_not_ported(tmp_path):
    base = ["--synthetic", "--img-size", "32", "--root", str(tmp_path), "--device", "cpu"]
    # LAPS and bf16 for every model are ported (test_torch_port_laps.py,
    # test_torch_port_bf16_baselines.py); another dataset is refused
    with pytest.raises(SystemExit):
        train_cli.main(base + ["--dataset", "SEVIR"])
    with pytest.raises(SystemExit, match="only supported for --model TransUnet"):
        train_cli.main(base + ["--pretrained-npz", str(tmp_path / "r50_vit.npz")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--synthetic", "--img-size", "32", "--root", str(tmp_path)])
