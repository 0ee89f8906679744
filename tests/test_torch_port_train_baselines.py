"""Training the port's four baselines against the JAX package, on the CPU:
one step's loss, every gradient and SmaAt's new running statistics
against ``jax.value_and_grad`` of the JAX preset's loss; one SGD, Adam and
AdamW update against optax's; each preset's LR for 60 epochs; the loop's
policies (no clip, no save gate, early stop, BatchNorm's modes, remat and
accumulation with BatchNorm); and the four CLIs.

Sizes as ``test_torch_port_baselines.py`` (SmaAt and LPTQPN at 32^2,
LPTQPN with one block per level; ConvLSTM and TrajGRU at 64^2), with 3
output frames and a batch of 2 synthetic clips. Each JAX step is compiled
once per module.

Tolerances: the loss within 1e-5 relative; each gradient leaf within 1e-4
relative L2 or 1e-6 of the global gradient norm (fp32 sums in other
orders through up to 25 recurrent steps); the running statistics rtol
1e-5, atol 1e-6; parameters after two optimizer updates from the same
gradients rtol 1e-6, atol 1e-8 (the same arithmetic, in other orders).

SmaAt's step in train mode is ill-conditioned: JAX's BatchNorm computes
the variance as E[x^2] - E[x]^2, and at this seed mean^2 / variance
reaches hundreds, so JAX's fp32 on the CPU lands far from the fp64 loss
and gradients (the port takes the variance about the mean and stays
close). So the port's SmaAt step is also held to its own fp64 evaluation
under the tolerances above, and to JAX within those tolerances or twice
JAX's own distance from the fp64 values, whichever is larger, quantity by
quantity.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.models import lptqpn as jlptqpn
from adnm_tpu.models import registry as jregistry
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu.train.loop import set_lr
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import predict
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.cli import validate as validate_cli
from adnm_tpu_torch.cli import visualize as visualize_cli
from adnm_tpu_torch.data.shanghai import make_datasets
from adnm_tpu_torch.models import registry
from adnm_tpu_torch.models.lptqpn import LPTQPN
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_baselines import (  # noqa: F401 (one_torch_thread is a fixture)
    LPTQPN_SMALL,
    SIZES,
    one_torch_thread,
    random_stats,
)
from test_torch_port_layers import random_params
from test_train_modes import _batches

CPU = torch.device("cpu")
T_OUT = 3
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-6
FAMILY_MODEL = {"sgd": "SmaATUnet", "adam": "ConvLSTM", "adamw": "LPTQPN"}


def small_jax_model(name: str):
    if name == "LPTQPN":
        return jlptqpn.LPTQPN(5, T_OUT, **LPTQPN_SMALL)
    return jregistry.create_model(name, 5, T_OUT, 6, img_size=SIZES[name])


def small_port_model(name: str):
    if name == "LPTQPN":
        return LPTQPN(5, T_OUT, **LPTQPN_SMALL)
    return registry.create_model(name, 5, T_OUT, 6, img_size=SIZES[name])


_STEPS: dict = {}


def jax_step(name: str) -> dict:
    """Params, batch_stats, a batch, and JAX's loss, gradients and new
    batch_stats of one training step (``Trainer._grads_impl``'s loss:
    train mode, batch_stats mutable), once per module."""
    if name not in _STEPS:
        s = SIZES[name]
        jm = small_jax_model(name)
        x0 = jnp.zeros((1, 5, 1, s, s))
        params = random_params(jm, x0, train=False)
        stats = random_stats(jm, x0)
        (batch,) = _batches(1, 2, frames=5 + T_OUT, size=s)
        preset = jget_preset(name, 5, T_OUT, 6, "Shanghai")
        imgs, targets = jnp.asarray(batch[:, :5]), jnp.asarray(batch[:, 5:])

        def loss_fn(p, bs):
            if bs:
                out, mut = jm.apply({"params": p, "batch_stats": bs}, imgs, train=True,
                                    mutable=["batch_stats"])
                return preset.loss_fn(out.astype(jnp.float32), targets), mut["batch_stats"]
            out = jm.apply({"params": p}, imgs, train=True)
            return preset.loss_fn(out.astype(jnp.float32), targets), bs

        (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, stats))
        _STEPS[name] = dict(params=params, stats=stats, batch=batch, loss=float(loss),
                            grads=convert.flatten_tree(jax.device_get(grads)),
                            new_stats=convert.flatten_tree(jax.device_get(new_stats)))
    return _STEPS[name]


def port_trainer(name: str, step: dict, **kw) -> Trainer:
    t = Trainer(small_port_model(name), get_preset(name, 5, T_OUT, 6, "Shanghai"), 5, CPU,
                seed=0, **kw)
    convert.from_jax_params(t.model, step["params"], step["stats"] or None)
    return t


def grad_errors(got: dict, want: dict) -> dict:
    """{leaf: L2 error of ``got`` against ``want``}."""
    assert got.keys() == want.keys()
    return {k: float(np.linalg.norm(np.asarray(got[k], np.float64) - want[k])) for k in want}


def assert_grads_close(got: dict, want: dict, slack: dict = None):
    """Each leaf within GRAD_RTOL of its norm or GRAD_ATOL of the global
    norm, or within ``slack[leaf]``."""
    total = np.sqrt(sum(float(np.sum(np.square(v))) for v in want.values()))
    for k, err in grad_errors(got, want).items():
        norm = np.linalg.norm(want[k])
        assert err <= max(GRAD_RTOL * norm, GRAD_ATOL * total, (slack or {}).get(k, 0.0)), \
            f"{k}: error {err:.3e}, |g| {norm:.3e}, global {total:.3e}"


def fp64_step(name: str, step: dict) -> tuple:
    """The port's loss, gradients (JAX layout) and new running statistics
    of the step in fp64."""
    m = convert.from_jax_params(small_port_model(name), step["params"], step["stats"] or None)
    m = m.double().train()
    batch = torch.from_numpy(step["batch"]).double()
    loss = get_preset(name, 5, T_OUT, 6, "Shanghai").loss_fn(m(batch[:, :5]), batch[:, 5:])
    loss.backward()
    grads = convert.to_jax_params(m, {n: p.grad for n, p in m.named_parameters()})
    return float(loss.detach()), convert.flatten_tree(grads), \
        convert.flatten_tree(convert.to_jax_batch_stats(m))


@pytest.mark.parametrize("name", sorted(SIZES))
def test_training_step_matches_jax(name):
    """The loss and every gradient of one batch against JAX; SmaAt's
    running statistics after the step against JAX's new batch_stats (each
    beside the fp64 values, see the module's docstring); the model in
    train mode for the step."""
    step = jax_step(name)
    t = port_trainer(name, step)
    t.model.eval()
    loss, grads = t.grads(step["batch"])
    assert t.model.training
    loss = float(loss)
    grads = convert.flatten_tree(convert.to_jax_params(t.model, grads))
    stats = convert.flatten_tree(convert.to_jax_batch_stats(t.model))
    assert stats.keys() == step["new_stats"].keys()
    assert bool(stats) == (name == "SmaATUnet")
    slack = {"loss": 0.0, "grads": {}, "stats": {}}
    if stats:
        loss64, grads64, stats64 = fp64_step(name, step)
        np.testing.assert_allclose(loss, loss64, rtol=LOSS_RTOL)
        assert_grads_close(grads, grads64)
        slack = {"loss": 2 * abs(step["loss"] - loss64),
                 "grads": {k: 2 * e for k, e in grad_errors(step["grads"], grads64).items()},
                 "stats": {k: 2 * np.abs(step["new_stats"][k] - v) for k, v in stats64.items()}}
        for k, v in stats64.items():
            np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    assert abs(loss - step["loss"]) <= max(LOSS_RTOL * abs(step["loss"]), slack["loss"])
    assert_grads_close(grads, step["grads"], slack["grads"])
    for k, v in step["new_stats"].items():
        err = np.abs(stats[k] - v)
        assert (err <= np.maximum(1e-6 + 1e-5 * np.abs(v), slack["stats"].get(k, 0.0))).all(), k


@pytest.mark.parametrize("family", sorted(FAMILY_MODEL))
def test_optimizer_update_matches_optax(family):
    """Two updates from JAX's gradients at the preset's first-epoch LR: the
    port's optimizer against the JAX preset's optax chain."""
    name = FAMILY_MODEL[family]
    step = jax_step(name)
    jp, pp = jget_preset(name, 5, T_OUT, 6, "Shanghai"), get_preset(name, 5, T_OUT, 6,
                                                                      "Shanghai")
    assert jp.opt_family == pp.opt_family == family
    lr = pp.lr(1, pp.epochs)
    tx = jp.make_optimizer()
    params = jax.tree.map(jnp.asarray, step["params"])
    grads = jax.tree.map(jnp.asarray, convert.unflatten_tree(step["grads"]))
    state = set_lr(tx.init(params), lr)
    for _ in range(2):
        updates, state = tx.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)

    model = convert.from_jax_params(small_port_model(name), step["params"])
    grads = dict(convert.from_jax_params(small_port_model(name), convert.unflatten_tree(
        step["grads"])).named_parameters())
    opt = pp.make_optimizer(model.parameters())
    for group in opt.param_groups:
        group["lr"] = lr
    for _ in range(2):
        for n, p in model.named_parameters():
            p.grad = grads[n].detach().clone()
        opt.step()
    got = convert.flatten_tree(convert.to_jax_params(model))
    want = convert.flatten_tree(jax.device_get(params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_preset_and_lr_for_sixty_epochs_match_jax(name):
    want, got = (f(name, 5, 20, 6, "Shanghai") for f in (jget_preset, get_preset))
    fields = ("opt_family", "base_lr", "if_early_stop", "early_stop", "norm_clip",
              "save_epoch_gated", "epochs", "save_epoch", "weight_decay", "momentum", "adam_eps")
    assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}
    assert got.clip_schedule is None and not got.norm_clip
    for epoch in range(1, 61):
        lr = (want.lr_at_epoch(epoch, 60) if want.lr_at_epoch is not None
              else want.base_lr * (1.0 - (epoch - 1) / 60) ** 0.9)  # JAX loop's poly decay
        assert got.lr(epoch, 60) == lr
    assert (got.lr_at_epoch is None) == (name == "SmaATUnet")


def test_without_norm_clip_the_gradients_are_not_scaled():
    step = jax_step("LPTQPN")
    t = port_trainer("LPTQPN", step)
    _, want = t.grads(step["batch"])
    want = {k: v.clone() for k, v in want.items()}
    seen = {}
    inner = t.optimizer.step

    def step_and_keep(*a, **kw):
        seen.update({n: p.grad.clone() for n, p in t.model.named_parameters()})
        return inner(*a, **kw)

    t.optimizer.step = step_and_keep
    _, gnorm = t.train_step(torch.from_numpy(step["batch"]), 1e-3, 1e-9)
    assert all(torch.equal(seen[k], want[k]) for k in want)
    total = float(torch.sqrt(sum(v.square().sum() for v in want.values())))
    assert float(gnorm) == pytest.approx(total, rel=1e-6) and total > 1e-9
    t.optimizer.step = inner
    assert t.train_epoch([step["batch"]], 1e-3, 1e-9)["clip_ratio"] == 0


def test_remat_and_accumulation_keep_the_running_statistics_of_jax():
    """SmaAt with ``remat_forward``: ignored (running statistics advanced
    once, gradients unchanged), as in JAX; with two microbatches the
    statistics advance once per microbatch, as JAX's scan threads them."""
    step = jax_step("SmaATUnet")
    batch = step["batch"]
    plain, remat = port_trainer("SmaATUnet", step), port_trainer("SmaATUnet", step,
                                                                 remat_forward=True)
    assert plain.has_batch_stats and not remat.remat_forward
    _, g_plain = plain.grads(batch)
    _, g_remat = remat.grads(batch)
    assert all(torch.equal(g_plain[k], g_remat[k]) for k in g_plain)
    for (k, a), (_, b) in zip(plain.model.named_buffers(), remat.model.named_buffers()):
        assert torch.equal(a, b), k

    accum = port_trainer("SmaATUnet", step, accum_steps=2)
    accum.grads(batch)
    ref = port_trainer("SmaATUnet", step).model.train()
    with torch.no_grad():
        for i in range(2):
            ref(torch.from_numpy(batch[i:i + 1, :5]))
    for (k, a), (_, b) in zip(accum.model.named_buffers(), ref.named_buffers()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=k)


def test_fit_follows_the_preset_gate_and_early_stop(tmp_path, capsys):
    """Without a save gate the best checkpoint is written from epoch 1, and
    early stop counts from there; with the ADNMUnet gate nothing is saved
    before its save epoch. No clip: the logged threshold is 0."""
    step = jax_step("LPTQPN")
    t = port_trainer("LPTQPN", step)
    t.preset = dataclasses.replace(t.preset, early_stop=2)
    val = iter([3.0, 2.0, 2.5, 2.4, 2.6, 1.0])
    t.train_epoch = lambda loader, lr, clip: {"loss": 1.0, "avg_grad_norm": 0.5,
                                              "clip_ratio": 0.0, "steps": 1}
    t.eval_epoch = lambda loader, collect=False: (next(val), None, None)
    path = str(tmp_path / "best")
    logs = t.fit([], [], epochs=6, ckpt_path=path)
    assert [log.epoch for log in logs] == [1, 2, 3, 4]  # two epochs without a better val
    assert [log.lr for log in logs] == [t.preset.lr(e, 6) for e in range(1, 5)]
    assert all(log.clip_threshold == 0.0 for log in logs) and os.path.exists(path)
    assert capsys.readouterr().out.count("(saved)") == 2

    gated = dataclasses.replace(get_preset("ADNMUnet", 5, T_OUT, 6, "Shanghai"),
                                loss_fn=t.preset.loss_fn)
    t.preset, val = gated, iter([3.0, 2.0, 1.0])
    t.fit([], [], epochs=3, ckpt_path=str(tmp_path / "gated"))
    assert not os.path.exists(tmp_path / "gated")


# -- the CLIs -------------------------------------------------------------------

def cli_args(name: str, root) -> list:
    return ["--model", name, "--synthetic", "--synthetic-len", "8", "--img-size",
            str(SIZES[name]), "--batch-size", "2", "--device", "cpu", "--root", str(root)]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_train_cli_trains_and_predict_serves_each_baseline(name, tmp_path):
    """One epoch through the train CLI (its best checkpoint from epoch 1:
    no save gate), then ``predict --ckpt`` on that checkpoint, chained to
    30 frames."""
    out = train_cli.main(cli_args(name, tmp_path) + ["--epochs", "1", "--no-final-eval"])
    t = out["trainer"]
    assert type(t.model).__name__ == type(small_port_model(name)).__name__
    assert t.step == 2 and np.isfinite(out["logs"][0].train_loss)  # 5 clips, full batches
    ckpt = best_ckpt_dir(str(tmp_path), "Shanghai", name)
    assert os.path.exists(ckpt)
    s = SIZES[name]
    x = np.random.RandomState(0).rand(5, s, s).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    preds = predict.main(["--model", name, "--input", str(tmp_path / "x.npy"), "--img-size",
                          str(s), "--device", "cpu", "--ckpt", ckpt, "--horizon", "30",
                          "--output", str(tmp_path / "p.npy")])
    assert preds.shape == (1, 30, 1, s, s) and np.isfinite(preds).all()
    model = predict.load_model(None, "cpu", ckpt=ckpt, model_name=name, img_size=s)
    with torch.no_grad():
        want = model(torch.from_numpy(x[None, :, None])).numpy()
        chained = model(torch.from_numpy(np.clip(want[:, -5:], 0.0, 1.0))).numpy()
    np.testing.assert_array_equal(preds[:, :20], want)
    np.testing.assert_array_equal(preds[:, 20:], chained[:, :10])


def test_smaat_checkpoint_carries_its_running_statistics_through_the_clis(tmp_path):
    """SmaAt's snapshot: validate reproduces the train CLI's final table,
    its running statistics (moved by the epoch) load with it, visualize
    writes strips, and predict --ckpt equals validate's predictions."""
    args = cli_args("SmaATUnet", tmp_path)
    trained = train_cli.main(args + ["--epochs", "1", "--save-every", "1"])
    moved = [float((b - (0.0 if n.endswith("mean") else 1.0)).abs().max())
             for n, b in trained["trainer"].model.named_buffers()]
    assert min(moved) > 0  # every running statistic left its init
    snapshot = best_ckpt_dir(str(tmp_path), "Shanghai", "SmaATUnet") + "_epoch1"
    out = validate_cli.main(args + ["--ckpt", snapshot])
    for k, v in trained["trainer"].model.state_dict().items():
        assert torch.equal(out["trainer"].model.state_dict()[k], v), k
    assert out["test_loss"] == pytest.approx(trained["test_loss"], rel=1e-6)
    for thr, m in out["metrics"]["threshold_metrics"].items():
        assert m["TP"] == trained["metrics"]["threshold_metrics"][thr]["TP"]
    written = visualize_cli.main(args + ["--ckpt", snapshot, "--max-samples", "1",
                                         "--out", str(tmp_path / "pics")])
    assert len(written) == 1 and os.listdir(written[0])
    np.save(tmp_path / "x.npy", smaat_test_inputs())
    preds = predict.main(["--model", "SmaATUnet", "--input", str(tmp_path / "x.npy"),
                          "--img-size", "32", "--device", "cpu", "--ckpt", snapshot,
                          "--output", str(tmp_path / "p.npy")])
    np.testing.assert_allclose(preds[:, :, 0], out["preds"], rtol=1e-6, atol=1e-6)


def smaat_test_inputs() -> np.ndarray:
    """(N, 5, 1, 32, 32): the input frames of the synthetic test split that
    the CLIs evaluate."""
    _, _, te = make_datasets(None, 32, synthetic_len=8)
    return np.stack([te[i][:5, None] for i in range(len(te))])


def test_clis_refuse_what_is_not_ported_for_the_baselines(tmp_path):
    base = cli_args("SmaATUnet", tmp_path)  # --bf16 is ported: test_torch_port_bf16_baselines.py
    with pytest.raises(SystemExit, match="only supported for --model ADNMUnet"):
        train_cli.main(base + ["--no-refiner-remat"])
    with pytest.raises(SystemExit, match="only supported for --model ADNMUnet"):
        train_cli.main(base + ["--attn-type", "mla"])
    with pytest.raises(SystemExit, match="only supported for --model TransUnet"):
        train_cli.main(base + ["--pretrained-npz", str(tmp_path / "r50_vit.npz")])
    with pytest.raises(ValueError, match="running statistics"):
        predict.load_model(str(tmp_path / "p.npz"), "cpu", model_name="SmaATUnet", img_size=32)
    if not torch.cuda.is_available():  # without --device cpu the CLIs ask for the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(base[:-4] + ["--root", str(tmp_path)])
