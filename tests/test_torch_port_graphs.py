"""The port's single-dispatch execution on the CPU: ``Trainer(scan_steps=K)``
and ``--scan-steps`` against the port's eager steps and the JAX
``Trainer(scan_steps=K)``, and the eval and serving forwards' ``graphs``
switch.

On the CPU a group of K steps runs eagerly through the same function that
a CUDA graph captures on the card, so the grouping, the per-step seeds and
the device-tensor LR and clip are exercised here; the graphs themselves
run on the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``
phase 6i).

The model is the TINY ADNM-UNet of ``tests/test_train_modes.py`` (32^2,
5 -> 2 frames, widths 8), its seeded port weights carried into the JAX
package. Against the port's own eager steps the grouped steps are held
bit for bit. Against JAX's scan (two groups of two steps) the bounds are
JAX's own for its scan against its steps
(``tests/test_train_modes.py:57-80``): AdamW at eps 1e-9 turns a
rounding-level gradient difference into a 2 lr flip of a parameter (that
file's note), so the loss is held to rtol 5e-3, the mean gradient norm to
2e-2, the parameters to rtol 1e-2 and atol 3e-3; the step count and the
clip ratio exactly. The JAX scan is compiled once, at XLA's lowest backend
optimisation level.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.models import adnm_unet as jmodel
from adnm_tpu.train import Trainer as JTrainer
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu.train.loop import TrainState
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import predict
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.core import stochastic
from adnm_tpu_torch.models import adnm_unet as model
from adnm_tpu_torch.models import swin_unet
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_layers import one_torch_thread  # noqa: F401 (a fixture)
from test_train_modes import TINY, _batches

CPU = torch.device("cpu")
TINY_KW = dict(channels=5, out_channels=2, kernel=(3, 3, 3), **TINY)
# the leaves the JAX model creates and never reads: the port holds none
UNREAD = frozenset(convert.unread_leaves(model.ADNMUNet(**TINY_KW)))
LR, CLIP = 1e-3, 0.025
FAST_COMPILE = {"xla_backend_optimization_level": 0}
BATCHES = _batches(5, 1)  # two groups of 2 and a tail


def port_trainer(**kw) -> Trainer:
    return Trainer(model.ADNMUNet(**TINY_KW), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5,
                   CPU, seed=0, **kw)


@pytest.fixture(scope="module")
def epochs():
    """The 5-batch epoch of an eager trainer and of a ``scan_steps=2`` one
    from the same weights, and what the latter's groups gave: each group's
    shape, (losses, norms), and its weights after it as a JAX tree, after
    its initial weights."""
    eager, scan = port_trainer(), port_trainer(scan_steps=2)
    groups = {"shapes": [], "out": [], "params": [to_jax_flat(scan)]}
    real = scan.train_steps

    def train_steps(group, lr, clip_norm):
        out = real(group, lr, clip_norm)
        groups["shapes"].append(tuple(group.shape))
        groups["out"].append(out)
        groups["params"].append(to_jax_flat(scan))
        return out

    scan.train_steps = train_steps
    return (eager, eager.train_epoch(list(BATCHES), LR, CLIP), scan,
            scan.train_epoch(list(BATCHES), LR, CLIP), groups)


def to_jax_flat(t: Trainer) -> dict:
    """A copy of the trainer's weights as the JAX model's flattened tree."""
    return {k: v.copy() for k, v in convert.flatten_tree(convert.to_jax_params(t.model)).items()}


def jax_scan_epoch(flat: dict):
    """JAX's ``Trainer(scan_steps=2)`` on BATCHES[:4] from ``params``: its
    scan over each group of two (``_train_scan_impl``, compiled once, at
    XLA's lowest optimisation level; the trainer's state is built as its
    ``__init__`` builds it, without compiling the init). (losses, norms,
    params)."""
    t = JTrainer.__new__(JTrainer)
    preset = jget_preset("ADNMUnet", 5, 2, 6, "Shanghai")
    t.model, t.preset, t.input_frames, t.output_frames = jmodel.ADNMUNet(**TINY_KW), preset, 5, 2
    t.compute_dtype, t.remat_forward, t.accum_steps, t.mesh = jnp.float32, False, 1, None
    t.tx, t._base_rng = preset.make_optimizer(), jax.random.PRNGKey(13)
    params = jax.tree.map(jnp.asarray, convert.unflatten_tree(flat))
    state = TrainState(params=params, opt_state=t.tx.init(params), batch_stats={},
                       step=jnp.zeros((), jnp.int32))
    lr, clip = jnp.float32(LR), jnp.float32(CLIP)
    groups = [np.stack(BATCHES[i:i + 2]) for i in (0, 2)]
    scan = jax.jit(t._train_scan_impl).lower(state, groups[0], lr, clip).compile(FAST_COMPILE)
    losses, norms = [], []
    for group in groups:
        state, loss, gnorm = scan(state, group, lr, clip)
        losses.append(np.asarray(loss))
        norms.append(np.asarray(gnorm))
    assert int(state.step) == 4
    return (np.concatenate(losses), np.concatenate(norms),
            convert.flatten_tree(jax.device_get(state.params)))


def assert_same_state(a: Trainer, b: Trainer) -> None:
    assert a.step == b.step
    for (name, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(p, q), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(sb["state"][i][k])), (i, k)


def test_grouped_epoch_is_the_eager_epoch_bit_for_bit(epochs):
    eager, log_e, scan, log_s, groups = epochs
    assert groups["shapes"] == [(2, 1, 7, 1, 32, 32)] * 2  # two groups; the tail one step
    assert log_s == log_e and log_s["steps"] == 5
    assert_same_state(scan, eager)


def test_grouped_steps_match_jaxs_scan(epochs):
    """The grouped epoch's two groups against JAX's scan from the same
    weights, with its bounds (module note): the epoch log's figures over
    those 4 steps, and the weights after them."""
    groups = epochs[4]
    losses, norms, want = jax_scan_epoch(groups["params"][0])
    got_losses = torch.cat([o[0] for o in groups["out"]]).numpy()
    got_norms = torch.cat([o[1] for o in groups["out"]]).numpy()
    assert got_losses.size == losses.size == 4
    assert int(np.sum(got_norms > CLIP)) == int(np.sum(norms > CLIP))
    np.testing.assert_allclose(got_losses.sum(), losses.sum(), rtol=5e-3)
    np.testing.assert_allclose(got_norms.mean(), norms.mean(), rtol=2e-2)
    got = groups["params"][2]
    assert got.keys() == want.keys()
    for k in filter(lambda k: k not in UNREAD, want):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-2, atol=3e-3, err_msg=k)


def test_train_steps_returns_each_steps_loss_and_norm():
    """``train_steps`` on a group gives the values of ``train_step`` on its
    batches, with the accumulation over micro-batches."""
    eager, scan = port_trainer(accum_steps=2), port_trainer(accum_steps=2, scan_steps=2)
    group = torch.from_numpy(np.stack(_batches(2, 2)))
    want = [eager.train_step(b, LR, CLIP) for b in group]
    losses, norms = scan.train_steps(group, LR, CLIP)
    assert losses.shape == norms.shape == (2,) and scan.step == 2
    assert torch.equal(losses, torch.stack([w[0] for w in want]))
    assert torch.equal(norms, torch.stack([w[1] for w in want]))
    assert_same_state(scan, eager)


def test_checkpoints_move_between_grouped_and_eager_trainers(epochs, tmp_path):
    """A checkpoint of the grouped trainer (the LR a float in it, as ever)
    loads into an eager one, which then takes the same next step."""
    _, _, scan, _, _ = epochs
    path = str(tmp_path / "ckpt")
    scan.save(path)
    state = torch.load(path, weights_only=True)["opt_state"]
    assert all(isinstance(g["lr"], float) for g in state["param_groups"])
    eager = port_trainer()
    eager.load(path)
    assert_same_state(eager, scan)
    batch = torch.from_numpy(BATCHES[0])
    assert torch.equal(eager.train_step(batch, LR, CLIP)[0], scan.train_step(batch, LR, CLIP)[0])
    assert_same_state(eager, scan)


def test_scan_steps_is_validated():
    tiny = lambda **kw: Trainer(model.ADNMUNet(**TINY_KW),  # noqa: E731
                                get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, CPU, **kw)
    with pytest.raises(ValueError):
        tiny(scan_steps=0)
    with pytest.raises(NotImplementedError, match="scan_steps > 1 under data-parallel"):
        tiny(scan_steps=2, ddp=True)


def test_train_parser_has_scan_steps():
    args = train_cli.make_parser().parse_args(["--scan-steps", "4", "--synthetic"])
    assert args.scan_steps == 4
    assert train_cli.make_parser().parse_args(["--synthetic"]).scan_steps == 1


def tiny_swin() -> torch.nn.Module:
    return swin_unet.SwinUnet(2, img_size=32, embed_dim=12, depths=(1, 1, 1, 1),
                              num_heads=(1, 1, 1, 1), window_size=2, drop_rate=0.1,
                              attn_drop_rate=0.1, drop_path_rate=0.2)


def test_grouped_steps_draw_the_eager_steps_masks_under_remat():
    """A tiny SwinUnet at nonzero Dropout and DropPath rates under
    whole-forward remat: the grouped steps draw every step's masks (and
    their recompute's) as the eager steps do, and land on the same
    parameters."""
    def trainer(k):
        return Trainer(tiny_swin(), get_preset("SwinUnet", 5, 2, 6, "Shanghai"), 5, CPU,
                       seed=3, remat_forward=True, scan_steps=k)

    def recording(layer, drawn: list):
        real = layer._keep_mask

        def keep_mask(shape, x):
            drawn.append(real(shape, x))
            return drawn[-1]
        return keep_mask

    masks, trainers = {1: [], 2: []}, {}
    for k in masks:
        t = trainers[k] = trainer(k)
        layers = stochastic.stochastic_layers(t.model)
        assert any(m.rate > 0 for m in layers)
        for m in layers:
            m._keep_mask = recording(m, masks[k])
        t.train_epoch(_batches(4, 2), 1e-2, 0.0)
    eager, t = trainers[1], trainers[2]
    assert len(masks[1]) == len(masks[2]) > 0
    assert all(torch.equal(a, b) for a, b in zip(masks[1], masks[2]))
    # each forward's masks drawn twice (the forward, the remat's recompute)
    half = len(masks[1]) // 8
    assert all(torch.equal(a, b) for a, b in zip(masks[1][:half], masks[1][half:2 * half]))
    for p, q in zip(eager.params, t.params):
        assert torch.equal(p, q)


def test_cpu_forecast_and_eval_epoch_never_touch_cuda(epochs, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("torch.cuda was touched")

    t = epochs[0]
    x = np.concatenate(BATCHES[:2])[:, :5]
    want_pred = predict.forecast(t.model, x, 1, CPU)
    want_eval = t.eval_epoch([BATCHES[0]], collect=True)
    for name in ("CUDAGraph", "graph", "graph_pool_handle", "Stream", "current_stream",
                 "synchronize", "is_available", "empty_cache", "memory_reserved"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    np.testing.assert_array_equal(predict.forecast(t.model, x, 1, CPU), want_pred)
    got = t.eval_epoch([BATCHES[0]], collect=True)
    assert got[0] == want_eval[0]
    np.testing.assert_array_equal(got[1], want_eval[1])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        t.eval_step(torch.from_numpy(BATCHES[0]), graphs=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        predict.forecast(t.model, x, 1, CPU, graphs=True)
