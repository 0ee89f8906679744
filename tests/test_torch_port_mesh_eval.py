"""The port's evaluation and inference on a mesh against the JAX package's
meshed forward, on the CPU: gloo ranks of CPU processes
(``adnm_tpu_torch.parallel.spawn``, one spawn per world size running all
its jobs, the rank functions in ``test_torch_port_parallel_workers.py``,
which imports no JAX).

* (i) ``StandardAttention``, ``FeedForward``, ``ADNSSDMixer`` (duality, and
  bimamba through K2's plain version) and ``VSSDMixer`` (both forms) with
  their heads and hidden channels split over ``model=2``, against the JAX
  modules on the conftest's virtual CPU mesh ('data', 'model') = (1, 2);
* (ii) the whole TINY ADNM-UNet (``tests/test_parallel.py``'s ``CFG``,
  duality, bimamba and VSSD mixers) served by ``forecast`` on ``model=2``
  and on ``data=2,model=2``, against JAX's ('data', 'seq', 'model') =
  (2, 1, 2) forward;
* (iii) ``eval_epoch(collect=True)`` on ``data=2`` with a one-row tail (one
  position then has no rows), through a mesh Trainer and a data-parallel
  one: the loss within 1e-6 relative of the single process, each batch's
  loss, the predictions in the single process's order, the ground truths
  equal, each rank's model fed only its rows;
* (v) the refusals that stay: training on 'seq' and 'model' (the CLI and
  the Trainer), ``--coordinator`` on validate and visualize; validate and
  visualize launching a 'seq' axis.

Every comparison with JAX at rtol 1e-4, atol 1e-5 (JAX's own bound for a
meshed forward against the plain one, ``tests/test_parallel.py:171``).
"""

from __future__ import annotations

import functools
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from adnm_tpu.core.layers import FeedForward as JFeedForward
from adnm_tpu.mixers.attention import StandardAttention as JStandardAttention
from adnm_tpu.mixers.ssd_mixer import ADNSSDMixer as JADNSSDMixer
from adnm_tpu.mixers.vssd import VSSDMixer as JVSSDMixer
from adnm_tpu.models.adnm_unet import ADNMUNet as JADNMUNet
from adnm_tpu.parallel import make_mesh as jmake_mesh
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.cli import validate as validate_cli
from adnm_tpu_torch.cli import visualize as visualize_cli
from adnm_tpu_torch.core.layers import FeedForward
from adnm_tpu_torch.data.loader import BatchLoader
from adnm_tpu_torch.mixers.attention import StandardAttention
from adnm_tpu_torch.mixers.ssd_mixer import ADNSSDMixer
from adnm_tpu_torch.mixers.vssd import VSSDMixer
from adnm_tpu_torch.models.adnm_unet import ADNMUNet
from adnm_tpu_torch.parallel import is_multiprocess, parse_mesh, spawn
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_layers import one_torch_thread, random_params  # noqa: F401 (a fixture)
from test_torch_port_mixer import slow_decay
from test_torch_port_parallel_workers import (MeshJob, mesh_eval, model_forecast, module_forward,
                                              refusals, run_mesh_jobs)

RTOL, ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-6
SPAWN_TIMEOUT_S = 240
SIZE = 32
# tests/test_parallel.py:146-150, with the Shanghai preset's 5 input frames
CFG = dict(embed_dim=(8, 8, 8, 8, 8, 8), refine_dim=(8, 8, 8, 8), wt_levels=(1, 1, 1),
           headdim=2, refine_headdim=(2, 2, 2, 2), depth=(1, 1, 1), refine_depth=(1, 1, 1, 1))
TINY = dict(channels=5, out_channels=2, kernel=(3, 3, 3), **CFG)
MODELS = {"duality": {}, "bimamba": {"linear_attn_duality": False}, "vssd": {"mixer_type": "vssd"}}


def rand(*shape, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def jax_on_mesh(jm, params, x, shape, axes, **kwargs) -> np.ndarray:
    """``jm`` on ``x`` under the virtual CPU mesh ``shape`` over ``axes``:
    the batch over 'data', the parameters replicated (``P()``), the
    modules' 'model' annotations active (``set_mesh``)."""
    mesh = jmake_mesh(math.prod(shape), axes=axes, shape=shape)
    fn = jax.jit(lambda p, a: jm.apply({"params": p}, a, **kwargs))
    with jax.sharding.set_mesh(mesh):
        xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("data")))
        ps = jax.device_put(jax.tree.map(jnp.asarray, params), NamedSharding(mesh, P()))
        return np.asarray(fn(ps, xs))


# (JAX module, port module, NCHW input): the four modules at model=2
x_mixer = rand(2, 8, SIZE, SIZE, seed=1)
MODULES = {
    "attention": (JStandardAttention(8, heads=4, dim_head=2),
                  functools.partial(StandardAttention, 8, heads=4, dim_head=2),
                  rand(2, 8, 8, 8, seed=2)),
    "feedforward": (JFeedForward(8), functools.partial(FeedForward, 8), rand(2, 8, 16, 16)),
    "adnssd-duality": (JADNSSDMixer(8, headdim=2), functools.partial(ADNSSDMixer, 8, headdim=2),
                       x_mixer),
    "adnssd-bimamba": (JADNSSDMixer(8, headdim=2, linear_attn_duality=False, chunk_size=256),
                       functools.partial(ADNSSDMixer, 8, headdim=2, linear_attn_duality=False),
                       x_mixer),
    "vssd-duality": (JVSSDMixer(8, headdim=2), functools.partial(VSSDMixer, 8, headdim=2),
                     x_mixer),
    "vssd-bimamba": (JVSSDMixer(8, headdim=2, linear_attn_duality=False, chunk_size=256),
                     functools.partial(VSSDMixer, 8, headdim=2, linear_attn_duality=False),
                     x_mixer),
}


def module_params(name: str):
    """(params, JAX input) of a module case: the attention takes (B, L, D)
    tokens in JAX, the others NHWC; the scan mixers get slow decays, so the
    carry between chunks shows."""
    jm, _, x = MODULES[name]
    if name == "attention":
        jx = jnp.asarray(x.reshape(2, 8, -1).transpose(0, 2, 1))
        return random_params(jm, jx), jx
    jx = jnp.asarray(nhwc(x))
    params = random_params(jm, jx)
    return (slow_decay(params) if "bimamba" in name else params), jx


def module_want(name: str, params, jx) -> np.ndarray:
    """The JAX module's output on ('data', 'model') = (1, 2), in NCHW."""
    jm, _, x = MODULES[name]
    want = jax_on_mesh(jm, params, jx, (1, 2), ("data", "model"))
    if name == "attention":
        return want.transpose(0, 2, 1).reshape(x.shape)
    return np.moveaxis(want, -1, 1)


def eval_clips() -> list:
    """Five clips: batches of 2, 2 and a one-row tail."""
    rng = np.random.default_rng(7)
    return [rng.uniform(0, 1, (7, SIZE, SIZE)).astype(np.float32) for _ in range(5)]


def ranks_of(out, label: str, world: int) -> list:
    return [torch.load(out / f"{label}_rank{r}.pt", weights_only=False) for r in range(world)]


def spawn_in_thread(world: int, jobs: list, out, errors: list) -> threading.Thread:
    """``run_mesh_jobs`` on ``world`` gloo CPU ranks, started in a thread, so
    that the ranks run while this process compiles the JAX forwards; a
    failure lands in ``errors``."""
    def target():
        try:
            spawn(run_mesh_jobs, world, args=(jobs, str(out)), device="cpu",
                  timeout_s=SPAWN_TIMEOUT_S)
        except Exception as e:  # re-raised by the fixture after the join
            errors.append(e)

    thread = threading.Thread(target=target)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX parameters, then two spawns side by side, while the JAX
    meshed forwards compile here: two gloo ranks (the modules and the three
    models on model=2, the evaluations on data=2 with a mesh Trainer and a
    DDP one, the Trainer's refusals on model=2) and four (the three models
    on data=2,model=2)."""
    x = np.random.default_rng(1).uniform(0, 1, (2, 5, 1, SIZE, SIZE)).astype(np.float32)
    duality = random_params(JADNMUNet(**TINY), jnp.asarray(x), train=False)
    models = {"duality": duality, "bimamba": duality,  # one tree for both scans
              "vssd": random_params(JADNMUNet(**TINY, **MODELS["vssd"]), jnp.asarray(x),
                                    train=False)}
    modules = {name: module_params(name) for name in MODULES}
    make = functools.partial(ADNMUNet, **TINY)

    def forecasts(data: int) -> list:
        return [MeshJob(f"model-{label}", data, 2, model_forecast,
                        (functools.partial(ADNMUNet, **TINY, **MODELS[label]), params, x, 2))
                for label, params in models.items()]

    jobs2 = [MeshJob(name, 1, 2, module_forward, (MODULES[name][1], params, MODULES[name][2]))
             for name, (params, _) in modules.items()]
    jobs2 += forecasts(1) + [
        MeshJob("eval", 2, 1, mesh_eval, (make, None, eval_clips(), 2)),
        MeshJob("eval-ddp", 0, 0, mesh_eval, (make, None, eval_clips(), 2, True)),
        MeshJob("refusals", 1, 2, refusals, (make,))]
    out2, out4, errors = (tmp_path_factory.mktemp("mesh2"), tmp_path_factory.mktemp("mesh4"),
                          [])
    threads = [spawn_in_thread(2, jobs2, out2, errors),
               spawn_in_thread(4, forecasts(2), out4, errors)]
    want = {}
    try:
        for label, params in models.items():
            want[f"model-{label}"] = jax_on_mesh(JADNMUNet(**TINY, **MODELS[label]), params, x,
                                                 (2, 1, 2), ("data", "seq", "model"),
                                                 train=False)
            assert not np.isnan(want[f"model-{label}"]).any()
        for name, (params, jx) in modules.items():
            want[name] = module_want(name, params, jx)
    finally:
        for thread in threads:
            thread.join()
    if errors:
        raise errors[0]
    return {"want": want, 2: out2, 4: out4}


# ---- (i) the four modules on model=2 ---------------------------------------------


@pytest.mark.parametrize("name", list(MODULES))
def test_module_on_the_model_axis_matches_the_jax_meshed_module(name, runs):
    ranks = ranks_of(runs[2], name, 2)
    for r in ranks:
        np.testing.assert_allclose(r["result"], runs["want"][name], rtol=RTOL, atol=ATOL)
        assert r["traffic"]["model"] > 0  # the heads or channels were split
    np.testing.assert_array_equal(ranks[0]["result"], ranks[1]["result"])


# ---- (ii) the whole TINY model on model=2 and data=2,model=2 ----------------------


@pytest.mark.parametrize("label", list(MODELS))
def test_tiny_model_on_the_model_axis_matches_jax(label, runs):
    for r in ranks_of(runs[2], f"model-{label}", 2):
        np.testing.assert_allclose(r["result"], runs["want"][f"model-{label}"], rtol=RTOL,
                                   atol=ATOL)
        assert r["traffic"]["model"] > 0 and r["traffic"]["data"] == 0


@pytest.mark.parametrize("label", list(MODELS))
def test_tiny_model_on_a_data_and_model_mesh_matches_jax(label, runs):
    ranks = ranks_of(runs[4], f"model-{label}", 4)
    for r in ranks:
        np.testing.assert_allclose(r["result"], runs["want"][f"model-{label}"], rtol=RTOL,
                                   atol=ATOL)
        assert r["traffic"]["model"] > 0 and r["traffic"]["data"] > 0
    for r in ranks[1:]:  # every rank gathers every row
        np.testing.assert_array_equal(r["result"], ranks[0]["result"])


# ---- (iii) eval_epoch on data=2 against the single process --------------------------


@pytest.fixture(scope="module")
def single_eval():
    torch.set_num_threads(1)
    trainer = Trainer(ADNMUNet(**TINY), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5,
                      torch.device("cpu"), seed=0)
    loader = BatchLoader(eval_clips(), 2, drop_last=False)
    loss, preds, gts = trainer.eval_epoch(loader, collect=True)
    steps = [float(trainer.eval_step(torch.from_numpy(b))[0]) for b in loader]
    return {"loss": loss, "preds": preds, "gts": gts, "steps": steps,
            "predict": trainer.predict(next(iter(loader)))[1].numpy()}


@pytest.mark.parametrize("label", ["eval", "eval-ddp"])
def test_eval_epoch_on_the_data_axis_is_the_single_process(label, single_eval, runs):
    """Rank 0 holds the rows 0 of the two full batches, rank 1 the rows 1 and
    the one-row tail (rank 0 none of it); each batch's loss is the whole
    batch's mean on every rank; the epoch's predictions and ground truths
    come back in order on rank 0 alone, ``predict``'s on every rank."""
    ranks = [r["result"] for r in ranks_of(runs[2], label, 2)]
    assert [r["rows"] for r in ranks] == [2, 3]
    for r in ranks:
        assert r["loss"] == pytest.approx(single_eval["loss"], rel=LOSS_RTOL)
        assert r["steps"] == pytest.approx(single_eval["steps"], rel=LOSS_RTOL)
        np.testing.assert_allclose(r["predict"], single_eval["predict"], rtol=RTOL, atol=ATOL)
    lead, other = ranks
    assert lead["preds"].shape == single_eval["preds"].shape == (5, 2, SIZE, SIZE)
    np.testing.assert_allclose(lead["preds"], single_eval["preds"], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(lead["gts"], single_eval["gts"])
    assert other["preds"] is None and other["gts"] is None
    assert lead["loss"] == other["loss"]


# ---- (v) what stays refused ---------------------------------------------------------


def test_a_trainer_on_the_model_axis_refuses_to_train(runs):
    """What a Trainer on 'model' still refuses: the graphed steps there
    (``scan_steps`` > 1, ROADMAP §1 item 5.3), and a step without ``ddp``
    (an evaluation mesh). Training there is
    ``tests/test_torch_port_mesh_train.py``'s."""
    got = ranks_of(runs[2], "refusals", 2)[0]["result"]
    assert "'seq' or 'model' axis" in got["ddp"] and "ROADMAP §1 item 5.3" in got["ddp"]
    assert "does not train" in got["step"]


@pytest.mark.parametrize("tool, spec", [
    ("train", "data=2,seq=2"), ("train", "data=1,model=2"), ("validate", "data=1,seq=2"),
    ("visualize", "data=2,model=1,seq=2"),
])
def test_the_axes_not_ported_exit_naming_the_roadmap_item(tool, spec, tmp_path, monkeypatch):
    """Training on 'seq' or 'model' launches a rank per position of the
    mesh, each 'data' position its rows of the global batch, and with
    ``--scan-steps`` > 1 (a graphed step across ranks, not ported) exits
    naming the roadmap item; validate and visualize take a 'seq' axis and
    launch a rank per position (the launches are captured here, no rank
    starts)."""
    cli = {"train": train_cli, "validate": validate_cli, "visualize": visualize_cli}[tool]
    argv = ["--synthetic", "--device", "cpu", "--root", str(tmp_path), "--mesh", spec]
    sizes = {k: int(v) for k, v in (part.split("=") for part in spec.split(","))}
    if tool == "train":
        with pytest.raises(SystemExit, match="not ported yet, ROADMAP §1 item 5.3"):
            cli.main(argv + ["--scan-steps", "2"])
        launches = []
        monkeypatch.setattr(cli, "spawn", lambda fn, world, args, device: launches.append(
            args[1]))
        monkeypatch.setattr(cli.torch, "load", lambda path, weights_only: {})
        cli.main(argv)
        seq, model = sizes.get("seq", 1), sizes.get("model", 1)
        assert [(launch.world, launch.rows, launch.seq, launch.model)
                for launch in launches] == [(sizes["data"] * seq * model,
                                             4 // sizes["data"], seq, model)]
    else:
        launches = []
        monkeypatch.setattr(cli, "run_on_mesh", lambda run, args, launch: launches.append(
            launch) or {"written": []})
        cli.main(argv)
        data, seq = sizes["data"], sizes["seq"]
        assert [(launch.world, launch.seq, launch.model) for launch in launches] == [
            (data * seq, seq, 1)]
    assert not is_multiprocess()


@pytest.mark.parametrize("tool", ["validate", "visualize"])
def test_coordinator_on_the_collecting_tools_exits_with_the_jax_reason(tool, tmp_path):
    main = {"validate": validate_cli.main, "visualize": visualize_cli.main}[tool]
    with pytest.raises(SystemExit, match="not addressable across hosts"):
        main(["--synthetic", "--device", "cpu", "--root", str(tmp_path), "--coordinator",
              "127.0.0.1:9", "--num-processes", "2", "--process-id", "0", "--data-parallel"])
    assert not is_multiprocess()


def test_the_inference_mesh_spec_takes_the_model_axis():
    assert parse_mesh("data=2,seq=1,model=2", training=False) == {"data": 2, "seq": 1,
                                                                    "model": 2}
