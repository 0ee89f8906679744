"""The port's inference on the mesh's 'seq' axis against the JAX package's
meshed forward, on the CPU: gloo ranks of CPU processes
(``adnm_tpu_torch.parallel.spawn``, the rank functions in
``test_torch_port_parallel_workers.py``, which imports no JAX), each
holding its band of the rows of every frame.

* (i) the modules on ('data', 'seq') = (1, 2), each on its band with its
  halos or frame statistics, against the JAX module on the conftest's
  virtual CPU mesh with its input's rows split over 'seq': a 3x3 and a
  5x5 ``ConvLayer``, ``WTConv2d`` at 3 levels, ``UpSample``,
  ``InstanceNorm``, ``GroupNorm``, the duality (its K^T V summed over the
  ranks), and both mixers in both forms (the bimamba scans carried from
  rank to rank, at slow decays, so the carried state shows);
* (ii) the TINY ADNM-UNet (``tests/test_parallel.py``'s ``CFG``) in six
  configurations (duality, bimamba, VSSD duality, VSSD bimamba,
  ``instance_norm=False``, ``compute_dead_features``) served by
  ``forecast`` on ('data', 'seq') = (1, 2) and (2, 2) and on ('data',
  'seq', 'model') = (1, 2, 2), against JAX's ('data', 'seq', 'model') =
  (2, 2, 2) forward and the port's one process;
* (iii) K2's plain version with ``initial_state`` against JAX's
  ``ssd_chunked_scan(initial_state=...)``, and segments chained into the
  whole scan, forward and reversed, over many chunks at small |dA|;
* (iv) ``validate --mesh data=1,seq=2`` against one process, and what a
  Trainer on 'seq' still refuses (graphed steps; ROADMAP §1 item 5.3).

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

from adnm_tpu.core import blocks as jblocks
from adnm_tpu.core import layers as jlayers
from adnm_tpu.core import wavelet as jwavelet
from adnm_tpu.mixers.ssd_mixer import ADNSSDMixer as JADNSSDMixer
from adnm_tpu.mixers.vssd import VSSDMixer as JVSSDMixer
from adnm_tpu.models.adnm_unet import ADNMUNet as JADNMUNet
from adnm_tpu.ops import ssd as jssd
from adnm_tpu.parallel import make_mesh as jmake_mesh
from adnm_tpu_torch.cli import validate as validate_cli
from adnm_tpu_torch.convert import flatten_tree, from_jax_params, to_jax_params, unflatten_tree
from adnm_tpu_torch.core import blocks, layers, wavelet
from adnm_tpu_torch.metrics import metrics_table
from adnm_tpu_torch.mixers.ssd_mixer import ADNSSDMixer
from adnm_tpu_torch.mixers.vssd import VSSDMixer
from adnm_tpu_torch.models.adnm_unet import ADNMUNet, band_rule
from adnm_tpu_torch.ops import ssd
from adnm_tpu_torch.parallel import spawn
from test_torch_port_layers import _draw, one_torch_thread, random_params  # noqa: F401 (a fixture)
from test_torch_port_mixer import slow_decay
from test_torch_port_parallel_workers import (MeshJob, band_duality, band_forward,
                                              model_forecast, refusals, run_mesh_jobs)
from test_torch_port_ssd import from_jax, scan_inputs, to_jax

RTOL, ATOL = 1e-4, 1e-5
SPAWN_TIMEOUT_S = 240
SIZE = 32
FAST_COMPILE = {"xla_backend_optimization_level": 0}
# tests/test_parallel.py:146-150, with the Shanghai preset's 5 input frames
CFG = dict(embed_dim=(8, 8, 8, 8, 8, 8), refine_dim=(8, 8, 8, 8), wt_levels=(1, 1, 1),
           headdim=2, refine_headdim=(2, 2, 2, 2), depth=(1, 1, 1), refine_depth=(1, 1, 1, 1))
TINY = dict(channels=5, out_channels=2, kernel=(3, 3, 3), **CFG)
BIMAMBA = {"linear_attn_duality": False}
MODELS = {"duality": {}, "bimamba": BIMAMBA, "vssd": {"mixer_type": "vssd"},
          "vssd-bimamba": {"mixer_type": "vssd", **BIMAMBA}, "group": {"instance_norm": False},
          "dead": {"compute_dead_features": True}}
# (label, data, seq, model): the port's meshes for the TINY model
MESHES = [("1x2", 1, 2, 1), ("2x2", 2, 2, 1), ("1x2x2", 1, 2, 2)]


def rand(*shape, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(x, 1, -1))


def on_mesh(fn, args: tuple, specs: tuple, shape: tuple, axes: tuple) -> np.ndarray:
    """``fn(*args)`` compiled (at XLA's lowest optimisation level) on the
    virtual CPU mesh ``shape`` over ``axes``, each argument placed by its
    PartitionSpec in ``specs``."""
    mesh = jmake_mesh(math.prod(shape), axes=axes, shape=shape)
    with jax.sharding.set_mesh(mesh):
        placed = [jax.device_put(jax.tree.map(jnp.asarray, a), NamedSharding(mesh, s))
                  for a, s in zip(args, specs)]
        return np.asarray(jax.jit(fn).lower(*placed).compile(FAST_COMPILE)(*placed))


# (JAX module, port module, NCHW input): the modules on ('data', 'seq') = (1, 2)
x_mixer = rand(2, 8, SIZE, SIZE, seed=1)
MODULES = {
    "conv3x3": (jlayers.ConvLayer(6, 3, 1, 1, norm="instance", act="gelu"),
                functools.partial(layers.ConvLayer, 4, 6, 3, 1, 1, norm="instance", act="gelu"),
                rand(2, 4, 16, 12, seed=2)),
    "conv5x5": (jlayers.ConvLayer(6, 5, 1, 2, groups=2), functools.partial(
        layers.ConvLayer, 4, 6, 5, 1, 2, groups=2), rand(2, 4, 16, 12, seed=3)),
    "wtconv2d": (jwavelet.WTConv2d(4, 5, 1, True, 3), functools.partial(
        wavelet.WTConv2d, 4, 5, True, 3), rand(2, 4, 32, 24, seed=4)),
    "upsample": (jblocks.UpSample(6), functools.partial(blocks.UpSample, 4, 6),
                 rand(2, 4, 8, 10, seed=5)),
    "instance_norm": (jlayers.InstanceNorm(), layers.InstanceNorm,
                      rand(2, 8, 16, 12, seed=6) * 3 + 1),
    "group_norm": (jlayers.GroupNorm(4, 8), functools.partial(layers.GroupNorm, 4, 8),
                   rand(2, 8, 16, 12, seed=7) * 3 + 1),
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
# the duality alone: (B, H, P, L) with L = 2 bands of 512 tokens, |dA| ~ 3e-4 (y of
# order 1, where the tolerance reads rounding)
DUALITY = scan_inputs(2, 4, 4, 16, 1024, seed=8, carry=True)


def module_params(name: str):
    """(params, the JAX module's output on ('data', 'seq') = (1, 2) in NCHW):
    the scan mixers get slow decays, so the state carried between the
    ranks' segments shows."""
    jm, _, x = MODULES[name]
    jx = nhwc(x)
    params = random_params(jm, jnp.asarray(jx))
    if "bimamba" in name:
        params = slow_decay(params)
    want = on_mesh(lambda p, a: jm.apply({"params": p}, a), (params, jx),
                   (P(), P("data", "seq")), (1, 2), ("data", "seq"))
    return params, np.moveaxis(want, -1, 1)


def duality_want() -> np.ndarray:
    """JAX's duality with its tokens split over 'seq' (XLA's psum)."""
    x, dt, A, B, C, D = DUALITY
    tok = P(None, None, None, "seq")
    return on_mesh(jssd.linear_attn_dual_seqminor, (x, dt, A, B, C, D),
                   (tok, P(None, None, "seq"), P(), P(None, None, "seq"),
                    P(None, None, "seq"), P()), (1, 2), ("data", "seq"))


def drawn_params(label: str, seed: int = 0) -> dict:
    """A JAX params tree of a configuration with every leaf drawn by numpy as
    ``random_params`` draws it, its shapes read from the port's tree (which
    ``convert`` maps one to one, without tracing the JAX init)."""
    rng = np.random.RandomState(seed)
    shapes = flatten_tree(to_jax_params(ADNMUNet(**TINY, **MODELS[label])))
    return unflatten_tree({k: _draw(rng, k.rsplit("/", 1)[-1], v.shape)
                           for k, v in shapes.items()})


def model_params() -> dict:
    """A JAX params tree of each configuration (the bimamba ones at slow
    decays): duality, VSSD, GroupNorm and dead-feature trees, drawn once."""
    duality, vssd = drawn_params("duality"), drawn_params("vssd")
    return {"duality": duality, "bimamba": slow_decay(duality), "vssd": vssd,
            "vssd-bimamba": slow_decay(vssd), "group": drawn_params("group"),
            "dead": drawn_params("dead")}


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


def in_thread(fn, results: dict, key: str, errors: list) -> threading.Thread:
    def target():
        try:
            results[key] = fn()
        except Exception as e:
            errors.append(e)

    thread = threading.Thread(target=target)
    thread.start()
    return thread


def cli_args(root) -> list:
    return ["--synthetic", "--synthetic-len", "8", "--img-size", str(SIZE), "--batch-size", "2",
            "--device", "cpu", "--root", str(root)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX parameters, then two spawns and validate's two ranks side by
    side while the JAX meshed forwards compile here: two gloo ranks (the
    modules, the duality, the six models on (1, 2), the Trainer's
    refusals) and four (the six models on (2, 2) and (1, 2, 2))."""
    x = np.random.default_rng(1).uniform(0, 1, (2, 5, 1, SIZE, SIZE)).astype(np.float32)
    models = model_params()
    modules = {name: module_params(name) for name in MODULES}
    make = functools.partial(ADNMUNet, **TINY)

    def forecasts(data: int, seq: int, model: int) -> list:
        return [MeshJob(f"{data}x{seq}x{model}-{label}", data, model, model_forecast,
                        (functools.partial(ADNMUNet, **TINY, **MODELS[label]), params, x, 2),
                        seq=seq)
                for label, params in models.items()]

    jobs2 = [MeshJob(name, 1, 1, band_forward, (MODULES[name][1], params, MODULES[name][2]),
                     seq=2) for name, (params, _) in modules.items()]
    jobs2 += [MeshJob("duality", 1, 1, band_duality, (tuple(DUALITY),), seq=2),
              MeshJob("refusals", 1, 1, refusals, (make,), seq=2)]
    jobs2 += forecasts(1, 2, 1)
    out2, out4, errors, results = (tmp_path_factory.mktemp("seq2"),
                                   tmp_path_factory.mktemp("seq4"), [], {})
    # no checkpoint under either root: the seeded init
    root, root1 = tmp_path_factory.mktemp("none"), tmp_path_factory.mktemp("none1")
    threads = [spawn_in_thread(2, jobs2, out2, errors),
               spawn_in_thread(4, forecasts(2, 2, 1) + forecasts(1, 2, 2), out4, errors),
               in_thread(lambda: validate_cli.main([*cli_args(root), "--mesh", "data=1,seq=2"]),
                         results, "validate", errors)]
    want = {}
    try:
        for label, params in models.items():
            jm = JADNMUNet(**TINY, **MODELS[label])
            want[label] = on_mesh(lambda p, a: jm.apply({"params": p}, a, train=False),
                                  (params, x), (P(), P("data")), (2, 2, 2),
                                  ("data", "seq", "model"))
            assert not np.isnan(want[label]).any()
        want["duality-op"] = duality_want()
        one = validate_cli.main(cli_args(root1))
        del one["trainer"]
        single = {}
        for label, params in models.items():
            model = from_jax_params(ADNMUNet(**TINY, **MODELS[label]), params).eval()
            with torch.no_grad():
                single[label] = model(torch.from_numpy(x)).numpy()
    finally:
        for thread in threads:
            thread.join()
    if errors:
        raise errors[0]
    return {"want": want, "modules": modules, "single": single, "validate": one,
            "validate_mesh": results["validate"], 2: out2, 4: out4}


# ---- (i) the modules on ('data', 'seq') = (1, 2) ----------------------------------


@pytest.mark.parametrize("name", list(MODULES))
def test_module_on_its_band_matches_the_jax_module_on_the_seq_axis(name, runs):
    ranks = ranks_of(runs[2], name, 2)
    want = runs["modules"][name][1]
    for r in ranks:
        np.testing.assert_allclose(r["result"], want, rtol=RTOL, atol=ATOL)
        assert r["traffic"]["seq"] > 0 and r["traffic"]["model"] == 0
    np.testing.assert_array_equal(ranks[0]["result"], ranks[1]["result"])
    if "bimamba" in name:
        assert all(r["launches"]["ssd_chunked_scan"] == 0 for r in ranks)  # the plain version


def test_duality_on_a_band_of_tokens_sums_kv_over_the_ranks(runs):
    for r in ranks_of(runs[2], "duality", 2):
        np.testing.assert_allclose(r["result"], runs["want"]["duality-op"], rtol=RTOL, atol=ATOL)
        # the (B, N, H P) fp32 sum, then the gather of the (B, H, P, L / 2) band
        assert r["traffic"]["seq"] == 2 * 16 * 16 * 4 + 2 * 4 * 4 * 512 * 4


# ---- (ii) the TINY model on (1, 2), (2, 2) and (1, 2, 2) -----------------------------


@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
@pytest.mark.parametrize("label", list(MODELS))
def test_tiny_model_on_a_seq_mesh_matches_jax_and_one_process(label, mesh, runs):
    _, data, seq, model = next(m for m in MESHES if m[0] == mesh)
    world = data * seq * model
    ranks = ranks_of(runs[2 if world == 2 else 4], f"{data}x{seq}x{model}-{label}", world)
    for r in ranks:
        np.testing.assert_allclose(r["result"], runs["want"][label], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["result"], runs["single"][label], rtol=RTOL, atol=ATOL)
        assert r["traffic"]["seq"] > 0
        assert (r["traffic"]["data"] > 0) == (data > 1)
        assert (r["traffic"]["model"] > 0) == (model > 1)
    for r in ranks[1:]:  # every rank gathers every row
        np.testing.assert_array_equal(r["result"], ranks[0]["result"])


def test_band_rule_splits_only_where_every_stage_fits():
    """A band must be a multiple of 8 rows (three 2x2 pools, each Haar
    level of the stages) and hold the halo of a 5-tap kernel at the
    OutProj's third level (16 rows), as the built model reads them from its
    head; a deeper head asks for more; an even one-conv patch kernel keeps
    the frame whole."""
    assert band_rule((5, 5, 5), (3, 2, 1), False, (3, 5)) == (8, 16)
    assert ADNMUNet(**TINY).band_rule == band_rule(TINY["kernel"], TINY["wt_levels"],
                                                   False, (3, 5))
    assert band_rule((5, 5, 5), (3, 2, 1), False, (4, 5)) == (16, 32)
    assert band_rule((3, 3, 3), (1, 1, 1), True, (3, 5)) == (8, 16)
    assert band_rule((6, 5, 5), (3, 2, 1), True, (3, 5)) is None


# ---- (iii) K2's plain version with a state entering it ------------------------------


@pytest.mark.parametrize("carry", [False, True])
def test_plain_scan_with_an_initial_state_matches_jax(carry):
    args = scan_inputs(2, 3, 4, 16, 512, seed=5, carry=carry)
    s0 = rand(2, 3, 16, 4, seed=6)
    want = from_jax(jssd.ssd_chunked_scan(*to_jax(*args), chunk_size=64,
                                          initial_state=jnp.asarray(s0)))
    t = [torch.from_numpy(a) for a in args]
    got = ssd.ssd_chunked_scan_reference(*t, chunk_size=64, initial_state=torch.from_numpy(s0))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    seg = ssd.ScanSegment(*t, chunk_size=64)
    np.testing.assert_allclose(seg.outputs(torch.from_numpy(s0)).numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("parts", [2, 4])
def test_plain_segments_chain_into_the_whole_scan(parts, reverse):
    """Many chunks at |dA| ~ 3e-4: each segment's outputs from the state
    its predecessors hand it (in the scan's direction) are the whole
    scan's, and differ from the segment's own scan from zero by far more
    than the tolerance."""
    t = [torch.from_numpy(a) for a in scan_inputs(1, 4, 4, 16, 2048, seed=7, carry=True)]
    whole = ssd.ssd_chunked_scan(*t, chunk_size=64, reverse=reverse)
    cut = 2048 // parts
    pieces = [[a[..., i * cut:(i + 1) * cut] if a.dim() > 1 else a for a in t]
              for i in range(parts)]
    segs = [ssd.ScanSegment(*p, chunk_size=64, reverse=reverse) for p in pieces]
    states = [(s.state, s.decay) for s in segs]
    got = torch.cat([s.outputs(ssd.compose_states(states, reverse, i))
                     for i, s in enumerate(segs)], dim=-1)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)
    alone = torch.cat([ssd.ssd_chunked_scan(*p, chunk_size=64, reverse=reverse)
                       for p in pieces], dim=-1)
    assert (alone - whole).abs().max() > 100 * ATOL


# ---- (iv) validate on data=1,seq=2; what a Trainer on 'seq' refuses --------------------


def test_validate_on_a_seq_mesh_prints_the_single_process_table(runs):
    got, one = runs["validate_mesh"], runs["validate"]
    assert got["preds"].shape == one["preds"].shape
    np.testing.assert_allclose(got["preds"], one["preds"], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got["gts"], one["gts"])
    assert got["test_loss"] == pytest.approx(one["test_loss"], rel=1e-5)
    assert metrics_table(got["metrics"], pod=True) == metrics_table(one["metrics"], pod=True)


def test_a_trainer_on_the_seq_axis_refuses_to_train(runs):
    """What a Trainer on 'seq' still refuses: the graphed steps there
    (``scan_steps`` > 1, ROADMAP §1 item 5.3), and a step without ``ddp``
    (an evaluation mesh). Training there is
    ``tests/test_torch_port_mesh_train.py``'s."""
    for r in ranks_of(runs[2], "refusals", 2):
        got = r["result"]
        assert "'seq' or 'model' axis" in got["ddp"] and "ROADMAP §1 item 5.3" in got["ddp"]
        assert "does not train" in got["step"]
