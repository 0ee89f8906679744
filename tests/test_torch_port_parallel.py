"""The port's data-parallel training against the JAX package's data mesh,
on the CPU: two ranks over gloo (``adnm_tpu_torch.parallel.spawn``), each
a fresh process that imports ``test_torch_port_parallel_workers`` (no
JAX), started under a timeout after which they are killed and reaped.

* the loader's ``row_shard`` and ``shard`` (``tests/test_multihost.py``'s
  counterparts), the mesh spec, the refusals of the CLIs;
* the TINY ADNM-UNet of ``tests/test_multihost.py`` (``CFG``, rows seeded
  100 + i): two ranks against the JAX ``Trainer`` on ``make_mesh(8)`` with
  the same global batch and parameters, the loss within rel 1e-5 and the
  gradient norm within rel 1e-4 (JAX's own bounds there); against the
  port's single process, every gradient leaf within GRAD_RTOL of its norm
  or GRAD_ATOL of the global norm (``test_torch_port_train.py``'s: fp32
  sums in other orders) and every parameter after the AdamW step within
  2 lr (at eps 1e-9 an update is about lr * sign(g), and a rounding-level
  gradient near 0 may flip its sign);
* SmaAt-UNet at 32^2 through the cross-rank BatchNorm: the loss, the
  gradient norm and the running statistics (and the global batch
  statistics they come from) against the port's fp64 single process on
  the global batch within the fp32 tolerances of
  ``test_torch_port_train_baselines.py``, and against the JAX data mesh
  within those tolerances or twice JAX's own distance from fp64 (JAX's
  E[x^2] - E[x]^2 variance moves its fp32 step far from fp64 there);
* ZeRO-1 against replicated training (the same parameters, bit for bit:
  the same optimizer arithmetic on the same gradients), its consolidated
  checkpoint's AdamW state against the replicated run's (bit for bit),
  and the checkpoint resumed by a single-process Trainer, whose next
  step lands within 2 lr of the two ranks';
* SwinUnet (narrow) at its dropout and DropPath rates: the masks of the
  global batch, so two ranks give the single process's loss and
  gradients; ConvLSTM, TrajGRU, LPTQPN and TransUnet likewise;
* the parameters DDP leaves out of its buckets, for every model of the
  registry and the ADNM-UNet's options: exactly those a train-mode step
  leaves without a gradient;
* the train CLI on ``--mesh data=2 --device cpu``, whose checkpoint the
  single-process validate CLI loads, and validate and predict on two CPU
  ranks against one process;
* the mesh flags of validate, visualize and predict (the launch they
  start), and the axes that stay refused.

The JAX trainers are built once per module.
"""

from __future__ import annotations

import functools
import shutil

import jax
import numpy as np
import pytest
import torch

from adnm_tpu.models import registry as jregistry
from adnm_tpu.models.adnm_unet import ADNMUNet as JADNMUNet
from adnm_tpu.parallel import make_mesh
from adnm_tpu.train import Trainer as JTrainer
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import predict as predict_cli
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.cli import validate as validate_cli
from adnm_tpu_torch.cli import visualize as visualize_cli
from adnm_tpu_torch.core.stochastic import DropPath, Dropout, attach_generator, stochastic_layers
from adnm_tpu_torch.data.loader import BatchLoader
from adnm_tpu_torch.metrics import metrics_table
from adnm_tpu_torch.models import registry
from adnm_tpu_torch.models.adnm_unet import ADNMUNet
from adnm_tpu_torch.models.lptqpn import LPTQPN
from adnm_tpu_torch.models.smaat_unet import SmaAtUNet
from adnm_tpu_torch.models.swin_unet import SwinUnet
from adnm_tpu_torch.models.trans_unet import TransUnet
from adnm_tpu_torch.parallel import (finish_multihost, host_barrier, is_multiprocess,
                                     parse_mesh, rank_and_world, spawn)
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
from adnm_tpu_torch.train.loop import Trainer, unreached_parameters
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_baselines import LPTQPN_SMALL, SIZES, random_stats
from test_torch_port_last_baselines import TRANS_SMALL
from test_torch_port_layers import one_torch_thread, random_params  # noqa: F401 (a fixture)
from test_torch_port_mla import OPTIONS as MLA_OPTIONS
from test_torch_port_mla import TINY_KW
from test_torch_port_parallel_workers import Job, load_ranks, run_jobs, run_steps, single_process

CPU = torch.device("cpu")
WORLD = 2
SPAWN_TIMEOUT_S = 240
CFG = dict(channels=5, out_channels=2, kernel=(3, 3, 3), wt_levels=(1, 1, 1),
           embed_dim=(8, 8, 16, 16, 16, 16), refine_dim=(8, 8, 8, 8))
LR, CLIP = 1e-3, 0.025
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-5
SMAAT_LR = 1e-2
ZERO1_LR = 4e-4  # not the preset's base LR: the LR set each epoch must reach ZeRO's optimizer


def global_batch(rows_per_rank: int) -> np.ndarray:
    """``tests/test_multihost.py``'s global batch: rank i's rows seeded
    100 + i, in rank order."""
    return np.concatenate([
        np.random.default_rng(100 + i).uniform(0, 1, (rows_per_rank, 7, 1, 32, 32))
        .astype(np.float32) for i in range(WORLD)])


def two_ranks(job: Job, tmp_path) -> list:
    tmp_path.mkdir(parents=True, exist_ok=True)
    spawn(run_steps, WORLD, args=(job, str(tmp_path)), device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return load_ranks(str(tmp_path), WORLD)


def assert_ranks_agree(ranks: list) -> None:
    """The same loss, gradient norm, parameters and buffers on every rank."""
    a, b = ranks
    assert a["losses"] == b["losses"] and a["gnorms"] == b["gnorms"]
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def assert_grads_close(got: dict, want: dict, rtol: float = GRAD_RTOL,
                       slack: dict = None) -> None:
    total = float(torch.sqrt(sum(w.double().square().sum() for w in want.values())))
    for k, w in want.items():
        err = float((got[k].double() - w.double()).norm())
        norm = float(w.double().norm())
        assert err <= max(rtol * norm, GRAD_ATOL * total, (slack or {}).get(k, 0.0)), \
            (k, err, norm, total)


def rel_l2(got: dict, want: dict) -> float:
    """Relative L2 error of all the leaves as one vector."""
    err = sum(float((got[k].double() - w.double()).square().sum()) for k, w in want.items())
    return (err / sum(float(w.double().square().sum()) for w in want.values())) ** 0.5


def assert_within_sign_flips(got: dict, want: dict, lr: float) -> None:
    """Parameters after one AdamW step, from the same state and gradients
    equal up to rounding: within 2 lr times the largest m/sqrt(v) of the
    first two steps (1 and 1.0013 at beta 0.9, 0.999; a gradient near 0
    may flip its sign)."""
    for k, w in want.items():
        err = float((got[k].double() - w.double()).abs().max()) if w.numel() else 0.0
        assert err <= 2 * lr * 1.002, (k, err)


def assert_same_optimizer_state(got: dict, want: dict) -> None:
    """Two optimizer state dicts with the same entries (step, exp_avg,
    exp_avg_sq for AdamW) for the same parameter indices, bit for bit, and
    the same hyperparameters."""
    assert got["state"].keys() == want["state"].keys()
    for i, w in want["state"].items():
        assert got["state"][i].keys() == w.keys(), i
        for k, v in w.items():
            assert torch.equal(torch.as_tensor(got["state"][i][k]), torch.as_tensor(v)), (i, k)
    assert len(got["param_groups"]) == len(want["param_groups"])
    for g, w in zip(got["param_groups"], want["param_groups"]):
        assert {k: v for k, v in g.items() if k in w} == w


# ---- loader, mesh, flags ------------------------------------------------------


def test_row_shard_gives_each_rank_disjoint_rows_and_the_same_steps():
    data = [np.full((2, 3, 3), i, np.float32) for i in range(22)]
    loaders = [BatchLoader(data, 4, shuffle=True, seed=5, row_shard=(r, 2)) for r in range(2)]
    per_rank = [list(ld) for ld in loaders]
    # 22 clips / global batch 8 -> 2 batches on EVERY rank (the tail dropped)
    assert [len(b) for b in per_rank] == [2, 2] and [len(ld) for ld in loaders] == [2, 2]
    single = list(BatchLoader(data, 8, shuffle=True, seed=5))
    for step in range(2):
        rows = [set(per_rank[r][step][:, 0, 0, 0, 0].astype(int)) for r in range(2)]
        assert len(rows[0]) == len(rows[1]) == 4 and not rows[0] & rows[1]
        # in rank order, the rows are the single process's global batch
        np.testing.assert_array_equal(np.concatenate([per_rank[0][step], per_rank[1][step]]),
                                      single[step])


def test_shard_is_whole_batch_round_robin_and_excludes_row_shard():
    data = [np.zeros((2, 3, 3), np.float32)] * 12  # 3 batches of 4
    l0, l1 = BatchLoader(data, 4, shard=(0, 2)), BatchLoader(data, 4, shard=(1, 2))
    assert (len(l0), len(l1)) == (2, 1)  # unequal: batches 0 and 2 against 1
    assert len(list(l0)) == 2 and len(list(l1)) == 1
    with pytest.raises(ValueError, match="exclusive"):
        BatchLoader(data, 4, shard=(0, 2), row_shard=(0, 2))


@pytest.mark.parametrize("spec, message", [
    ("data=", "malformed entry"), ("data=0", "malformed entry"), ("data=2,data=2", "duplicate"),
    ("seq=2", "a 'data' axis is required"), ("data=2,seq=2", "not ported yet"),
    ("data=1,model=2", "not ported yet"),
])
def test_mesh_spec_is_refused_with_the_jax_message(spec, message, tmp_path):
    """A malformed spec is refused. A 'seq' or 'model' axis beside 'data'
    trains, as in JAX, and serves the inference tools (``training=False``);
    what stays refused on such a mesh is a third axis larger than 1 for
    training (JAX's reason; the inference tools take it) and the train
    CLI's ``--scan-steps`` > 1 (a graphed step across ranks, not ported
    yet)."""
    if message != "not ported yet":
        with pytest.raises(SystemExit, match=message):
            parse_mesh(spec)
        return
    sizes = {k: int(v) for k, v in (part.split("=") for part in spec.split(","))}
    assert parse_mesh(spec) == parse_mesh(spec, training=False) == sizes
    third = {**sizes, "data": 2, "seq": 2, "model": 2}
    three = ",".join(f"{k}={v}" for k, v in third.items())
    with pytest.raises(SystemExit, match="non-trivial axes .'data', 'seq', 'model'. is "
                                         "disabled") as refused:
        parse_mesh(three)
    assert "Use a 2-axis mesh" in str(refused.value)
    assert parse_mesh(three, training=False) == third
    with pytest.raises(SystemExit, match=message):
        train_cli.main(["--synthetic", "--device", "cpu", "--root", str(tmp_path), "--mesh",
                        spec, "--scan-steps", "2"])


def test_mesh_spec_with_unit_axes_is_the_data_axis():
    assert parse_mesh("data=4") == {"data": 4}
    assert parse_mesh("data=2,seq=1,model=1") == {"data": 2, "seq": 1, "model": 1}


@pytest.mark.parametrize("extra, message", [
    (["--mesh", "data=2,seq=2", "--scan-steps", "2"], "not ported yet"),
    (["--mesh", "data=2,seq=2,model=2"], "non-trivial axes"),
    (["--coordinator", "127.0.0.1:9", "--num-processes", "2", "--process-id", "0"],
     "multi-host run without a mesh"),
    (["--coordinator", "127.0.0.1:9", "--num-processes", "2"], "go together"),
    (["--mesh", "data=2", "--batch-size", "3"], "does not divide the mesh 'data' axis"),
    (["--data-parallel", "--coordinator", "127.0.0.1:9", "--num-processes", "2",
      "--process-id", "0", "--mesh", "data=3"], "does not divide the mesh 'data' axis"),
])
def test_train_cli_refuses_what_jax_refuses(extra, message, tmp_path):
    """Before any process group or rank starts."""
    with pytest.raises(SystemExit, match=message):
        train_cli.main(["--synthetic", "--device", "cpu", "--root", str(tmp_path), *extra])
    assert not is_multiprocess()


@pytest.mark.parametrize("tool", ["validate", "visualize", "predict"])
def test_single_card_tools_refuse_the_parallel_flags(tool, tmp_path, monkeypatch):
    """The inference tools refuse the parallel flags they do not run: a
    multi-process launch (a launcher's environment here), as collection
    stays on one host. They take the mesh flags of one host: ``--mesh
    data=1,model=2`` starts two ranks on a ('data', 'seq', 'model') =
    (1, 1, 2) mesh, ``--mesh data=1,seq=2`` two on (1, 2, 1) and
    ``--data-parallel`` with --device cpu one rank (the launch is captured
    here, no rank starts)."""
    cli = {"validate": validate_cli, "visualize": visualize_cli, "predict": predict_cli}[tool]
    launches = []
    monkeypatch.setattr(cli, "run_on_mesh", lambda run, args, launch: launches.append(
        (run, launch)) or {"written": []})
    args = ["--device", "cpu"] + (
        ["--input", str(tmp_path / "x.npy")] if tool == "predict" else ["--synthetic"])
    cli.main([*args, "--mesh", "data=1,model=2"])
    cli.main([*args, "--data-parallel"])
    cli.main([*args, "--mesh", "data=1,seq=2"])
    assert [(run, launch.world, launch.seq, launch.model) for run, launch in launches] == [
        (cli.run, 2, 1, 2), (cli.run, 1, 1, 1), (cli.run, 2, 2, 1)]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="not addressable across hosts"):
        cli.main([*args, "--mesh", "data=2"])
    assert len(launches) == 3


def test_barrier_and_teardown_do_nothing_outside_a_process_group():
    assert rank_and_world() == (0, 1) and not is_multiprocess()
    host_barrier("nothing")
    finish_multihost()


# Every model of the registry at a narrow width, and the ADNM-UNet's options
# (TINY_KW: MLA's heads need its head dimension): (factory, preset, frame size).
UNREACHED_CASES = {
    "ADNMUnet": (functools.partial(ADNMUNet, **CFG), "ADNMUnet", 32),
    **{f"ADNMUnet-{option}": (functools.partial(ADNMUNet, **TINY_KW, **kw), "ADNMUnet", 32)
       for option, kw in {"bimamba": dict(linear_attn_duality=False),
                          "vssd": dict(linear_attn_duality=False, mixer_type="vssd"),
                          **MLA_OPTIONS}.items()},
    **{name: (functools.partial(registry.create_model, name, 5, 2, 6, img_size=SIZES[name]),
              name, SIZES[name]) for name in ("ConvLSTM", "TrajGRU", "SmaATUnet")},
    "LPTQPN": (functools.partial(LPTQPN, 5, 2, **LPTQPN_SMALL), "LPTQPN", 32),
    "TransUnet": (functools.partial(TransUnet, 2, img_size=32, in_channels=5, **TRANS_SMALL),
                  "TransUnet", 32),
    "SwinUnet": (functools.partial(SwinUnet, 2, img_size=32, in_chans=5, embed_dim=24),
                 "SwinUnet", 32),
}


@pytest.mark.parametrize("case", list(UNREACHED_CASES))
def test_unreached_parameters_are_those_a_step_leaves_without_gradient(case, one_torch_thread):
    """DDP leaves out of its buckets what a batch-1 eval-mode forward does
    not reach; a train-mode step on two clips (Dropout, DropPath and
    BatchNorm in train mode) leaves exactly those without a gradient: no
    parameter that only training reads is left out (the ranks would drift
    apart), and none that only evaluation reads is waited for (the reducer
    would hang). The ADNM-UNet's are its unread gates; the baselines have
    none."""
    make, preset, size = UNREACHED_CASES[case]
    t = Trainer(make(), get_preset(preset, 5, 2, 6, "Shanghai"), 5, CPU, seed=0)
    batch = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 7, 1, size, size))
                             .astype(np.float32))
    unreached = unreached_parameters(t.forward_net, batch[:1, :5], 0)
    t.model.train()
    imgs, targets = t._split_batch(batch)
    t.preset.loss_fn(t._forward(imgs).float(), targets).backward()
    no_grad = ["model." + n for n, p in t.model.named_parameters() if p.grad is None]
    assert unreached == no_grad
    assert bool(unreached) == case.startswith("ADNMUnet")


# ---- two ranks against the JAX data mesh ------------------------------------------


@pytest.fixture(scope="module")
def adnm_case():
    """The JAX Trainer on make_mesh(8): one step on the global batch of 8
    rows; its parameters as the port's state dict."""
    jt = JTrainer(JADNMUNet(**CFG), jget_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, 2,
                  img_size=32, mesh=make_mesh(8), seed=0)
    params = jax.device_get(jt.state.params)
    batch = global_batch(4)
    ref = jt.train_epoch([batch], lr=LR, clip_norm=CLIP)
    state = convert.from_jax_params(ADNMUNet(**CFG), params).state_dict()
    return {"state": state, "batch": batch, "jax": ref}


def test_two_ranks_of_the_tiny_adnm_unet_match_the_jax_data_mesh(adnm_case, tmp_path,
                                                                   one_torch_thread):
    job = Job(functools.partial(ADNMUNet, **CFG), "ADNMUnet", adnm_case["batch"],
              state=adnm_case["state"], grads=True, lr=LR, clip=CLIP)
    ranks = two_ranks(job, tmp_path)
    assert_ranks_agree(ranks)
    ref = adnm_case["jax"]
    assert ranks[0]["losses"][0] == pytest.approx(ref["loss"], rel=1e-5)
    assert ranks[0]["gnorms"][0] == pytest.approx(ref["avg_grad_norm"], rel=1e-4)
    single = single_process(job, CPU)
    assert ranks[0]["grad_loss"] == pytest.approx(single["grad_loss"], rel=LOSS_RTOL)
    assert_grads_close(ranks[0]["grads"], single["grads"])
    assert_within_sign_flips(ranks[0]["params"], single["params"], LR)
    # the gates the forward never reads, out of DDP's buckets, decay alike
    assert ranks[0]["unreached"] and all(
        torch.equal(ranks[0]["params"][k[len("model."):]], single["params"][k[len("model."):]])
        for k in ranks[0]["unreached"])


def test_gradient_accumulation_on_two_ranks_is_the_single_process_step(adnm_case, tmp_path,
                                                                        one_torch_thread):
    """Two micro-batches a step on each rank (the first under DDP's
    ``no_sync``) against the single process's two micro-batches of the
    global batch: the same mean gradient, up to the order of the sums."""
    job = Job(functools.partial(ADNMUNet, **CFG), "ADNMUnet", adnm_case["batch"],
              state=adnm_case["state"], grads=True, accum=2)
    ranks = two_ranks(job, tmp_path)
    assert_ranks_agree(ranks)
    single = single_process(job, CPU)
    assert ranks[0]["grad_loss"] == pytest.approx(single["grad_loss"], rel=LOSS_RTOL)
    assert_grads_close(ranks[0]["grads"], single["grads"])


@pytest.fixture(scope="module")
def smaat_case():
    """SmaAt-UNet at 32^2 with numpy-drawn parameters and running
    statistics: the JAX Trainer's step on make_mesh(4) with a global batch
    of 4 rows, and the port's fp64 step on the same batch."""
    jm = jregistry.create_model("SmaATUnet", 5, 2, 6, img_size=32)
    x0 = jax.numpy.zeros((1, 5, 1, 32, 32))
    params, stats = random_params(jm, x0, train=False), random_stats(jm, x0)
    jt = JTrainer(jm, jget_preset("SmaATUnet", 5, 2, 6, "Shanghai"), 5, 2, img_size=32,
                  mesh=make_mesh(4), seed=0)
    jt.state = jt.state.replace(params=jax.tree.map(jax.numpy.asarray, params),
                                batch_stats=jax.tree.map(jax.numpy.asarray, stats))
    batch = global_batch(2)
    ref = jt.train_epoch([batch], lr=SMAAT_LR, clip_norm=0.0)
    model = convert.from_jax_params(SmaAtUNet(n_channels=5, n_classes=2), params, stats)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    m64 = model.double().train()
    x = torch.from_numpy(batch).double()
    loss64 = get_preset("SmaATUnet", 5, 2, 6, "Shanghai").loss_fn(m64(x[:, :5]), x[:, 5:])
    loss64.backward()
    return {"state": state, "batch": batch, "jax": ref,
            "jax_stats": convert.flatten_tree(jax.device_get(jt.state.batch_stats)),
            "old_stats": convert.flatten_tree(stats), "loss64": float(loss64.detach()),
            "grads64": {n: p.grad.clone() for n, p in m64.named_parameters()},
            "stats64": convert.flatten_tree(convert.to_jax_batch_stats(m64))}


def batch_statistics(new: dict, old: dict, momentum: float = 0.1) -> dict:
    """The global batch's mean and unbiased variance that moved the running
    statistics from ``old`` to ``new``."""
    return {k: (np.asarray(new[k], np.float64) - (1 - momentum) * np.asarray(old[k], np.float64))
            / momentum for k in old}


def test_smaat_cross_rank_batchnorm_matches_the_jax_data_mesh(smaat_case, tmp_path,
                                                              one_torch_thread):
    """Each quantity q of the two ranks (fp32) within max(the fp32
    tolerance, twice the port's single-process fp32 distance from the fp64
    value q64) of q64: at this seed the single process's own gradient
    leaves lie up to 2e-3 (relative) from fp64 (uniform-noise frames
    through SmaAt's BatchNorms), and data parallelism may not take the
    step further. Each gradient leaf: within GRAD_RTOL of its norm,
    GRAD_ATOL of the global norm, or twice the single process's worst
    relative leaf error times its norm. Against JAX's data mesh: within
    that bound plus twice JAX's own distance from q64."""
    job = Job(functools.partial(SmaAtUNet, n_channels=5, n_classes=2), "SmaATUnet",
              smaat_case["batch"], state=smaat_case["state"], grads=True, lr=SMAAT_LR, clip=0.0)
    ranks = two_ranks(job, tmp_path)
    assert_ranks_agree(ranks)  # the running statistics too: no buffer broadcast needed
    single = single_process(job, CPU)
    loss, gnorm = ranks[0]["losses"][0], ranks[0]["gnorms"][0]
    loss64, grads64 = smaat_case["loss64"], smaat_case["grads64"]
    gnorm64 = float(torch.sqrt(sum(g.square().sum() for g in grads64.values())))
    loss_tol = max(LOSS_RTOL * abs(loss64), 2 * abs(single["losses"][0] - loss64))
    gnorm_tol = max(1e-4 * gnorm64, 2 * abs(single["gnorms"][0] - gnorm64))
    assert abs(loss - loss64) <= loss_tol and abs(gnorm - gnorm64) <= gnorm_tol
    # the whole gradient, and each leaf with twice the single process's
    # worst relative error over the leaves that the relative bound governs
    err1 = {k: float((single["grads"][k].double() - g).norm()) for k, g in grads64.items()}
    norm64 = {k: float(g.norm()) for k, g in grads64.items()}
    governed = [k for k in grads64 if norm64[k] > GRAD_ATOL * gnorm64 / GRAD_RTOL]
    worst1 = max(err1[k] / norm64[k] for k in governed)
    assert rel_l2(ranks[0]["grads"], grads64) <= max(GRAD_RTOL, 2 * rel_l2(single["grads"],
                                                                           grads64))
    assert_grads_close(ranks[0]["grads"], grads64,
                       slack={k: 2 * worst1 * norm64[k] for k in grads64})
    # the running statistics after two train-mode forwards (grads, then the
    # step) of the same parameters: moved twice by the global statistics
    old = smaat_case["old_stats"]
    batch64 = batch_statistics(smaat_case["stats64"], old)

    def running(params: dict) -> dict:
        model = SmaAtUNet(n_channels=5, n_classes=2)
        model.load_state_dict(params)
        return {k: np.asarray(v, np.float64)
                for k, v in convert.flatten_tree(convert.to_jax_batch_stats(model)).items()}

    stats, stats1 = running(ranks[0]["params"]), running(single["params"])
    stats_tol = {}
    for k, v in batch64.items():
        want = 0.81 * np.asarray(old[k], np.float64) + 0.19 * v
        stats_tol[k] = np.maximum(1e-6 + 1e-5 * np.abs(want), 2 * np.abs(stats1[k] - want))
        assert (np.abs(stats[k] - want) <= stats_tol[k]).all(), k
    # against the JAX data mesh's step
    ref = smaat_case["jax"]
    assert abs(loss - ref["loss"]) <= loss_tol + 2 * abs(ref["loss"] - loss64)
    assert abs(gnorm - ref["avg_grad_norm"]) <= gnorm_tol + 2 * abs(ref["avg_grad_norm"] - gnorm64)
    jax_batch = batch_statistics(smaat_case["jax_stats"], old)
    for k, v in batch64.items():  # the global batch statistics each side took
        got = (stats[k] - 0.81 * np.asarray(old[k], np.float64)) / 0.19
        assert (np.abs(got - jax_batch[k]) <= stats_tol[k] / 0.19
                + 2 * np.abs(jax_batch[k] - v)).all(), k


# ---- ZeRO-1, dropout -------------------------------------------------------------------


def test_zero1_matches_replicated_and_resumes_in_one_process(adnm_case, tmp_path,
                                                             one_torch_thread):
    make = functools.partial(ADNMUNet, **CFG)
    kw = dict(state=adnm_case["state"], steps=2, lr=ZERO1_LR, clip=CLIP)
    rep_ckpt = str(tmp_path / "rep" / "ckpt")
    replicated = two_ranks(Job(make, "ADNMUnet", adnm_case["batch"], save_after=1,
                               ckpt=rep_ckpt, **kw), tmp_path / "rep")
    ckpt = str(tmp_path / "z1" / "ckpt")
    zero1 = two_ranks(Job(make, "ADNMUnet", adnm_case["batch"], zero1=True, save_after=1,
                          ckpt=ckpt, **kw), tmp_path / "z1")
    assert_ranks_agree(zero1)
    assert zero1[0]["losses"] == replicated[0]["losses"]
    for k, v in replicated[0]["params"].items():
        assert torch.equal(zero1[0]["params"][k], v), k
    # each rank holds its share of the AdamW moments
    full = replicated[0]["optimizer_bytes"]
    assert all(r["optimizer_bytes"] < 0.75 * full for r in zero1)
    assert sum(r["optimizer_bytes"] for r in zero1) == full
    # the consolidated file: the plain model's keys, and every rank's share
    # of the AdamW state, bit for bit the replicated run's after step 1
    state, rep_state = torch.load(ckpt, weights_only=True), torch.load(rep_ckpt, weights_only=True)
    assert state["step"] == 1 and state["params"].keys() == adnm_case["state"].keys()
    assert len(rep_state["opt_state"]["state"]) == len(adnm_case["state"])
    assert_same_optimizer_state(state["opt_state"], rep_state["opt_state"])
    t = Trainer(make(), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, CPU, seed=0)
    t.load(ckpt)
    assert isinstance(t.optimizer, torch.optim.AdamW) and t.step == 1
    assert_same_optimizer_state(t.optimizer.state_dict(), rep_state["opt_state"])
    loss, _ = t.train_step(torch.from_numpy(adnm_case["batch"]), ZERO1_LR, CLIP)
    assert float(loss) == pytest.approx(zero1[0]["losses"][1], rel=LOSS_RTOL)
    assert_within_sign_flips(zero1[0]["params"], t.model.state_dict(), ZERO1_LR)


@pytest.mark.parametrize("remat", [False, True])
def test_two_ranks_draw_the_single_process_dropout_and_droppath_masks(tmp_path, remat,
                                                                      one_torch_thread):
    """With the whole forward recomputed in the backward too (inside DDP's
    forward, the generator re-seeded)."""
    job = Job(functools.partial(SwinUnet, 2, img_size=32, in_chans=5, embed_dim=24),
              "SwinUnet", global_batch(2), grads=True, lr=SMAAT_LR, clip=0.0, remat=remat)
    assert any(m.rate > 0 for m in stochastic_layers(job.make()))
    ranks = two_ranks(job, tmp_path)
    assert_ranks_agree(ranks)
    single = single_process(job, CPU)
    assert ranks[0]["grad_loss"] == pytest.approx(single["grad_loss"], rel=LOSS_RTOL)
    assert_grads_close(ranks[0]["grads"], single["grads"])


def test_two_ranks_of_the_other_baselines_are_the_single_process_step(tmp_path,
                                                                       one_torch_thread):
    """ConvLSTM, TrajGRU, LPTQPN and TransUnet (BatchNorm over the ranks,
    dropout), narrow as above, in one process group: the ranks agree, and
    their loss and gradients are the single process's on the global batch
    up to the order of the sums."""
    names = ("ConvLSTM", "TrajGRU", "LPTQPN", "TransUnet")
    jobs = []
    for name in names:
        make, preset, size = UNREACHED_CASES[name]
        batch = np.random.default_rng(1).uniform(0, 1, (2, 7, 1, size, size)).astype(np.float32)
        jobs.append(Job(make, preset, batch, grads=True, lr=SMAAT_LR, clip=0.0))
    spawn(run_jobs, WORLD, args=(jobs, str(tmp_path)), device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    for i, (name, job) in enumerate(zip(names, jobs)):
        ranks = load_ranks(str(tmp_path / str(i)), WORLD)
        assert_ranks_agree(ranks)
        assert not ranks[0]["unreached"], name
        single = single_process(job, CPU)
        assert ranks[0]["grad_loss"] == pytest.approx(single["grad_loss"], rel=LOSS_RTOL), name
        assert_grads_close(ranks[0]["grads"], single["grads"])
        shutil.rmtree(tmp_path / str(i))  # the ranks' records: ConvLSTM's alone are 230 MB


@pytest.mark.parametrize("layer", [Dropout, DropPath])
def test_a_rank_keeps_its_rows_of_the_global_batch_mask(layer):
    x = torch.ones(6, 3, 4)
    masks = []
    for rows in (None, (0, 2), (1, 2)):
        m = layer(0.5).train()
        attach_generator(m, torch.Generator().manual_seed(7), rows)
        masks.append(m(x if rows is None else x[:3]))
    torch.testing.assert_close(torch.cat(masks[1:]), masks[0], rtol=0, atol=0)
    assert not torch.equal(masks[1], masks[2])


# ---- the CLIs --------------------------------------------------------------------------


def flat_metrics(results: dict) -> dict:
    """The evaluator's figures by name, NaN as a string (so equal NaNs compare
    equal)."""
    out = {f"{t}/{k}": v for t, m in results["threshold_metrics"].items() for k, v in m.items()}
    out.update({k: results[k] for k in ("FAR", "RMSE", "SSIM", "LPIPS")})
    return {k: "nan" if np.isnan(v) else float(v) for k, v in out.items()}


def test_train_cli_on_a_cpu_data_mesh_writes_a_checkpoint_that_validate_loads(tmp_path):
    """The data-parallel train CLI's checkpoint, validated in one process and
    on two CPU ranks (``--mesh data=2``: the same table, predictions and
    test loss; the test split's one clip leaves rank 0 no rows), and served
    by predict in one process and on two ranks (the same array; three clips
    in one batch of 4 rows split 1 and 2)."""
    args = ["--model", "SmaATUnet", "--synthetic", "--synthetic-len", "12", "--img-size", "32",
            "--batch-size", "4", "--device", "cpu", "--root", str(tmp_path)]
    out = train_cli.main([*args, "--mesh", "data=2", "--zero1", "--epochs", "1"])
    assert "trainer" not in out and np.isfinite(out["test_loss"])
    assert out["logs"][0].train_loss > 0 and np.isfinite(out["logs"][0].grad_norm_avg)
    path = best_ckpt_dir(str(tmp_path), "Shanghai", "SmaATUnet")
    state = torch.load(path, weights_only=True)
    assert not any(k.startswith("module.") for k in state["params"])
    got = validate_cli.main([*args, "--ckpt", path])
    assert isinstance(got["trainer"].optimizer, torch.optim.SGD)
    assert got["test_loss"] == pytest.approx(out["test_loss"], rel=1e-6)
    assert got["metrics"]["RMSE"] == pytest.approx(out["metrics"]["RMSE"], rel=1e-6)

    meshed = validate_cli.main([*args, "--ckpt", path, "--mesh", "data=2"])
    assert "trainer" not in meshed and meshed["preds"].shape == got["preds"].shape
    np.testing.assert_allclose(meshed["preds"], got["preds"], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(meshed["gts"], got["gts"])
    assert meshed["test_loss"] == pytest.approx(got["test_loss"], rel=1e-6)
    assert metrics_table(meshed["metrics"], pod=True) == metrics_table(got["metrics"], pod=True)
    if np.array_equal(meshed["preds"], got["preds"]):  # the same predictions: the same figures
        assert flat_metrics(meshed["metrics"]) == flat_metrics(got["metrics"])

    frames = np.concatenate([got["preds"], got["gts"]], axis=1)  # 40 frames of the test clip
    np.save(tmp_path / "x.npy", np.stack([frames[0, i:i + 5, None] for i in (0, 5, 10)]))
    served = {}
    for label, extra in (("one", []), ("mesh", ["--mesh", "data=2"])):
        served[label] = predict_cli.main([
            "--input", str(tmp_path / "x.npy"), "--model", "SmaATUnet", "--img-size", "32",
            "--device", "cpu", "--ckpt", path, "--output", str(tmp_path / f"{label}.npy"),
            *extra])
        np.testing.assert_array_equal(np.load(tmp_path / f"{label}.npy"), served[label])
    assert served["mesh"].shape == served["one"].shape == (3, 20, 1, 32, 32)
    np.testing.assert_allclose(served["mesh"], served["one"], rtol=1e-4, atol=1e-5)
