"""Training on the mesh's ('data', 'seq') and ('data', 'model') axes in the
PyTorch port, against the JAX package's one-device Trainer and the port's
one process, on the CPU: gloo ranks of CPU processes
(``adnm_tpu_torch.parallel.spawn``; the rank functions in
``test_torch_port_parallel_workers.py``, which imports no JAX). One module
fixture starts a spawn a mesh, in threads, each running all of that
mesh's cases, while this process runs the JAX trainers and the one-process
steps.

* (i) the TINY ADNM-UNet (``test_torch_port_mesh_seq.py``'s, at the 32^2
  frame where ``band_rule`` splits encoder1-3, decoder4-6 and the refiner),
  duality and bimamba (at slow decays, so K2's carried state and adjoint
  show), two training steps on ('data', 'seq', 'model') = (1, 2, 1),
  (2, 2, 1), (1, 1, 2) and (2, 1, 2), ZeRO-1 on the two with data = 2,
  against JAX's one-device Trainer on the same converted parameters and
  numpy batch and against the port's one process: the loss, the gradient
  norm, every gradient tensor and the parameters after AdamW, the ranks
  bit-equal;
* (ii) SmaAt-UNet on ('data', 'model') = (2, 2) with ZeRO-1 (JAX's own
  ``test_data_model_zero1_training_matches``), and SwinUnet on (1, 1, 2) at
  its Dropout and DropPath rates, whose masks are one process's;
* (iii) each collective's backward against the one-process gradient of
  the same composed function: the band layers (halos, the transposed
  conv's, the frame statistics), the duality's K^T V and K2's carried scan
  on 'seq', the FeedForward, the mixers' heads and the attention on
  'model';
* (iv) K2's carried plain backward chained over 2 and 4 segments against
  ``jax.vjp`` of the JAX ``ssd_chunked_scan(initial_state=...)`` over the
  whole sequence;
* (v) ``cli.train --mesh data=1,seq=2`` and ``--mesh data=1,model=2
  --zero1`` against one process, and a mesh with three axes larger than 1,
  which the Trainer refuses with JAX's reason.

The gradient bound: every tensor within GRAD_RTOL = 1e-3 of its own norm
(plus GRAD_ATOL of the whole gradient's norm, for the tensors that are
zero up to rounding: the biases before an InstanceNorm), so a tensor off
by 2x or 1/2 fails by three orders of magnitude; the fixture holds the
port's fp32 one-process step within a tenth of it from its fp64 step
(``fp64_distance``), where the ranks' sums in another order and JAX's
arithmetic lie.
"""

from __future__ import annotations

import functools
import os
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adnm_tpu.models.adnm_unet import ADNMUNet as JADNMUNet
from adnm_tpu.ops import ssd as jssd
from adnm_tpu.train import Trainer as JTrainer
from adnm_tpu.train import get_preset as jget_preset
from adnm_tpu.train.loop import TrainState
from adnm_tpu_torch import convert
from adnm_tpu_torch.cli import train as train_cli
from adnm_tpu_torch.core import blocks, layers
from adnm_tpu_torch.core.layers import FeedForward, seeded_init_
from adnm_tpu_torch.mixers.attention import StandardAttention
from adnm_tpu_torch.mixers.ssd_mixer import ADNSSDMixer
from adnm_tpu_torch.models.adnm_unet import ADNMUNet
from adnm_tpu_torch.models.smaat_unet import SmaAtUNet
from adnm_tpu_torch.models.swin_unet import SwinUnet
from adnm_tpu_torch.ops import ssd
from adnm_tpu_torch.parallel import spawn
from adnm_tpu_torch.parallel.mesh import check_training_mesh
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from test_torch_port_layers import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_port_mesh_seq import MODELS, TINY, drawn_params, slow_decay
from test_torch_port_parallel_workers import (MeshTrainJob, band_chain_grads, band_scan_grads,
                                              model_axis_grads, one_process_train,
                                              run_mesh_cases)
from test_torch_port_ssd import scan_inputs, to_jax

CPU = torch.device("cpu")
SPAWN_TIMEOUT_S = 300
SIZE = 32
LR, CLIP = 1e-3, 0.025
SMAAT_LR = 1e-2
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6
LOSS_RTOL = 1e-5
FAST_COMPILE = {"xla_backend_optimization_level": 0}
# (label, data, seq, model): the port's training meshes for the TINY model
MESHES = [("1x2x1", 1, 2, 1), ("2x2x1", 2, 2, 1), ("1x1x2", 1, 1, 2), ("2x1x2", 2, 1, 2)]
CONFIGS = ("duality", "bimamba")
SWIN = functools.partial(SwinUnet, 2, img_size=SIZE, in_chans=5, embed_dim=24)
SMAAT = functools.partial(SmaAtUNet, n_channels=5, n_classes=2)


def batch_of(rows: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, (rows, 7, 1, SIZE, SIZE)).astype(np.float32)


def rand(*shape, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def tiny_state(label: str, params: dict) -> dict:
    return convert.from_jax_params(ADNMUNet(**TINY, **MODELS[label]), params).state_dict()


def seeded_state(make) -> dict:
    return seeded_init_(make(), 0).state_dict()


# the composed functions of (iii)
def band_chain() -> torch.nn.Module:
    return torch.nn.Sequential(layers.ConvLayer(4, 6, 3, 1, 1, norm="instance", act="gelu"),
                               layers.ConvLayer(6, 8, 5, 1, 2, groups=2, norm="group4"),
                               blocks.UpSample(8, 4))


MODEL_AXIS = {
    "feedforward": (functools.partial(FeedForward, 8), (2, 8, 6, 6)),
    "adnssd-duality": (functools.partial(ADNSSDMixer, 8, headdim=2), (2, 8, 6, 6)),
    "adnssd-bimamba": (functools.partial(ADNSSDMixer, 8, headdim=2, linear_attn_duality=False),
                       (2, 8, 8, 8)),
    "attention": (functools.partial(StandardAttention, 8, heads=4, dim_head=2), (2, 8, 6, 6)),
}
SCAN = scan_inputs(2, 4, 4, 16, 512, seed=9, carry=True)
SCAN_R = rand(2, 4, 4, 512, seed=10)
CHAIN_X, CHAIN_R = rand(2, 4, 16, 12, seed=11), rand(2, 4, 32, 24, seed=12)


def seq_primitives() -> list:
    state = seeded_state(band_chain)
    return [("chain", band_chain_grads, (band_chain, state, CHAIN_X, CHAIN_R)),
            ("duality-op", band_scan_grads, (tuple(SCAN), SCAN_R, True)),
            ("scan", band_scan_grads, (tuple(SCAN), SCAN_R, False)),
            ("scan-reverse", band_scan_grads, (tuple(SCAN), SCAN_R, False, True))]


def model_primitives() -> list:
    cases = []
    for name, (make, shape) in MODEL_AXIS.items():
        module = seeded_init_(make(), 0)
        if "bimamba" in name:
            with torch.no_grad():  # slow decays: the state lasts across the tokens
                module.A_log.copy_(torch.log(torch.linspace(0.001, 0.01, len(module.A_log))))
        cases.append((name, model_axis_grads,
                      (make, module.state_dict(), rand(*shape, seed=13), rand(*shape, seed=14))))
    return cases


def jax_steps(label: str, params: dict, batch: np.ndarray) -> dict:
    """Two steps of JAX's one-device Trainer from ``params`` on ``batch``
    (its ``_train_step_impl``, compiled once at XLA's lowest optimisation
    level, as ``tests/test_torch_port_graphs.py`` compiles its scan, and
    returning the gradients its ``_grads_impl`` gives inside the step):
    each step's loss, gradient norm, gradients and the parameters after."""
    t = JTrainer.__new__(JTrainer)
    preset = jget_preset("ADNMUnet", 5, 2, 6, "Shanghai")
    t.model, t.preset, t.input_frames, t.output_frames = (
        JADNMUNet(**TINY, **MODELS[label]), preset, 5, 2)
    t.compute_dtype, t.remat_forward, t.accum_steps, t.mesh = jnp.float32, False, 1, None
    t.tx, t._base_rng = preset.make_optimizer(), jax.random.PRNGKey(0)
    tree = jax.tree.map(jnp.asarray, params)
    state = TrainState(params=tree, opt_state=t.tx.init(tree), batch_stats={},
                       step=jnp.zeros((), jnp.int32))

    traced = {}
    grads_impl = t._grads_impl

    def recording(state, batch):  # the step's own gradients, from its one trace
        out = grads_impl(state, batch)
        traced["grads"] = out[1]
        return out

    t._grads_impl = recording

    def step(state, batch, lr, clip):
        state, loss, gnorm = t._train_step_impl(state, batch, lr, clip)
        return state, loss, gnorm, traced["grads"]

    lr, clip = jnp.float32(LR), jnp.float32(CLIP)
    run = jax.jit(step).lower(state, batch, lr, clip).compile(FAST_COMPILE)
    out = {"losses": [], "gnorms": [], "grads": [], "params": []}
    for _ in range(2):
        state, loss, gnorm, grads = run(state, batch, lr, clip)
        out["losses"].append(float(loss))
        out["gnorms"].append(float(gnorm))
        out["grads"].append(convert.flatten_tree(jax.device_get(grads)))
        out["params"].append(convert.flatten_tree(jax.device_get(state.params)))
    return out


def in_thread(target, errors: list) -> threading.Thread:
    def run():
        try:
            target()
        except Exception as e:  # re-raised by the fixture after the join
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    return thread


def load(out, label: str, world: int) -> list:
    ranks = []
    for r in range(world):
        path = os.path.join(out, f"{label}_rank{r}.pt")
        ranks.append(torch.load(path, weights_only=False))
        os.remove(path)
    return ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawns of every mesh (in threads), then here: the JAX trainers'
    two steps and the port's one-process steps of each configuration, the
    one-process gradients of (iii), and the fp32 step's fp64 distance."""
    params = {"duality": drawn_params("duality")}
    params["bimamba"] = slow_decay(params["duality"])
    batch = batch_of(2)
    jobs = {label: MeshTrainJob(label, functools.partial(ADNMUNet, **TINY, **MODELS[label]),
                                "ADNMUnet", batch, tiny_state(label, params[label]), lr=LR,
                                clip=CLIP) for label in CONFIGS}
    others = {"smaat": MeshTrainJob("smaat", SMAAT, "SmaATUnet", batch_of(4, seed=4),
                                    seeded_state(SMAAT), lr=SMAAT_LR, clip=0.0, steps=1,
                                    zero1=True),
              "swin": MeshTrainJob("swin", SWIN, "SwinUnet", batch, seeded_state(SWIN),
                                   lr=SMAAT_LR, clip=0.0, steps=1)}
    cases = {}
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "zero1_seq")
    for label, data, seq, model in MESHES:
        mesh_jobs = [MeshTrainJob(**{**vars(jobs[c]), "zero1": data > 1}) for c in CONFIGS]
        if (data, seq) == (2, 2):  # ZeRO-1's state consolidated over the 'data' group, saved
            mesh_jobs[0].ckpt = ckpt
        if seq > 1 and data == 1:
            mesh_jobs += seq_primitives()
        if model > 1 and data == 1:
            mesh_jobs += model_primitives() + [others["swin"]]
        if model > 1 and data > 1:
            mesh_jobs.append(others["smaat"])
        cases[label] = ((data, seq, model), mesh_jobs)
    out = {label: tmp_path_factory.mktemp(label) for label in cases}
    errors = []
    threads = [in_thread(functools.partial(
        spawn, run_mesh_cases, data * seq * model, args=(axes, jobs_, str(out[label])),
        device="cpu", timeout_s=SPAWN_TIMEOUT_S), errors)
        for label, (axes, jobs_) in cases.items() for data, seq, model in [axes]]
    res = {"jax": {}, "one": {}, "prim": {}, "ckpt": ckpt}
    for label in CONFIGS:  # JAX's traces and compiles side by side (XLA frees the GIL)
        threads.append(in_thread(lambda label=label: res["jax"].__setitem__(
            label, jax_steps(label, params[label], batch)), errors))
    threads_before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        for name, job in {**jobs, **others}.items():
            res["one"][name] = one_process_train(job, CPU)
        for name, fn, args in seq_primitives() + model_primitives():
            res["prim"][name] = fn(None, CPU, *args)
        res["fp64"] = fp64_distance(jobs["duality"], res["one"]["duality"])
    finally:
        torch.set_num_threads(threads_before)
        for thread in threads:
            thread.join()
    if errors:
        raise errors[0]
    for label, ((data, seq, model), mesh_jobs) in cases.items():
        world = data * seq * model
        names = [job.label if isinstance(job, MeshTrainJob) else job[0] for job in mesh_jobs]
        res[label] = {name: load(out[label], name, world) for name in names}
    return res


def fp64_distance(job: MeshTrainJob, fp32: dict) -> float:
    """The largest distance, relative to its norm, of a gradient tensor of
    the port's fp32 one-process step from the same step in fp64 (the
    tensors above 1e-4 of the whole gradient's norm)."""
    model = job.make()
    model.load_state_dict(job.state)
    model.double().train()
    batch = torch.from_numpy(job.batch).double()
    loss = get_preset(job.preset, 5, job.t_out, 6, "Shanghai").loss_fn(model(batch[:, :5]),
                                                                       batch[:, 5:])
    loss.backward()
    want = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    total = float(torch.sqrt(sum(g.square().sum() for g in want.values())))
    return max(float((fp32["grads"][0][k].double() - w).norm() / w.norm())
               for k, w in want.items() if float(w.norm()) > 1e-4 * total)


def assert_grads_close(got: dict, want: dict, label: str) -> None:
    """Every tensor within GRAD_RTOL of its norm plus GRAD_ATOL of the whole
    gradient's norm."""
    assert got.keys() == want.keys(), label
    total = float(np.sqrt(sum(float(np.sum(np.square(np.asarray(w, np.float64))))
                              for w in want.values())))
    for k, w in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (label, k)
        err, norm = float(np.linalg.norm(g - w)), float(np.linalg.norm(w))
        assert err <= GRAD_RTOL * norm + GRAD_ATOL * total, (label, k, err, norm, total)


def assert_within_sign_flips(got: dict, want: dict, lr: float, label: str) -> None:
    """Parameters after AdamW from the same state and gradients equal up to
    rounding: within 2 lr (a gradient near 0 may flip its sign; AdamW's
    first steps move a parameter by about lr sign(g))."""
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max()) if w.size else 0.0
        assert err <= 2 * lr * 1.002, (label, k, err)


def assert_ranks_agree(ranks: list, label: str) -> None:
    a = ranks[0]
    for b in ranks[1:]:
        assert a["losses"] == b["losses"] and a["gnorms"] == b["gnorms"], label
        for step in range(len(a["params"])):
            for k, v in a["params"][step].items():
                assert torch.equal(v, b["params"][step][k]), (label, step, k)


def as_jax(label: str, tree: dict) -> dict:
    """A state or gradient dict of the TINY configuration ``label`` as the
    JAX tree's flat leaves."""
    model = ADNMUNet(**TINY, **MODELS[label])
    return convert.flatten_tree(convert.to_jax_params(model, tree))


def test_the_fp64_distance_lies_well_inside_the_bound(runs):
    assert runs["fp64"] <= GRAD_RTOL / 10, runs["fp64"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("mesh", [m[0] for m in MESHES])
def test_two_steps_on_a_mesh_match_jax_and_one_process(config, mesh, runs, one_torch_thread):
    """The loss, the gradient norm, every gradient tensor and the parameters
    after AdamW of each of two steps, against JAX's one-device Trainer and
    the port's one process; every rank bit-equal to the others."""
    ranks, jx, one = runs[mesh][config], runs["jax"][config], runs["one"][config]
    assert_ranks_agree(ranks, f"{mesh} {config}")
    model = ADNMUNet(**TINY, **MODELS[config])
    names, unread = dict(model.named_parameters()), convert.unread_leaves(model)
    got = ranks[0]
    for step in range(2):
        where = f"{mesh} {config} step {step + 1}"
        assert got["losses"][step] == pytest.approx(jx["losses"][step], rel=LOSS_RTOL), where
        assert got["losses"][step] == pytest.approx(one["losses"][step], rel=LOSS_RTOL), where
        assert got["gnorms"][step] == pytest.approx(jx["gnorms"][step], rel=GRAD_RTOL), where
        assert got["gnorms"][step] == pytest.approx(one["gnorms"][step], rel=GRAD_RTOL), where
        assert_grads_close(got["grads"][step], one["grads"][step], where)
        assert_grads_close(as_jax(config, got["grads"][step]), jx["grads"][step], where)
        assert_within_sign_flips(got["params"][step], one["params"][step], LR, where)
        params = {k: v for k, v in got["params"][step].items() if k in names}
        assert_within_sign_flips(as_jax(config, params),
                                 {k: v for k, v in jx["params"][step].items() if k not in unread},
                                 LR, where)
    data, seq, model = next(m[1:] for m in MESHES if m[0] == mesh)
    traffic = got["traffic"][0]
    assert (traffic["seq"] > 0 and traffic["seq_backward"] > 0) == (seq > 1)
    assert (traffic["model"] > 0 and traffic["model_backward"] > 0) == (model > 1)


def test_smaat_on_data_and_model_with_zero1_is_the_one_process_step(runs, one_torch_thread):
    """SmaAt-UNet on ('data', 'model') = (2, 2) with ZeRO-1 over 'data' (its
    BatchNorm over the 'data' ranks, the model replicated over 'model'),
    with the JAX package's own test_data_model_zero1_training_matches's
    bounds: the loss within 1e-5 and the gradient (its norm, and here the
    whole gradient) within 5e-3, since BatchNorm's backward amplifies the
    'data' ranks' sums in another order about 200-fold through the UNet's
    BatchNorm chains; each leaf within 5e-2 of its norm, which a leaf
    counted twice or half misses twentyfold."""
    ranks, one = runs["2x1x2"]["smaat"], runs["one"]["smaat"]
    assert_ranks_agree(ranks, "smaat")
    got, want = ranks[0]["grads"][0], one["grads"][0]
    assert ranks[0]["losses"][0] == pytest.approx(one["losses"][0], rel=LOSS_RTOL)
    assert ranks[0]["gnorms"][0] == pytest.approx(one["gnorms"][0], rel=5e-3)
    err = sum(float((got[k].double() - w.double()).square().sum()) for k, w in want.items())
    assert err ** 0.5 <= 5e-3 * float(one["gnorms"][0])
    for k, w in want.items():
        e, norm = float((got[k].double() - w.double()).norm()), float(w.double().norm())
        assert e <= 5e-2 * norm + GRAD_ATOL * float(one["gnorms"][0]), (k, e, norm)
    # ZeRO-1 over the two 'data' ranks: each holds half the state, whatever its 'model' rank
    assert ranks[0]["optimizer_bytes"] == ranks[1]["optimizer_bytes"]


def test_a_zero1_checkpoint_of_a_seq_mesh_resumes_in_one_process(runs, one_torch_thread):
    """The checkpoint rank 0 writes after two steps on ('data', 'seq') =
    (2, 2) with ZeRO-1 (the optimizer state consolidated over each 'data'
    group) resumes in one process: the parameters the ranks hold, the step
    count, and AdamW's state within the gradients' bound of one process's
    two steps (every entry of both moments)."""
    t = Trainer(ADNMUNet(**TINY), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, CPU, seed=0)
    t.load(runs["ckpt"])
    got = runs["2x2x1"]["duality"][0]["params"][-1]
    assert t.step == 2
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, got[k]), k
    one = Trainer(ADNMUNet(**TINY), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, CPU, seed=0)
    one.model.load_state_dict(tiny_state("duality", drawn_params("duality")))
    for _ in range(2):
        one.train_step(torch.from_numpy(batch_of(2)), LR, CLIP)
    mine, want = t.optimizer.state_dict()["state"], one.optimizer.state_dict()["state"]
    assert mine.keys() == want.keys()
    for k in ("exp_avg", "exp_avg_sq"):  # the gradients' bound, moment by moment
        assert_grads_close({i: mine[i][k] for i in want}, {i: w[k] for i, w in want.items()}, k)
    assert all(float(mine[i]["step"]) == float(w["step"]) == 2.0 for i, w in want.items())


def test_swin_on_the_model_axis_draws_the_one_process_masks(runs, one_torch_thread):
    """SwinUnet at its Dropout and DropPath rates on ('data', 'model') =
    (1, 2): the 'model' ranks of the one 'data' position draw the one
    process's masks, so the gradients are one process's."""
    ranks, one = runs["1x1x2"]["swin"], runs["one"]["swin"]
    assert_ranks_agree(ranks, "swin")
    assert ranks[0]["losses"][0] == pytest.approx(one["losses"][0], rel=LOSS_RTOL)
    assert_grads_close(ranks[0]["grads"][0], one["grads"][0], "swin")


@pytest.mark.parametrize("name", ["chain", "duality-op", "scan", "scan-reverse"])
def test_a_collectives_backward_on_the_seq_axis_is_the_one_process_gradient(name, runs):
    """The ranks' gradients of one replicated loss sum to S times the one
    process's: the reverse halo-add, the transposed conv's halo, the frame
    statistics' sums, the gather's reduce-scatter, the duality's K^T V and
    K2's carried scan."""
    ranks, want = runs["1x2x1"][name], runs["prim"][name]
    got = {k: sum(r[k] for r in ranks) / len(ranks) for k in want}
    assert_grads_close(got, want, name)


@pytest.mark.parametrize("name", list(MODEL_AXIS))
def test_a_collectives_backward_on_the_model_axis_is_the_one_process_gradient(name, runs):
    """The ranks' gradients of one replicated loss sum to M times the one
    process's: the all-reduce of the partial products and the gather of
    the heads, each rank's slices of the weights read at use."""
    ranks, want = runs["1x1x2"][name], runs["prim"][name]
    got = {k: sum(r[k] for r in ranks) / len(ranks) for k in want}
    assert_grads_close(got, want, name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("parts", [2, 4])
def test_plain_carried_backward_chained_matches_jax_vjp(parts, reverse):
    """K2's carried plain backward (``SegmentBackward`` on the CPU) over
    2 and 4 segments, each from the state and the adjoint the others hand
    it in the scan's direction, against ``jax.vjp`` of the JAX scan from an
    initial state over the whole sequence, at |dA| ~ 3e-4 over 32 chunks,
    where the carried state and adjoint move every segment's gradients far
    beyond the bound; the first segment's dS0 is JAX's."""
    args = scan_inputs(1, 4, 4, 16, 2048, seed=7, carry=True)
    dy, s0 = rand(1, 4, 4, 2048, seed=8), rand(1, 4, 16, 4, seed=9)
    flip = (lambda a: np.ascontiguousarray(a[..., ::-1])) if reverse else (lambda a: a)
    order = [flip(a) if a.ndim > 1 else a for a in args]  # scan order
    _, vjp = jax.vjp(lambda *a: jssd.ssd_chunked_scan(*a[:6], chunk_size=64,
                                                      initial_state=a[6]),
                     *to_jax(*order), jnp.asarray(s0))
    gx, gdt, gA, gB, gC, gD, gs0 = vjp(jnp.asarray(flip(dy).transpose(0, 3, 1, 2)))
    want = [flip(np.asarray(gx).transpose(0, 2, 3, 1)), flip(np.asarray(gdt).transpose(0, 2, 1)),
            np.asarray(gA), flip(np.asarray(gB).transpose(0, 2, 1)),
            flip(np.asarray(gC).transpose(0, 2, 1)), np.asarray(gD)]
    t = [torch.from_numpy(a) for a in (*args, dy)]
    cut = 2048 // parts
    pieces = [[a[..., i * cut:(i + 1) * cut] if a.dim() > 1 else a for a in t]
              for i in range(parts)]
    segs = [ssd.ScanSegment(*p[:6], chunk_size=64, reverse=reverse) for p in pieces]
    bwds = [ssd.SegmentBackward(*p, chunk_size=64, reverse=reverse) for p in pieces]
    first = 0 if not reverse else parts - 1  # the segment the initial state enters
    entering = torch.from_numpy(s0)
    for i in (range(parts) if not reverse else range(parts - 1, -1, -1)):
        segs[i].entering = entering
        entering = entering * segs[i].decay[..., None, None] + segs[i].state
    adjoints = [(b.adjoint, s.decay) for b, s in zip(bwds, segs)]
    grads, moved = [], 0.0
    for i, b in enumerate(bwds):
        lam = ssd.compose_states(adjoints, not reverse, i)
        grads.append(b.grads(segs[i].entering, lam))
        alone = b.grads(segs[i].entering, torch.zeros_like(lam))
        moved = max(moved, float((alone[0] - grads[-1][0]).abs().max()))
    got = [torch.cat([g[j] for g in grads], dim=-1) if j not in (2, 5)
           else sum(g[j] for g in grads) for j in range(6)]
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    np.testing.assert_allclose(grads[first][6].numpy(), np.asarray(gs0), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(gs0)).max())
    assert moved > 100 * 1e-4 * np.abs(want[0]).max()  # the carried adjoint shows


def test_a_trainer_on_three_axes_larger_than_one_refuses_with_the_jax_reason():
    """JAX trains on at most two axes larger than 1
    (adnm_tpu/parallel/mesh.py:103-144): the port's mechanism might run
    on three, but the Trainer refuses them with JAX's reason."""
    class Mesh:
        mesh_dim_names = ("data", "seq", "model")

        def __init__(self, *sizes):
            self.sizes = sizes

        def size(self, i):
            return self.sizes[i]

    check_training_mesh(Mesh(2, 2, 1))
    check_training_mesh(Mesh(1, 2, 2))
    with pytest.raises(ValueError, match=r"non-trivial axes \['data', 'seq', 'model'\]"):
        check_training_mesh(Mesh(2, 2, 2))


def cli_args(root, *extra) -> list:
    return ["--synthetic", "--synthetic-len", "8", "--img-size", str(SIZE), "--batch-size", "2",
            "--epochs", "1", "--save-every", "1", "--no-final-eval", "--device", "cpu",
            "--root", str(root), *extra]


CLI_MESHES = {"data=1,seq=2": [], "data=1,model=2": ["--zero1"]}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli.train`` of the full-width ADNM-UNet at 32^2 on each mesh of
    CLI_MESHES (its ranks gloo CPU processes; ``--zero1`` has no effect on
    one 'data' rank), the two in threads, and in one process here."""
    root = tmp_path_factory.mktemp("cli")
    runs, errors = {}, []
    threads = [in_thread(lambda spec=spec, extra=extra: runs.__setitem__(spec, train_cli.main(
        cli_args(root / spec, "--mesh", spec, *extra))), errors)
        for spec, extra in CLI_MESHES.items()]
    try:
        runs["one"] = train_cli.main(cli_args(root / "one"))
    finally:
        for thread in threads:
            thread.join()
    if errors:
        raise errors[0]
    yield root, runs
    shutil.rmtree(root)  # full-width checkpoints


@pytest.mark.parametrize("spec", list(CLI_MESHES))
def test_train_cli_on_a_mesh_is_the_one_process_epoch(spec, cli_runs, one_torch_thread):
    """``cli.train --mesh`` against one process: the epoch record, and the
    snapshot rank 0 writes, which one process resumes."""
    root, runs = cli_runs
    a, b = runs[spec]["logs"][0], runs["one"]["logs"][0]
    assert a.train_loss == pytest.approx(b.train_loss, rel=1e-4)
    assert a.val_loss == pytest.approx(b.val_loss, rel=1e-4)
    assert a.grad_norm_avg == pytest.approx(b.grad_norm_avg, rel=1e-3)
    snap = "model_params/Shanghai/ADNMUnet/ADNMUnet_best_epoch1"
    mesh_state = torch.load(root / spec / snap, weights_only=True)["params"]
    one = runs["one"]["trainer"]
    steps = one.step
    for k, v in one.model.state_dict().items():  # AdamW moves a parameter about lr a step
        assert (mesh_state[k].double() - v.double()).abs().max() <= 2 * steps * b.lr * 1.002, k
    one.load(str(root / spec / snap))  # a mesh run's file resumes in one process
    assert one.step == steps
