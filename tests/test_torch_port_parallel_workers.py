"""Rank functions for the port's parallel tests
(``test_torch_port_parallel.py`` and ``test_torch_port_mesh_eval.py`` on the
CPU, ``test_torch_port_cuda.py`` on the card), started by
``adnm_tpu_torch.parallel.spawn``. This module imports no JAX: each rank
imports it afresh. It holds no test itself.

``run_steps`` builds the Trainer that a ``Job`` describes, steps on its
rank's rows of the job's global batch and writes what the test compares to
``{out}/rank{rank}.pt``. ``run_mesh_jobs`` runs forwards and evaluations on
meshes of the process group (``MeshJob``) and writes each one's result to
``{out}/{label}_rank{rank}.pt``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from adnm_tpu_torch.cli.predict import forecast
from adnm_tpu_torch.convert import from_jax_params
from adnm_tpu_torch.data.loader import BatchLoader
from adnm_tpu_torch.device import full_fp32
from adnm_tpu_torch.ops import rms_norm, ssd
from adnm_tpu_torch.parallel import make_mesh
from adnm_tpu_torch.parallel.tensor import TRAFFIC, use_mesh
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset
from adnm_tpu_torch.utils.profiling import optimizer_state_bytes

COUNTED = {"rms_norm": rms_norm.rms_norm, "rms_norm_backward": rms_norm.rms_norm_backward,
           "ssd_chunked_scan": ssd.ssd_chunked_scan,
           "ssd_chunked_scan_backward": ssd.ssd_chunked_scan_backward}


@dataclasses.dataclass
class Job:
    """``make()`` builds the model (a picklable factory, such as a
    ``functools.partial`` of its class), ``preset`` names its training
    preset (Shanghai, 5 -> ``t_out`` frames). ``state``: a state dict
    loaded after the Trainer's own init. Each rank takes its
    ``len(batch) // world`` rows of ``batch``, records the averaged
    gradients of a first ``grads`` call (with ``grads``), then runs
    ``steps`` optimizer steps at ``lr`` and ``clip``; with ``save_after=k``
    it writes ``ckpt`` after step k. ``remat``: the whole training
    forward recomputed in the backward; ``accum``: micro-batches a step."""

    make: Callable
    preset: str
    batch: np.ndarray
    t_out: int = 2
    state: Optional[dict] = None
    steps: int = 1
    lr: float = 1e-3
    clip: float = 0.025
    grads: bool = False
    zero1: bool = False
    save_after: Optional[int] = None
    ckpt: Optional[str] = None
    remat: bool = False
    accum: int = 1


def trainer_for(job: Job, device, ddp: bool) -> Trainer:
    t = Trainer(job.make(), get_preset(job.preset, 5, job.t_out, 6, "Shanghai"), 5, device,
                seed=0, ddp=ddp, zero1=job.zero1, remat_forward=job.remat,
                accum_steps=job.accum)
    if job.state is not None:
        t.model.load_state_dict(job.state)
    return t


def run_steps(rank: int, world: int, device: torch.device, job: Job, out: str) -> None:
    torch.set_num_threads(1)
    t = trainer_for(job, device, ddp=True)
    rows = len(job.batch) // world
    batch = torch.from_numpy(np.ascontiguousarray(job.batch[rank * rows:(rank + 1) * rows]))
    batch = batch.to(device)
    res = {"losses": [], "gnorms": [], "launches": []}
    if job.grads:
        loss, grads = t.grads(batch)
        res["grad_loss"] = float(loss)
        res["grads"] = {k: g.detach().cpu().clone() for k, g in grads.items()}
    for step in range(1, job.steps + 1):
        for w in COUNTED.values():
            w.launches = 0
        loss, gnorm = t.train_step(batch, job.lr, job.clip)
        res["losses"].append(float(loss))
        res["gnorms"].append(float(gnorm))
        res["launches"].append({k: w.launches for k, w in COUNTED.items()})
        if step == job.save_after:
            t.save(job.ckpt)
    res["params"] = {k: v.detach().cpu().clone() for k, v in t.model.state_dict().items()}
    res["optimizer_bytes"] = optimizer_state_bytes(t.optimizer)
    res["unreached"] = t.unreached
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def run_jobs(rank: int, world: int, device: torch.device, jobs: list, out: str) -> None:
    """``run_steps`` for each job in turn, in one process group: job i
    writes to ``{out}/{i}``."""
    for i, job in enumerate(jobs):
        sub = os.path.join(out, str(i))
        os.makedirs(sub, exist_ok=True)
        run_steps(rank, world, device, job, sub)


def single_process(job: Job, device) -> dict:
    """The job's steps in this process, on the whole global batch: what
    ``run_steps`` records, without a process group."""
    full_fp32()
    t = trainer_for(job, device, ddp=False)
    batch = torch.from_numpy(np.ascontiguousarray(job.batch)).to(device)
    res = {"losses": [], "gnorms": []}
    if job.grads:
        loss, grads = t.grads(batch)
        res["grad_loss"] = float(loss)
        res["grads"] = {k: g.detach().cpu().clone() for k, g in grads.items()}
    for _ in range(job.steps):
        loss, gnorm = t.train_step(batch, job.lr, job.clip)
        res["losses"].append(float(loss))
        res["gnorms"].append(float(gnorm))
    res["params"] = {k: v.detach().cpu().clone() for k, v in t.model.state_dict().items()}
    res["optimizer_bytes"] = optimizer_state_bytes(t.optimizer)
    res["trainer"] = t
    return res


def load_ranks(out: str, world: int) -> list:
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# ---- forwards and evaluations on a mesh ------------------------------------


@dataclasses.dataclass
class MeshJob:
    """``fn(mesh, device, *args)`` on the ('data', 'seq', 'model') =
    (``data``, ``seq``, ``model``) mesh of the process group (None for
    ``data`` = 0: the function builds what it needs), its result saved as
    ``label``."""

    label: str
    data: int
    model: int
    fn: Callable
    args: tuple = ()
    seq: int = 1


def run_mesh_jobs(rank: int, world: int, device: torch.device, jobs: list, out: str) -> None:
    torch.set_num_threads(1)
    for job in jobs:
        mesh = make_mesh(job.data, job.seq, job.model, device) if job.data else None
        for w in COUNTED.values():
            w.launches = 0
        TRAFFIC.update(model=0, data=0, seq=0)
        result = job.fn(mesh, device, *job.args)
        torch.save({"result": result, "traffic": dict(TRAFFIC),
                    "launches": {k: w.launches for k, w in COUNTED.items()}},
                   os.path.join(out, f"{job.label}_rank{rank}.pt"))


def module_forward(mesh, device, make: Callable, params: dict, x: np.ndarray) -> np.ndarray:
    """A module with the JAX ``params`` on ``x`` under ``mesh``."""
    module = from_jax_params(make(), params).eval().to(device)
    with torch.no_grad(), use_mesh(mesh):
        return module(torch.from_numpy(x).to(device)).cpu().numpy()


def model_forecast(mesh, device, make: Callable, params: dict, x: np.ndarray,
                   batch: int) -> np.ndarray:
    """A model with the JAX ``params`` served by ``forecast`` on ``mesh``."""
    model = from_jax_params(make(), params).to(device)
    return forecast(model, x, batch, device, mesh=mesh, graphs=False)


def rows_seen(model: torch.nn.Module) -> list:
    """A counter of the rows every forward of ``model`` takes (a hook)."""
    seen = [0]
    model.register_forward_pre_hook(lambda m, args: seen.__setitem__(0, seen[0] + len(args[0])))
    return seen


def mesh_eval(mesh, device, make: Callable, state: Optional[dict], clips: list, batch: int,
              ddp: bool = False) -> dict:
    """``eval_epoch(collect=True)`` of the clips at ``batch`` on ``mesh``
    (with ``ddp``: a data-parallel Trainer, on its own mesh), from the
    Trainer's seeded weights or ``state``; each batch's ``eval_step`` loss,
    the rows this rank's model took in the epoch, and ``predict`` of the
    first batch."""
    trainer = Trainer(make(), get_preset("ADNMUnet", 5, 2, 6, "Shanghai"), 5, device, seed=0,
                      ddp=ddp, mesh=None if ddp else mesh)
    if state is not None:
        trainer.model.load_state_dict(state)
    seen = rows_seen(trainer.model)
    loader = BatchLoader(clips, batch, drop_last=False)
    loss, preds, gts = trainer.eval_epoch(loader, collect=True)
    rows = seen[0]
    steps = [float(trainer.eval_step(torch.from_numpy(b).to(device))[0]) for b in loader]
    _, predicted = trainer.predict(next(iter(loader)))
    return {"loss": loss, "preds": preds, "gts": gts, "rows": rows, "steps": steps,
            "predict": predicted.cpu().numpy()}


def refusals(mesh, device, make: Callable) -> dict:
    """The messages of what a Trainer on ``mesh`` (a 'seq' or 'model' axis
    of 2) refuses: data-parallel training there with ``scan_steps`` > 1 (a
    graphed step across ranks), and a step without ``ddp``."""
    got = {}
    preset = get_preset("ADNMUnet", 5, 2, 6, "Shanghai")
    try:
        Trainer(make(), preset, 5, device, ddp=True, mesh=mesh, scan_steps=2)
    except NotImplementedError as e:
        got["ddp"] = str(e)
    t = Trainer(make(), preset, 5, device, mesh=mesh)
    try:
        t.train_step(torch.zeros(2, 7, 1, 32, 32, device=device), 1e-3, 0.025)
    except RuntimeError as e:
        got["step"] = str(e)
    return got


def band_forward(mesh, device, make: Callable, params: dict, x: np.ndarray) -> np.ndarray:
    """A module with the JAX ``params`` on this rank's band of the rows of
    ``x`` (NCHW) over 'seq', as a split stage of the model runs it, the
    bands gathered in row order."""
    from adnm_tpu_torch.parallel.tensor import band_rows, gather_seq, split_rows

    module = from_jax_params(make(), params).eval().to(device)
    with torch.no_grad(), use_mesh(mesh):
        band = band_rows(x.shape[2])
        with split_rows(band):
            y = module(torch.from_numpy(x[:, :, band]).to(device))
        return gather_seq(y).cpu().numpy()


def band_duality(mesh, device, args: tuple) -> np.ndarray:
    """``linear_attn_dual_seqminor`` of numpy (B, H, P, L) inputs on this
    rank's band of the L tokens over 'seq', the bands gathered in order."""
    from adnm_tpu_torch.parallel.tensor import band_rows, gather_seq, split_rows

    x, dt, A, B, C, D = (torch.from_numpy(a).to(device) for a in args)
    with torch.no_grad(), use_mesh(mesh):
        band = band_rows(x.shape[-1])
        with split_rows(band):
            y = ssd.linear_attn_dual_seqminor(x[..., band], dt[..., band], A, B[..., band],
                                              C[..., band], D)
        return gather_seq(y, dim=-1).cpu().numpy()


# ---- training on a ('data', 'seq') or ('data', 'model') mesh -------------------------


@dataclasses.dataclass
class MeshTrainJob:
    """``steps`` training steps of the model ``make()`` (a picklable
    factory) with its Shanghai preset (5 -> ``t_out`` frames) from
    ``state``, on the global ``batch`` (each 'data' position its rows),
    at ``lr`` and ``clip``, with ``zero1``; saved as ``label``. With
    ``ckpt`` the Trainer writes its checkpoint there after the steps."""

    label: str
    make: Callable
    preset: str
    batch: np.ndarray
    state: Optional[dict] = None
    steps: int = 2
    lr: float = 1e-3
    clip: float = 0.025
    zero1: bool = False
    t_out: int = 2
    ckpt: Optional[str] = None


def recorded_steps(t: Trainer, batch: torch.Tensor, job: MeshTrainJob) -> dict:
    """``job.steps`` steps of ``t`` on ``batch``: each step's loss, gradient
    norm, averaged gradients (before the clip), parameters after the
    optimizer, kernel launches and bytes sent by axis (forward and
    backward)."""
    res = {"losses": [], "gnorms": [], "grads": [], "params": [], "launches": [],
           "traffic": []}
    backward = t._backward

    def recording(b, seeds):
        loss = backward(b, seeds)
        res["grads"].append({k: p.grad.detach().cpu().clone()
                             for k, p in t.model.named_parameters()})
        return loss

    t._backward = recording
    for _ in range(job.steps):
        for w in COUNTED.values():
            w.launches = 0
        ssd.SegmentBackward.launches = 0
        for k in TRAFFIC:
            TRAFFIC[k] = 0
        loss, gnorm = t.train_step(batch, job.lr, job.clip)
        res["losses"].append(float(loss))
        res["gnorms"].append(float(gnorm))
        res["params"].append({k: v.detach().cpu().clone()
                              for k, v in t.model.state_dict().items()})
        res["launches"].append({**{k: w.launches for k, w in COUNTED.items()},
                                "ssd_segment_backward": ssd.SegmentBackward.launches})
        res["traffic"].append(dict(TRAFFIC))
    if job.ckpt:
        t.save(job.ckpt)
    return res


def mesh_train(mesh, device, job: MeshTrainJob) -> dict:
    """``recorded_steps`` of a data-parallel Trainer on ``mesh``."""
    t = Trainer(job.make(), get_preset(job.preset, 5, job.t_out, 6, "Shanghai"), 5, device,
                seed=0, ddp=True, zero1=job.zero1, mesh=mesh)
    if job.state is not None:
        t.model.load_state_dict(job.state)
    rows = len(job.batch) // t.data_world
    part = job.batch[t.data_rank * rows:(t.data_rank + 1) * rows]
    res = recorded_steps(t, torch.from_numpy(np.ascontiguousarray(part)).to(device), job)
    res["unreached"] = t.unreached
    res["optimizer_bytes"] = optimizer_state_bytes(t.optimizer)
    return res


def one_process_train(job: MeshTrainJob, device) -> dict:
    """``recorded_steps`` of the job in this process on the whole batch."""
    full_fp32()
    t = Trainer(job.make(), get_preset(job.preset, 5, job.t_out, 6, "Shanghai"), 5, device,
                seed=0)
    if job.state is not None:
        t.model.load_state_dict(job.state)
    return recorded_steps(t, torch.from_numpy(np.ascontiguousarray(job.batch)).to(device), job)


def leaf_grads(module: torch.nn.Module, inputs: dict) -> dict:
    """{name: gradient} of ``module``'s parameters and of the named leaf
    ``inputs`` after a backward, zeros where none reached them."""
    out = {k: (t.grad if t.grad is not None else torch.zeros_like(t)).detach().cpu().clone()
           for k, t in inputs.items()}
    for k, p in module.named_parameters():
        out[k] = (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu().clone()
    return out


def band_chain_grads(mesh, device, make: Callable, state: dict, x: np.ndarray,
                     r: np.ndarray) -> dict:
    """The gradients of sum(r * y) on this rank, y = ``make()`` (a chain of
    the band's layers) on its band of the rows of ``x`` over 'seq' (the
    whole frame without a mesh), the bands gathered in row order: each
    rank's share of the one-process gradients (their sum over the ranks
    is S times them)."""
    from adnm_tpu_torch.parallel.tensor import band_rows, gather_seq, split_rows

    module = make()
    module.load_state_dict(state)
    module.to(device)
    xt = torch.from_numpy(x).to(device).requires_grad_()
    with use_mesh(mesh):
        band = band_rows(x.shape[2])
        with split_rows(band):
            y = module(xt[:, :, band])
        y = gather_seq(y)
    (y * torch.from_numpy(r).to(device)).sum().backward()
    return leaf_grads(module, {"x": xt})


def band_scan_grads(mesh, device, args: tuple, r: np.ndarray, duality: bool,
                    reverse: bool = False) -> dict:
    """The gradients of sum(r * y) in (x, dt, A, B, C, D) on this rank, y the
    duality (its K^T V summed over 'seq') or K2's scan (carried from rank to
    rank) on this rank's band of the L tokens, the bands gathered in
    order."""
    from adnm_tpu_torch.parallel.tensor import band_rows, gather_seq, split_rows

    names = ("x", "dt", "A", "B", "C", "D")
    leaves = {k: torch.from_numpy(a).to(device).requires_grad_() for k, a in zip(names, args)}
    x, dt, A, B, C, D = leaves.values()
    with use_mesh(mesh):
        band = band_rows(x.shape[-1])
        with split_rows(band):
            parts = (x[..., band], dt[..., band], A, B[..., band], C[..., band], D)
            y = (ssd.linear_attn_dual_seqminor(*parts) if duality
                 else ssd.ssd_chunked_scan(*parts, 64, reverse=reverse))
        y = gather_seq(y, dim=-1)
    (y * torch.from_numpy(r).to(device)).sum().backward()
    return {k: t.grad.detach().cpu().clone() for k, t in leaves.items()}


def model_axis_grads(mesh, device, make: Callable, state: dict, x: np.ndarray,
                     r: np.ndarray) -> dict:
    """The gradients of sum(r * y) on this rank, y = ``make()`` on ``x``
    under ``mesh`` (its heads or hidden channels split over 'model')."""
    module = make()
    module.load_state_dict(state)
    module.to(device)
    xt = torch.from_numpy(x).to(device).requires_grad_()
    with use_mesh(mesh):
        y = module(xt)
    (y * torch.from_numpy(r).to(device)).sum().backward()
    return leaf_grads(module, {"x": xt})


def run_mesh_cases(rank: int, world: int, device: torch.device, axes: tuple, cases: list,
                   out: str) -> None:
    """Each case of ``cases`` on the ('data', 'seq', 'model') = ``axes`` mesh:
    a ``MeshTrainJob`` (``mesh_train``) or a (label, fn, args) triple,
    ``fn(mesh, device, *args)``; its record written to
    ``{out}/{label}_rank{rank}.pt``."""
    torch.set_num_threads(1)
    mesh = make_mesh(*axes, device=device)
    for case in cases:
        if isinstance(case, MeshTrainJob):
            label, res = case.label, mesh_train(mesh, device, case)
        else:
            label, fn, args = case
            res = fn(mesh, device, *args)
        torch.save(res, os.path.join(out, f"{label}_rank{rank}.pt"))
