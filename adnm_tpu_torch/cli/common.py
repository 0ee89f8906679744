"""Shared CLI plumbing of the port (counterpart of adnm_tpu/cli/common.py):
flags, the task shape, and the Trainer and loaders they build."""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from adnm_tpu_torch.convert import from_jax_params, to_jax_params
from adnm_tpu_torch.data.laps import LAPS_THRESHOLDS, make_laps_datasets
from adnm_tpu_torch.data.loader import BatchLoader
from adnm_tpu_torch.data.shanghai import make_datasets
from adnm_tpu_torch.device import resolve_device
from adnm_tpu_torch.models.adnm_unet import apply_reference_init
from adnm_tpu_torch.models.registry import MODEL_NAMES, create_model
from adnm_tpu_torch.ops import build_kernels
from adnm_tpu_torch.parallel import launched_by_torchrun, make_mesh, parse_mesh, spawn
from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
from adnm_tpu_torch.train.loop import Trainer
from adnm_tpu_torch.train.presets import get_preset


def add_common_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="ADNMUnet", choices=list(MODEL_NAMES))
    p.add_argument("--dataset", default="Shanghai", choices=["Shanghai", "LAPS"],
                   help="the task: Shanghai (5 -> 20 frames, 6-minute interval) or LAPS "
                        "(5 -> 3 frames, 60-minute interval, its own ADNMUnet configuration)")
    p.add_argument("--data-path", default=os.environ.get("ADNM_DATA", "datasets/shanghai.h5"))
    p.add_argument("--synthetic", action="store_true",
                   help="use the synthetic dataset (no h5 needed)")
    p.add_argument("--synthetic-len", type=int, default=64)
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--root", default=os.environ.get("ADNM_ROOT", "runs"),
                   help="output root for model_params/ and results/ (reference: config.py:5)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the whole training forward in the backward "
                        "(torch.utils.checkpoint): less activation memory, more "
                        "step time, the same gradients. Ignored for BatchNorm models "
                        "(SmaATUnet)")
    p.add_argument("--no-refiner-remat", action="store_true",
                   help="ADNMUnet only: keep the refiner Blocks' activations instead of "
                        "recomputing their forward in the backward: faster step, more memory")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (fp32 params/optimizer - mixed precision; the loss "
                        "is computed in fp32) for every model, with the JAX model's dtype at "
                        "each layer (the baselines turn fp32 where JAX promotes)")
    p.add_argument("--attn-type", default="standard", choices=["standard", "mla"],
                   help="ADNMUnet only: mixer at the AttentionBlock sites (standard softmax "
                        "attention or DeepSeek-V2 MLA)")
    p.add_argument("--transfer-dtype", default="float32", choices=["float32", "uint8"],
                   help="batch wire format host->device; uint8 ships round(x*255) "
                        "and normalizes on the device (4x fewer bytes)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pretrained-npz", default=None,
                   help="TransUnet only: load the encoder from a google-ViT R50+ViT-B/16 .npz "
                        "(train.npz_import.load_transunet_npz)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises when CUDA is absent) or cpu")
    add_mesh_args(p)
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host training: the rendezvous address (a TCP store that "
                        "process 0 opens). Run the SAME command in every process with "
                        "--num-processes/--process-id and --data-parallel; each process is one "
                        "rank on one card (LOCAL_RANK, else the process id modulo the visible "
                        "cards) and streams its --batch-size rows of every global batch "
                        "(validate/visualize collection stays on one host, as in JAX). "
                        "Under torchrun leave the three flags out: its RANK, WORLD_SIZE, "
                        "MASTER_ADDR and MASTER_PORT are read")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the optimizer state over the 'data' ranks "
                        "(ZeroRedundancyOptimizer) instead of replicating it; no effect on "
                        "one rank")


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    """``--data-parallel`` and ``--mesh``, the JAX package's mesh flags, for
    every CLI."""
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank per visible card (NCCL; one rank with --device cpu): train "
                        "data-parallel (DDP), or split validate/visualize/predict's batches "
                        "over the ranks; --batch-size is the global batch")
    p.add_argument("--mesh", default=None, metavar="AXIS=N,...",
                   help="explicit mesh, e.g. 'data=4', 'data=2,model=2' or "
                        "'data=1,seq=2': one rank per position (cards with cuda, NCCL; CPU "
                        "processes over gloo with --device cpu); implies --data-parallel. "
                        "Batches are split over 'data'; the ADNMUnet's frame rows in bands "
                        "over 'seq' and the heads and MLP hidden channels over 'model'. "
                        "Training takes at most two axes larger than 1 (data x seq or data x "
                        "model), as in JAX")


TASKS = {
    "Shanghai": (5, 20, 6, (20, 30, 35, 40)),
    "LAPS": (5, 3, 60, LAPS_THRESHOLDS),
}


def task_shape(args):
    """(input_frames, output_frames, frame_interval, thresholds) of
    ``args.dataset`` (reference: train.py:40-66; JAX:
    adnm_tpu/cli/common.py:91-96)."""
    return TASKS[args.dataset]


def resolve_ckpt(ckpt, root: str, missing: str, dataset: str = "Shanghai",
                 model: str = "ADNMUnet"):
    """The checkpoint an entry point loads: ``ckpt``, else the best under
    ``root`` (reference: config.py:8). Where that file does not exist,
    prints ``missing`` with the path in its ``{}`` and returns None: the
    caller keeps the fresh init."""
    path = ckpt or best_ckpt_dir(root, dataset, model)
    if os.path.exists(path):
        return path
    print(missing.format(path))
    return None


def compute_dtype(args) -> torch.dtype:
    """The activations' dtype of ``--bf16``."""
    return torch.bfloat16 if getattr(args, "bf16", False) else torch.float32


def model_kwargs(args) -> dict:
    """The ADNMUnet options of ``args`` for ``create_model``; with another
    model they exit, as in JAX (adnm_tpu/cli/common.py:173-178)."""
    kwargs = {}
    if getattr(args, "no_refiner_remat", False):
        if args.model != "ADNMUnet":
            raise SystemExit("--no-refiner-remat is only supported for --model ADNMUnet")
        kwargs["refiner_remat"] = False
    if args.attn_type != "standard":
        if args.model != "ADNMUnet":
            raise SystemExit("--attn-type is only supported for --model ADNMUnet")
        kwargs["attn_type"] = args.attn_type
    return kwargs


def load_pretrained_npz(model: torch.nn.Module, path: str) -> None:
    """``--pretrained-npz``: the encoder of the TransUnet ``model`` from the
    .npz at ``path`` (JAX: adnm_tpu/cli/common.py:205-215)."""
    from adnm_tpu_torch.train.npz_import import load_transunet_npz

    with np.load(path) as npz:
        tree = load_transunet_npz(npz, to_jax_params(model), model.hybrid_model.block_units,
                                  model.num_layers)
    from_jax_params(model, tree)
    print(f"loaded pretrained encoder from {path}")


@dataclasses.dataclass(frozen=True)
class Launch:
    """How a parallel command runs: ``world`` ranks in all, those of each
    'data' position stepping on its ``rows`` rows of every global batch
    (training); ``multihost`` when this process is one of them
    (``--coordinator`` or torchrun), else the command starts ``world``
    ranks itself on this host; ``seq`` and ``model`` ranks on the mesh's
    'seq' and 'model' axes, the rest on 'data'."""

    world: int
    rows: int
    multihost: bool
    model: int = 1
    seq: int = 1


def parallel_launch(args) -> Optional[Launch]:
    """The ``Launch`` of the parallel flags, None without them (one
    process, no process group): D x S x M ranks of a ``--mesh`` with
    'seq' and 'model' axes. Refuses, with the JAX package's messages
    where it has them (adnm_tpu/cli/common.py:131-172): three axes larger
    than 1; a multi-host run without a data mesh; a global batch that the
    'data' axis does not divide. ``--batch-size`` is the global batch
    under a single launch and each process's rows under a multi-host one,
    as in JAX."""
    mesh = parse_mesh(args.mesh) if args.mesh else None
    seq, model = (mesh.get("seq", 1), mesh.get("model", 1)) if mesh else (1, 1)
    multihost = multihost_flags(args)
    if multihost:
        given = (args.coordinator, args.num_processes, args.process_id)
        if any(v is None for v in given) and any(v is not None for v in given):
            raise SystemExit("--coordinator, --num-processes and --process-id go together "
                             "(or none of them, under torchrun)")
        processes = args.num_processes or int(os.environ["WORLD_SIZE"])
        if not (mesh or args.data_parallel):
            raise SystemExit("multi-host run without a mesh spanning all hosts' devices: add "
                             "--data-parallel (or a --mesh covering the processes' devices) - "
                             "otherwise each host would silently train an independent model "
                             "and race writes to the same checkpoint path")
        n_data = mesh["data"] if mesh else processes
        if (args.batch_size * processes) % n_data:
            raise SystemExit(f"--batch-size {args.batch_size} x {processes} hosts = "
                             f"{args.batch_size * processes} global rows per step, which does "
                             f"not divide the mesh 'data' axis ({n_data}); pick a divisible "
                             f"per-host batch size")
        if n_data * seq * model != processes:
            raise SystemExit(f"--mesh data={n_data},seq={seq},model={model} with {processes} "
                             f"processes: the port runs one rank, on one device, per process")
        return Launch(processes, args.batch_size * processes // n_data, True, model, seq)
    if mesh is None and not args.data_parallel:
        return None
    if mesh is not None:
        data = mesh["data"]
    else:
        data = torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 1
    world = data * seq * model
    if torch.device(args.device).type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"--mesh data={data},seq={seq},model={model}: {world} ranks, one a "
                         f"card, and only {torch.cuda.device_count()} CUDA device(s) are "
                         f"visible")
    if args.batch_size % data:
        raise SystemExit(f"--batch-size {args.batch_size} global rows per step does not divide "
                         f"the mesh 'data' axis ({data}); pick a divisible batch size")
    return Launch(world, args.batch_size // data, False, model, seq)


def multihost_flags(args) -> bool:
    """Whether this process is one of several started apart: the multi-host
    flags, or a launcher's environment."""
    return (getattr(args, "coordinator", None) is not None
            or getattr(args, "num_processes", None) is not None
            or getattr(args, "process_id", None) is not None or launched_by_torchrun())


def inference_launch(args, tool: str) -> Optional[Launch]:
    """The ``Launch`` of ``tool``'s (validate, visualize, predict) parallel
    flags, None without them: ``--mesh data=D[,seq=S][,model=M]`` starts
    D x S x M ranks on this host, ``--data-parallel`` one per visible card
    (one with --device cpu). A multi-process launch exits with the JAX
    package's reason (adnm_tpu/train/loop.py:519-525). The batches need not
    divide 'data': a tail leaves some ranks fewer rows."""
    if multihost_flags(args):
        raise SystemExit(f"{tool}: prediction collection fetches full output arrays, which are "
                         f"not addressable across hosts - run {tool} as a single host against "
                         f"the shared checkpoint (--mesh or --data-parallel start its ranks on "
                         f"this host)")
    mesh = parse_mesh(args.mesh, training=False) if args.mesh else None
    if mesh is None and not args.data_parallel:
        return None
    if mesh is not None:
        data, seq, model = mesh["data"], mesh.get("seq", 1), mesh.get("model", 1)
    else:
        data = torch.cuda.device_count() if resolve_device(args.device).type == "cuda" else 1
        seq = model = 1
    world = data * seq * model
    if torch.device(args.device).type == "cuda" and world > torch.cuda.device_count():
        raise SystemExit(f"--mesh data={data},seq={seq},model={model}: {world} ranks, one a "
                         f"card, and only {torch.cuda.device_count()} CUDA device(s) are "
                         f"visible")
    return Launch(world, args.batch_size, False, model, seq)


def run_on_mesh(run: Callable, args, launch: Launch):
    """``run(args, mesh=..., device=...)`` on each rank of ``launch``, on
    this host (``parallel.spawn``, one card a rank over NCCL, or CPU ranks
    over gloo), the hand kernels built first, once; returns rank 0's
    result without its ``trainer``."""
    if torch.device(args.device).type == "cuda" and args.model == "ADNMUnet":
        build_kernels(("rms_norm",))  # here, once, not once a rank
    with tempfile.TemporaryDirectory(prefix="adnm-mesh-") as tmp:
        out = os.path.join(tmp, "rank0.pt")
        spawn(mesh_rank_main, launch.world, args=(run, args, (launch.seq, launch.model), out),
              device=args.device)
        return torch.load(out, weights_only=False)  # written by rank 0 of this run


def mesh_rank_main(rank: int, world: int, device: torch.device, run: Callable, args,
                   axes: tuple, out: str) -> None:
    """One rank of ``run_on_mesh`` (or of a caller's own ``spawn``, such as
    ranks over gloo sharing one card): ``run`` on the (world / (S M), S, M)
    mesh of ``axes`` = (S, M), the sizes of 'seq' and 'model'; rank 0 writes
    its result, without its ``trainer``, to ``out``."""
    seq, model = axes
    mesh = make_mesh(world // (seq * model), seq, model, device)
    result = run(args, mesh=mesh, device=device)
    if rank == 0:
        torch.save({k: v for k, v in result.items() if k != "trainer"}
                   if isinstance(result, dict) else result, out)


def build(args, ddp: bool = False, rows: Optional[int] = None, device=None, mesh=None):
    """(Trainer, (train, val, test) loaders, (input_frames, output_frames,
    frame_interval, thresholds)): ``args.model`` from the port's registry
    with its preset; the reference init for ADNMUnet alone; TransUnet's
    encoder from ``--pretrained-npz`` where given. With ``ddp`` (inside a
    process group) the Trainer is data-parallel (``--zero1``), and the
    train loader yields this rank's 'data' position's ``rows`` rows of
    every global batch; with ``mesh`` it trains (under ``ddp``) and
    evaluates on that mesh. The val and test loaders are
    the whole sets at ``--batch-size``, as the single process's, on every
    rank (the Trainer takes each rank's rows of them)."""
    kwargs = model_kwargs(args)
    if args.pretrained_npz and args.model != "TransUnet":
        raise SystemExit("--pretrained-npz is only supported for --model TransUnet")
    shape = task_shape(args)
    input_frames, output_frames, frame_interval, _ = shape
    device = device or resolve_device(args.device)
    rows = rows or args.batch_size
    accum = getattr(args, "accum_steps", 1) or 1
    if rows % accum:
        raise SystemExit(f"--accum-steps {accum} must divide the {rows} rows a step of each "
                         f"rank (--batch-size {args.batch_size})")
    model = create_model(args.model, input_frames, output_frames, frame_interval,
                         img_size=args.img_size, **kwargs)
    preset = get_preset(args.model, input_frames, output_frames, frame_interval, args.dataset)
    trainer = Trainer(model, preset, input_frames, device, seed=args.seed,
                      param_transform=apply_reference_init if args.model == "ADNMUnet" else None,
                      remat_forward=args.remat, accum_steps=accum,
                      compute_dtype=compute_dtype(args), ddp=ddp,
                      zero1=getattr(args, "zero1", False),
                      scan_steps=getattr(args, "scan_steps", 1) or 1, mesh=mesh)
    if args.pretrained_npz:
        load_pretrained_npz(trainer.model, args.pretrained_npz)
    data_path = None if args.synthetic else args.data_path
    make = make_laps_datasets if args.dataset == "LAPS" else make_datasets
    tr, va, te = make(data_path, args.img_size, synthetic_len=args.synthetic_len)
    tdt = args.transfer_dtype
    return trainer, (
        BatchLoader(tr, rows, shuffle=True, seed=args.seed, transfer_dtype=tdt,
                    row_shard=(trainer.data_rank, trainer.data_world) if ddp else None),
        BatchLoader(va, args.batch_size, drop_last=False, transfer_dtype=tdt),
        BatchLoader(te, args.batch_size, drop_last=False, transfer_dtype=tdt),
    ), shape
