"""Multi-process training support (counterpart of
adnm_tpu/parallel/multihost.py).

The JAX package runs one process per host over a device mesh that spans
every host, and XLA inserts the collectives. The port runs one process per
rank, each on one device (a card, or the CPU), joined by
``torch.distributed``: NCCL between cards, gloo on the CPU. Gloo also
reduces CUDA tensors, which lets two ranks share one card (the one-card
rehearsal of ``chip_smoke.py``; NCCL refuses two ranks on one card).

Wiring (``cli/train.py``, ``parallel/mesh.py::spawn``):

  1. ``init_multihost(...)`` before the model is built: the rank, the
     world size and the device's backend.
  2. Per-rank input: ``BatchLoader(..., row_shard=(rank, world))``: every
     rank takes its rows of every global batch, so every rank runs the
     same number of steps by construction (a rank with fewer steps would
     hang the others' collectives).
  3. ``Trainer(..., ddp=True, zero1=...)``: DistributedDataParallel over
     the process group, cross-rank BatchNorm statistics, the optimizer
     state sharded over the ranks under ZeRO-1.
  4. ``finish_multihost()`` at the end: a barrier, then the group's
     teardown, while every process is at the same point.

Training, the loss and the gradient norm are multi-process safe: every
rank holds the same global values. Evaluation shards the val and test
batches over the ranks and gathers the predictions in order
(``Trainer.eval_epoch``); validate, visualize and predict run on a mesh of
one host (``parallel/mesh.py``), as in JAX, whose prediction collection is
not addressable across hosts.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# A collective that waits longer than this raises on every rank. Kernel
# builds and model set-up are kept out of it: ranks meet at
# ``host_barrier`` (a store wait, with its own timeout) before their first
# collective.
COLLECTIVE_TIMEOUT_S = 1800.0
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def launched_by_torchrun() -> bool:
    """True when the launcher's environment names this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device: torch.device = torch.device("cuda"),
                   backend: Optional[str] = None,
                   timeout_s: float = COLLECTIVE_TIMEOUT_S) -> tuple[int, int]:
    """Join the process group and return (rank, world size).

    ``coordinator`` is ``HOST:PORT`` (a TCP store on that host, which rank 0
    opens) or a URL with its own scheme (``file://...`` for ranks on one
    host); ``num_processes`` and ``process_id`` are the world size and this
    process's rank. With all three absent it reads the launcher's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (torchrun), the
    counterpart of JAX's autodetection on pods. The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU, unless ``backend`` names one;
    a CUDA ``device`` becomes the process's current device first."""
    given = (coordinator, num_processes, process_id)
    if all(v is None for v in given):
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_multihost: no --coordinator/--num-processes/--process-id "
                               f"and no launcher environment (missing {missing})")
        init_method, rank, world = "env://", int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    elif any(v is None for v in given):
        raise ValueError("init_multihost: give the coordinator, the number of processes and "
                         "the process id together (or none, under torchrun)")
    else:
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        rank, world = process_id, num_processes
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def is_multiprocess() -> bool:
    """True inside a process group of two or more ranks."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_barrier(name: str, timeout_s: float = 3600.0) -> None:
    """Block until every rank reaches the barrier ``name``. A wait on the
    group's store, not a device collective: ranks may arrive minutes apart
    (kernel builds, model set-up) without tripping a collective's timeout.
    A barrier name may be used again; each use is its own barrier. No-op
    outside a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    store = dist.distributed_c10d._get_default_store()
    world = dist.get_world_size()
    key = f"adnm_barrier/{name}"
    arrived = store.add(key, 1)
    done = f"{key}/{(arrived - 1) // world}"  # this use's generation
    if arrived % world == 0:
        store.set(done, "1")
    store.wait([done], datetime.timedelta(seconds=timeout_s))


def finish_multihost() -> None:
    """Synchronised teardown: a barrier, then ``destroy_process_group``
    while every rank is at the same point. No-op outside a process group."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    from adnm_tpu_torch.parallel.mesh import forget_meshes

    host_barrier("adnm:finish")
    forget_meshes()  # their groups go with the default one
    dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose gradient is the sum over the ranks of
    the gradients (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (the default
    group when None)."""
    return _AllReduceSum.apply(x, group)
