"""The data axis of the JAX package's device mesh, as ranks of processes
(counterpart of adnm_tpu/parallel/mesh.py and of the mesh flags of
adnm_tpu/cli/common.py).

The JAX package shards the batch over a ('data',) mesh; XLA then
all-reduces the gradients and takes BatchNorm's statistics over the whole
batch. The port runs one process per position of the 'data' axis: each
rank holds a replica of the model and its rows of every global batch,
DistributedDataParallel averages the gradients, and the port's BatchNorm
reduces its statistics over the ranks (``core/layers.py::BatchNorm``).
The 'seq' and 'model' axes (the refiner's token sharding, heads and
channels over cards) are not ported yet.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.multiprocessing as mp

from adnm_tpu_torch.device import resolve_device
from adnm_tpu_torch.parallel.multihost import finish_multihost, init_multihost


def parse_mesh(spec: str) -> dict:
    """{axis: size} of an ``AXIS=N,...`` mesh spec, with the JAX package's
    checks and messages (adnm_tpu/cli/common.py::_parse_mesh): entries
    AXIS=N with N a positive integer, no axis twice, a 'data' axis. An
    axis other than 'data' larger than 1 exits: the port shards the batch
    alone."""
    mesh = {}
    for part in spec.split(","):
        name, eq, n = part.partition("=")
        name = name.strip()
        if not eq or not name or not n.strip().isdecimal() or int(n) < 1:
            raise SystemExit(f"--mesh: malformed entry {part!r} (expected AXIS=N with "
                             f"N a positive integer, e.g. 'data=4,seq=2')")
        if name in mesh:
            raise SystemExit(f"--mesh: duplicate axis {name!r}")
        mesh[name] = int(n)
    if "data" not in mesh:
        raise SystemExit("--mesh: a 'data' axis is required (the batch is sharded over "
                         "'data'); add data=1 for a non-data-parallel mesh")
    sharded = [f"{a}={n}" for a, n in mesh.items() if a != "data" and n > 1]
    if sharded:
        raise SystemExit(f"--mesh: {', '.join(sharded)}: the port shards the batch over "
                         f"'data' only; the 'seq' and 'model' axes (the refiner's token "
                         f"sharding, tensor parallelism) are not ported yet (ROADMAP)")
    return mesh


def _run_rank(local_rank: int, fn: Callable, world: int, init_method: str, device: str,
              backend: Optional[str], shared_device: bool, args: tuple) -> None:
    if torch.device(device).type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dev = resolve_device(device, 0 if shared_device else local_rank)  # fp32 without TF32
    rank, world = init_multihost(init_method, world, local_rank, dev, backend)
    # A failed rank leaves at once: the others may wait in a collective, so
    # a teardown barrier would only hold this process; the parent ends them.
    fn(rank, world, dev, *args)
    finish_multihost()


def spawn(fn: Callable, world: int, args: tuple = (), device: str = "cuda",
          backend: Optional[str] = None, shared_device: bool = False,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, world, device, *args)`` in ``world`` new processes on
    this host, one per rank, joined in one process group: rank i on
    ``cuda:i`` (every rank on ``cuda:0`` with ``shared_device``) or on the
    CPU, resolved as the entry points resolve theirs (``resolve_device``:
    fp32 without TF32), over NCCL or gloo as ``init_multihost`` picks
    unless ``backend`` names one. ``fn`` and ``args`` are pickled (``fn`` by its import path).
    The ranks meet at a file in a new temporary directory, so launches
    never collide. Returns when every rank has finished; raises when one
    fails (the others are ended) or when ``timeout_s`` passes (all are
    ended)."""
    with tempfile.TemporaryDirectory(prefix="adnm-rdzv-") as tmp:
        init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
        ctx = mp.start_processes(_run_rank, args=(fn, world, init_method, str(device), backend,
                                                  shared_device, args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {world} ranks of {fn.__name__} did not finish "
                                       f"within {timeout_s:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
