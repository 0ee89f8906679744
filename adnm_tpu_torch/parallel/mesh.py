"""The JAX package's device mesh as ranks of processes (counterpart of
adnm_tpu/parallel/mesh.py and of the mesh flags of
adnm_tpu/cli/common.py).

The JAX package shards the batch over a mesh's 'data' axis, the rows of
the frames over its 'seq' axis and, for inference, heads and hidden
channels over its 'model' axis; XLA inserts the collectives. The port runs
one process per position of the mesh, ranks numbered in the axes' order
('data', 'seq', 'model'), the last fastest, as JAX lays its devices out
(rank = (d * S + s) * M + m).
Over 'data' each rank holds a replica of the model and its rows of every
global batch: in training DistributedDataParallel averages the gradients
and the port's BatchNorm reduces its statistics over the ranks
(``core/layers.py::BatchNorm``); in evaluation each position runs its rows
and the predictions are gathered in order (``train/loop.py``). Over
'model' the mixers and the FeedForward split their heads and hidden
channels (``parallel/tensor.py``). Over 'seq' the ADNM-UNet's pyramid
rows and refiner tokens are split in bands, each rank holding its
contiguous rows of every frame of its 'data' rows (``models/adnm_unet.py``).
All three serve validate, visualize and predict; training takes a
('data', 'seq') or a ('data', 'model') mesh, with or without ZeRO-1, and
refuses three axes larger than 1 with the JAX package's reason
(``TRAINING_AXES``; adnm_tpu/parallel/mesh.py:103-144): the port's
collectives would run there, but the JAX package trains on no such mesh.
Every collective's backward is its exact adjoint and the ``Trainer``
averages the gradients over all ranks (``parallel/tensor.py``,
``train/loop.py``). On the CPU the ranks are gloo processes
(``spawn(..., device="cpu")``, or ``cli.train --mesh ... --device cpu``);
on the card a card a rank over NCCL, or gloo ranks sharing one card
(``spawn(..., backend="gloo", shared_device=True)``).

``make_mesh`` gives the mesh as a ``DeviceMesh`` with the dimensions
("data", "seq", "model"), each with its process group: NCCL between cards,
gloo on the CPU and for ranks that share one card.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from adnm_tpu_torch.device import resolve_device
from adnm_tpu_torch.parallel.multihost import finish_multihost, init_multihost


# Where what is not ported yet is queued: the graphed step across ranks.
NOT_PORTED = "ROADMAP §1 item 5.3"
# The JAX package trains on at most two axes larger than 1
# (adnm_tpu/parallel/mesh.py::assert_training_mesh).
TRAINING_AXES = 2
MESH_DIMS = ("data", "seq", "model")


def parse_mesh(spec: str, training: bool = True) -> dict:
    """{axis: size} of an ``AXIS=N,...`` mesh spec, with the JAX package's
    checks and messages (adnm_tpu/cli/common.py::_parse_mesh): entries
    AXIS=N with N a positive integer, no axis twice, a 'data' axis. Exits
    on what the port does not run: an axis other than 'data', 'seq' and
    'model' larger than 1, and with ``training`` three axes larger than 1
    (JAX's reason, ``training_mesh_error``)."""
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
    other = [f"{a}={n}" for a, n in mesh.items() if a not in MESH_DIMS and n > 1]
    if other:
        raise SystemExit(f"--mesh: {', '.join(other)}: the port's mesh has the axes 'data', "
                         f"'seq' and 'model'")
    hot = [a for a in MESH_DIMS if mesh.get(a, 1) > 1]
    if training and len(hot) > TRAINING_AXES:
        raise SystemExit(f"--mesh: {training_mesh_error(hot)}")
    return mesh


def training_mesh_error(hot: list) -> str:
    """The JAX package's refusal of training on the axes ``hot``, more than
    two larger than 1 (adnm_tpu/parallel/mesh.py:134-144)."""
    return (f"Training on a mesh with >=3 non-trivial axes {hot} is disabled: XLA v0.9.0 "
            f"miscomputes weight gradients on such meshes (exact-factor double-counting at "
            f"reshard boundaries; see tests/test_parallel.py::TestXlaThreeAxisGradDefect and "
            f"adnm_tpu/parallel/mesh.py). Use a 2-axis mesh — e.g. data x seq for training, "
            f"and keep the 'model' (tensor-parallel) axis for inference sharding — or fold "
            f"axes together.")


def check_training_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Raise a ValueError (the JAX package's, ``training_mesh_error``)
    where ``mesh`` has three axes larger than 1; None passes."""
    if mesh is None:
        return
    hot = [a for i, a in enumerate(mesh.mesh_dim_names) if mesh.size(i) > 1]
    if len(hot) > TRAINING_AXES:
        raise ValueError(training_mesh_error(hot))


_MESHES: dict = {}


def make_mesh(data: int, seq: int = 1, model: int = 1,
              device: torch.device = torch.device("cpu")) -> DeviceMesh:
    """The ("data", "seq", "model") mesh of ``data`` x ``seq`` x ``model``
    ranks over the process group, which must hold exactly that many, each
    dimension with a process group of its own (the backend of the default
    group). Rank (d * seq + s) * model + m sits at position (d, s, m): the
    axes in the order of JAX's mesh, the last fastest, as JAX lays the
    devices of a mesh out (the port's spec order is fixed; the JAX CLI
    keeps the spec's, adnm_tpu/cli/common.py:99-122). Made once per shape
    and device type in a process group (every rank calls it at the same
    point: a group's creation is collective); ``finish_multihost`` forgets
    it with the group."""
    world = dist.get_world_size()
    if data * seq * model != world:
        raise ValueError(f"a mesh of data={data} x seq={seq} x model={model} ranks in a process "
                         f"group of {world}")
    key = (torch.device(device).type, data, seq, model)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(key[0], (data, seq, model), mesh_dim_names=MESH_DIMS)
    return _MESHES[key]


def forget_meshes() -> None:
    """Drop the meshes made in this process group (before its teardown)."""
    _MESHES.clear()


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
