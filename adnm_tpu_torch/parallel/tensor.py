"""Tensor parallelism over the mesh's 'model' axis, the 'data' axis's rows
in evaluation, and the 'seq' axis's bands of rows (counterpart of the
'model', 'data' and 'seq' annotations of
adnm_tpu/parallel/mesh.py::maybe_shard, :73-101).

The JAX modules annotate heads and hidden channels with the 'model' axis
and XLA partitions them; the port's modules ask here which of them this
rank computes and join the parts themselves:

* ``model_slice(n)``: this rank's range of ``n`` heads or channels, or None
  where they are not split: outside a mesh, on a 'model' axis of size 1,
  and where ``n`` does not divide by its size, as ``maybe_shard`` drops an
  axis that does not divide (the module then computes all of them, as
  every rank does);
* ``gather_model(x, dim)``: the ranks' parts of ``x``, concatenated along
  ``dim`` in rank order; ``reduce_model(x)``: their sum.

The active mesh is set around a forward with ``use_mesh`` (the
``Trainer`` and ``cli.predict.forecast`` do, as JAX's ``_mesh_ctx``); the
parameters are replicated on every rank (JAX's ``P()``) and a module slices
its weights at use. Outside ``use_mesh`` every function here is a no-op.

Over 'data' (``data_rows``, ``gather_data``, ``sum_data``) the rows of a
batch are split in contiguous, nearly equal parts in rank order; a batch
of fewer rows than positions leaves some with none, and those ranks still
take part in every collective. ``gather_data`` assembles a batch's rows
on every rank (a forward's output, which a next step may read), or with
``first`` on data position 0 alone (a test split's predictions, which
rank 0 alone evaluates).

Over 'seq' each rank of a 'data' position holds a contiguous band of the
rows of a frame, rows [s H / S, (s + 1) H / S) at 'seq' position s of S,
as P('data', 'seq') places them in JAX. The model decides which of its
levels are split (``seq_band``) and runs those stages inside
``split_rows``; there a module's input is this rank's band of its frame
(``banded``), and a module that reads across rows asks here for what lies
beyond its band:

* ``halo(x, top, bottom)``: the neighbours' edge rows stacked onto the
  band, zeros at the frame's own top and bottom edges (a convolution's
  zero padding);
* ``sum_seq(x)``: a sum over the 'seq' ranks (a norm's statistics, the
  duality's K^T V);
* ``gather_seq(x, dim)``: the bands in row order (the frame whole again);
* ``all_gather_seq(x)``: every 'seq' rank's ``x`` in order (the segment
  states that K2's carried scan exchanges, ``ops/ssd.py``).

Each of these, and ``gather_model`` and ``reduce_model``, is
differentiable, with the exact adjoint of what it computes across the
ranks as its backward, so that a rank's backward of its own loss gives
its share of the gradient of the sum of every rank's loss (the
per-rank-share convention): ``halo``'s is the reverse halo-add (the
gradients of the rows a neighbour received go back to it and are added
onto its edge rows; the zero rows at the frame's edges take none);
``sum_seq``'s and ``reduce_model``'s, the sum over the ranks of the
incoming gradient; a gather's (``gather_seq``, ``all_gather_seq``,
``gather_model``), a reduce-scatter (the sum over the ranks, then this
rank's part). A slice of a replicated tensor (a band cut at
``split_rows``, a weight sliced at ``model_slice``) takes autograd's
zero-padded scatter. The ranks of one 'data' position compute one loss,
so their gradients sum to S M times the position's gradient: the
``Trainer`` averages every gradient over all D S M ranks once, which gives
the global batch's mean gradient for split and replicated parameters
alike. The group and the positions are read when the forward runs and
kept for the backward, which runs outside ``use_mesh``; a recompute in the
backward (remat) re-enters the forward's mesh state through
``in_mesh_state``. ``TRAFFIC`` counts the backward's bytes under
"seq_backward" and "model_backward", apart from the forward's.

Transport: a collective runs on the process group of its mesh dimension,
over NCCL between cards and gloo on the CPU. Gloo has no all-gather for
CUDA tensors, which ranks sharing one card use: ``gather_model`` and
``gather_data`` stage such a tensor through host memory (a copy to the
host, the gather there, a copy back). This is a transport; the compute
stays on the card. A halo is point to point: over NCCL as one batch of
sends and receives, over gloo as sends and receives of host tensors
(staged the same way for CUDA tensors). A collective that fails raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist

_ACTIVE = None  # the DeviceMesh of the forward under way (``use_mesh``)
_SPLIT = False  # inside ``split_rows``: the modules see bands of their frames
# Bytes this rank sent in collectives, by axis: read by the smoke run.
TRAFFIC = {"model": 0, "data": 0, "seq": 0, "model_backward": 0, "seq_backward": 0}


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """``mesh`` (a ``DeviceMesh`` of ``parallel.make_mesh``, or None) active
    inside the block; the one before it is restored after."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, mesh
    try:
        yield
    finally:
        _ACTIVE = saved


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh``; 1 without a mesh."""
    if mesh is None:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's position on ``axis``; 0 without a mesh."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def model_slice(n: int) -> Optional[slice]:
    """This rank's part of ``n`` heads or channels on the active mesh's
    'model' axis, or None where they are not split."""
    m = axis_size(_ACTIVE, "model")
    if m == 1 or n % m:
        return None
    r, part = axis_rank(_ACTIVE, "model"), n // m
    return slice(r * part, (r + 1) * part)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a gather of ``x`` goes through host memory: gloo gathers no
    CUDA tensor."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_gather(x: torch.Tensor, group, first: bool = False) -> Optional[list]:
    """Every rank's ``x`` (one shape on all ranks) in rank order of ``group``;
    with ``first``, on the group's first rank alone (None on the others)."""
    src = x.contiguous()
    staged = _staged(src, group)
    if staged:
        src = src.cpu()
    dst = dist.get_global_rank(group, 0) if first else None
    parts = None
    if dst is None or dist.get_rank() == dst:
        parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    if dst is None:
        dist.all_gather(parts, src, group=group)
    else:
        dist.gather(src, parts, dst=dst, group=group)
    if parts is None:
        return None
    return [p.to(x.device) for p in parts] if staged else parts


class _Gather(torch.autograd.Function):
    """Every rank's ``x`` of ``group`` (one shape on all) in rank order;
    the backward is a reduce-scatter: this rank's part of the sum over the
    ranks of the parts' gradients (every rank's output holds this rank's
    ``x``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, axis: str):
        ctx.group, ctx.axis = group, axis
        ctx.rank = dist.get_group_rank(group, dist.get_rank())
        TRAFFIC[axis] += x.numel() * x.element_size()
        return tuple(_all_gather(x, group))

    @staticmethod
    def backward(ctx, *grads):
        like = next(g for g in grads if g is not None)
        parts = torch.stack([torch.zeros_like(like) if g is None else g for g in grads])
        TRAFFIC[f"{ctx.axis}_backward"] += parts.numel() * parts.element_size()
        if dist.get_backend(ctx.group) == "nccl":
            out = torch.empty_like(like)
            dist.reduce_scatter_tensor(out, parts, group=ctx.group)
            return out, None, None
        # gloo has no reduce-scatter: the sum on every rank, then this rank's part
        dist.all_reduce(parts, group=ctx.group)
        return parts[ctx.rank].clone(), None, None


class _AllReduce(torch.autograd.Function):
    """The sum of ``x`` over ``group``, the same bits on each rank; the
    backward is the sum over the ranks of the incoming gradients (every
    rank's output reads every rank's ``x``). Both write into copies, so
    autograd never sees a tensor it saved change."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, axis: str):
        ctx.group, ctx.axis = group, axis
        TRAFFIC[axis] += x.numel() * x.element_size()
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        TRAFFIC[f"{ctx.axis}_backward"] += grad.numel() * grad.element_size()
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None, None


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The 'model' ranks' parts of ``x`` concatenated along ``dim`` in rank
    order (each rank's part as ``model_slice`` gave it); ``x`` itself on a
    'model' axis of size 1."""
    if axis_size(_ACTIVE, "model") == 1:
        return x
    return torch.cat(_Gather.apply(x, _ACTIVE.get_group("model"), "model"), dim=dim)


def reduce_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the 'model' ranks, the same bits on each; ``x``
    itself on a 'model' axis of size 1."""
    if axis_size(_ACTIVE, "model") == 1:
        return x
    return _AllReduce.apply(x, _ACTIVE.get_group("model"), "model")


def row_counts(mesh, n: int) -> list:
    """The rows of an ``n``-row batch at each 'data' position, in order."""
    d = axis_size(mesh, "data")
    return [(i + 1) * n // d - i * n // d for i in range(d)]


def data_rows(mesh, n: int) -> slice:
    """This rank's rows of an ``n``-row batch: its 'data' position's part."""
    d, i = axis_size(mesh, "data"), axis_rank(mesh, "data")
    return slice(i * n // d, (i + 1) * n // d)


def sum_data(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the 'data' positions (one rank of each: the
    ranks of this rank's 'model' position), the same bits on each."""
    if axis_size(mesh, "data") == 1:
        return x
    TRAFFIC["data"] += x.numel() * x.element_size()
    out = x.clone()
    dist.all_reduce(out, group=mesh.get_group("data"))
    return out


def gather_data(mesh, x: Optional[torch.Tensor], n: int,
                first: bool = False) -> Optional[torch.Tensor]:
    """The ``n`` rows of a batch from the 'data' positions' parts, in order:
    ``x`` holds this rank's ``data_rows`` (None, or no rows, where it has
    none). Every rank of the 'data' group receives them; with ``first``,
    the group's first rank alone (data position 0; None on the others).
    The parts are padded to the largest for the gather; where a position
    has no rows, the shape of a row comes first from the others."""
    if axis_size(mesh, "data") == 1:
        return x
    group = mesh.get_group("data")
    counts = row_counts(mesh, n)
    if min(counts) == 0:  # every rank knows n, so all take this branch together
        shape = torch.zeros(8, dtype=torch.int64, device=mesh_device(mesh))
        if x is not None and x.shape[0]:
            shape[0] = x.dim()
            shape[1:x.dim()] = torch.tensor(x.shape[1:])
        dist.all_reduce(shape, op=dist.ReduceOp.MAX, group=group)
        row = tuple(int(v) for v in shape[1:int(shape[0])])
        if x is None or not x.shape[0]:
            x = torch.zeros((0, *row), dtype=torch.float32, device=mesh_device(mesh))
    part = torch.zeros((max(counts), *x.shape[1:]), dtype=x.dtype, device=x.device)
    part[:x.shape[0]] = x
    TRAFFIC["data"] += part.numel() * part.element_size()
    parts = _all_gather(part, group, first)
    return None if parts is None else torch.cat([p[:c] for p, c in zip(parts, counts)])


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its CUDA device, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---- the 'seq' axis: bands of rows --------------------------------------------


def band_rows(h: int) -> slice:
    """This rank's band of an ``h``-row level on the active mesh's 'seq'
    axis: rows [s h / S, (s + 1) h / S) (all of them without one)."""
    n, s = axis_size(_ACTIVE, "seq"), axis_rank(_ACTIVE, "seq")
    return slice(s * h // n, (s + 1) * h // n)


def seq_band(h: int, multiple: int = 1, min_rows: int = 1) -> Optional[slice]:
    """This rank's rows of an ``h``-row level, or None where the level is
    not split: outside a mesh, on a 'seq' axis of size 1, where ``h`` does
    not divide by its size (as ``maybe_shard`` drops the axis), and where a
    band's rows are not a multiple of ``multiple`` or fewer than
    ``min_rows`` (what the ops that read the band need: an even band for a
    Haar DWT or a 2x2 pool, rows that each wavelet level halves, room for
    a kernel's halo)."""
    n = axis_size(_ACTIVE, "seq")
    if n == 1 or h % n or (h // n) % multiple or h // n < min_rows:
        return None
    return band_rows(h)


@contextlib.contextmanager
def split_rows(band: Optional[slice]) -> Iterator[None]:
    """Inside the block the modules' inputs are bands of their frames over
    'seq' where ``band`` is not None (a stage the model splits), whole
    frames where it is None; the state before is restored after."""
    global _SPLIT
    saved, _SPLIT = _SPLIT, band is not None and axis_size(_ACTIVE, "seq") > 1
    try:
        yield
    finally:
        _SPLIT = saved


def banded() -> bool:
    """Whether the modules now see this rank's band of each frame
    (``split_rows`` on a 'seq' axis larger than 1)."""
    return _SPLIT


def in_mesh_state(fn: Callable) -> Callable:
    """``fn`` run, wherever it is called later, under the active mesh and
    the band state of now (``use_mesh``, ``split_rows``): a remat's
    recompute in the backward runs outside both, and must compute as the
    forward did, with the same collectives in the same order on every
    rank."""
    state = (_ACTIVE, _SPLIT)

    def run(*args, **kwargs):
        global _ACTIVE, _SPLIT
        saved, (_ACTIVE, _SPLIT) = (_ACTIVE, _SPLIT), state
        try:
            return fn(*args, **kwargs)
        finally:
            _ACTIVE, _SPLIT = saved

    return run


def seq_size() -> int:
    """The size of the active mesh's 'seq' axis (1 without one)."""
    return axis_size(_ACTIVE, "seq")


def _global(group, i: int) -> int:
    return dist.get_global_rank(group, i)


def _p2p(sends: list, recvs: list, group) -> None:
    """Send each (tensor, group rank) of ``sends`` and receive into each of
    ``recvs``, all at once: one batch over NCCL, separate requests over
    gloo."""
    if dist.get_backend(group) == "nccl":
        ops = [dist.P2POp(dist.isend, t, _global(group, r), group) for t, r in sends]
        ops += [dist.P2POp(dist.irecv, t, _global(group, r), group) for t, r in recvs]
        reqs = dist.batch_isend_irecv(ops) if ops else []
    else:
        reqs = [dist.isend(t, _global(group, r), group=group) for t, r in sends]
        reqs += [dist.irecv(t, _global(group, r), group=group) for t, r in recvs]
    for req in reqs:
        req.wait()


class _Halo(torch.autograd.Function):
    """``halo``'s exchange; the backward is the reverse halo-add: the
    gradients of the rows received from a neighbour go back to it and are
    added onto its edge rows (those of the zero rows at the frame's edges
    go nowhere)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, top: int, bottom: int, dim: int, group, n: int, s: int):
        rows = x.shape[dim]
        ctx.top, ctx.bottom, ctx.dim, ctx.group, ctx.n, ctx.s = top, bottom, dim, group, n, s
        staged = _staged(x, group)
        dev = torch.device("cpu") if staged else x.device

        def edge(start: int, length: int) -> torch.Tensor:
            return x.narrow(dim, start, length).contiguous().to(dev)

        above, below = _rows_like(x, top, dim, dev), _rows_like(x, bottom, dim, dev)
        sends, recvs = [], []
        if s > 0:  # the rank above: it takes my first rows, I take its last
            if bottom:
                sends.append((edge(0, bottom), s - 1))
            if top:
                recvs.append((above, s - 1))
        if s < n - 1:  # the rank below: it takes my last rows, I take its first
            if top:
                sends.append((edge(rows - top, top), s + 1))
            if bottom:
                recvs.append((below, s + 1))
        TRAFFIC["seq"] += sum(t.numel() * t.element_size() for t, _ in sends)
        _p2p(sends, recvs, group)
        return torch.cat([above.to(x.device), x, below.to(x.device)], dim=dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        top, bottom, dim, group, n, s = ctx.top, ctx.bottom, ctx.dim, ctx.group, ctx.n, ctx.s
        rows = grad.shape[dim] - top - bottom
        staged = _staged(grad, group)
        dev = torch.device("cpu") if staged else grad.device

        def part(start: int, length: int) -> torch.Tensor:
            return grad.narrow(dim, start, length).contiguous().to(dev)

        from_above, from_below = (_rows_like(grad, bottom, dim, dev),
                                  _rows_like(grad, top, dim, dev))
        sends, recvs = [], []
        if s > 0:  # my top halo was the rank above's last rows; it read my first
            if top:
                sends.append((part(0, top), s - 1))
            if bottom:
                recvs.append((from_above, s - 1))
        if s < n - 1:  # my bottom halo was the rank below's first rows; it read my last
            if bottom:
                sends.append((part(top + rows, bottom), s + 1))
            if top:
                recvs.append((from_below, s + 1))
        TRAFFIC["seq_backward"] += sum(t.numel() * t.element_size() for t, _ in sends)
        _p2p(sends, recvs, group)
        dx = grad.narrow(dim, top, rows).clone()
        if s > 0 and bottom:
            dx.narrow(dim, 0, bottom).add_(from_above.to(grad.device))
        if s < n - 1 and top:
            dx.narrow(dim, rows - top, top).add_(from_below.to(grad.device))
        return dx, None, None, None, None, None, None


def _rows_like(x: torch.Tensor, length: int, dim: int, dev: torch.device) -> torch.Tensor:
    """Zeros of ``x``'s shape with ``length`` rows along ``dim``, on ``dev``."""
    shape = list(x.shape)
    shape[dim] = length
    return torch.zeros(shape, dtype=x.dtype, device=dev)


def halo(x: torch.Tensor, top: int, bottom: int, dim: int = 2) -> torch.Tensor:
    """This rank's band ``x`` with the last ``top`` rows (along ``dim``) of
    the rank above stacked on top and the first ``bottom`` rows of the rank
    below underneath; zeros where the band is at the frame's top or bottom
    edge, as a convolution's zero padding gives there. Every 'seq' rank
    calls it with the same ``top`` and ``bottom``, neither larger than a
    band."""
    rows = x.shape[dim]
    if top > rows or bottom > rows:
        raise ValueError(f"a halo of {top} + {bottom} rows around a band of {rows}")
    return _Halo.apply(x, top, bottom, dim, _ACTIVE.get_group("seq"), seq_size(),
                       axis_rank(_ACTIVE, "seq"))


def sum_seq(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the 'seq' ranks, the same bits on each; ``x``
    itself on a 'seq' axis of size 1."""
    if seq_size() == 1:
        return x
    return _AllReduce.apply(x, _ACTIVE.get_group("seq"), "seq")


def all_gather_seq(x: torch.Tensor) -> list:
    """Every 'seq' rank's ``x`` (one shape on all), in 'seq' order."""
    if seq_size() == 1:
        return [x]
    return list(_Gather.apply(x, _ACTIVE.get_group("seq"), "seq"))


def gather_seq(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The 'seq' ranks' bands of a frame concatenated along ``dim`` in row
    order (every band of one size); ``x`` itself on a 'seq' axis of size 1."""
    if seq_size() == 1:
        return x
    return torch.cat(all_gather_seq(x), dim=dim)


def seq_group():
    """The process group of the active mesh's 'seq' axis."""
    return _ACTIVE.get_group("seq")


def exchange(x: torch.Tensor, group, key: str) -> list:
    """Every rank's ``x`` of ``group`` in rank order (an all-gather with no
    gradient, for the small records a collective's own forward or backward
    trades: K2's carried states and adjoints), its bytes counted under
    ``TRAFFIC[key]``."""
    TRAFFIC[key] += x.numel() * x.element_size()
    return _all_gather(x, group)


def seq_position() -> int:
    """This rank's position on the active mesh's 'seq' axis (0 without one)."""
    return axis_rank(_ACTIVE, "seq")
