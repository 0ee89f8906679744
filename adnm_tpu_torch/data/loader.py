"""Batch loader with background prefetch (counterpart of
adnm_tpu/data/loader.py; reference: train.py:55-57).

A thread assembles (B, T, 1, S, S) batches ahead of consumption, so h5
reads and resizes overlap the device's work. ``device_prefetch`` keeps
the next batches' host-to-device copies in flight from pinned memory;
``grouped`` stacks K batches into one (K, B, T, 1, S, S) group for
``Trainer(scan_steps=K)``, sent in one copy.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                 seed: int = 0, transfer_dtype: str = "float32",
                 shard: tuple[int, int] | None = None, row_shard: tuple[int, int] | None = None):
        """``transfer_dtype="uint8"`` ships batches as round(x * 255) uint8
        instead of float32: 4x fewer host-to-device bytes; the Trainer
        brings them back to [0, 1] on the device. Up to the post-resize
        requantization (<= 1/510 per pixel) that is the h5 clips' own
        storage format.

        Sharding over ranks, as in the JAX package:

        ``row_shard=(rank, world)``: each rank yields its ``batch_size``
        rows of every GLOBAL batch (global batch = batch_size x world; the
        tail smaller than a global batch is dropped). The shuffle comes from
        the shared seed, so the ranks' rows are disjoint and every rank
        sees the SAME number of batches by construction, as data-parallel
        training needs: each batch is one collective step, and a rank with
        fewer steps would hang the others.

        ``shard=(rank, world)``: each rank reads every world-th whole batch.
        Ranks may get DIFFERENT batch counts, so this is for independent
        per-rank work (such as sharded offline evaluation), not for
        lockstep training. The two are exclusive."""
        if shard and row_shard:
            raise ValueError("shard and row_shard are exclusive")
        if transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype must be float32|uint8, got {transfer_dtype}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.transfer_dtype = transfer_dtype
        self.shard = shard
        self.row_shard = row_shard
        self._epoch = 0

    def _batches(self) -> int:
        """The number of whole batches of the dataset, before sharding."""
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __len__(self) -> int:
        if self.row_shard is not None:
            return len(self.dataset) // (self.batch_size * self.row_shard[1])
        if self.shard is not None:
            rank, world = self.shard
            return len(range(rank, self._batches(), world))
        return self._batches()

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        b = self.batch_size
        if self.row_shard is not None:
            rank, world = self.row_shard
            for i in range(len(self)):  # this rank's rows of global batch i
                yield order[(i * world + rank) * b:(i * world + rank + 1) * b]
            return
        rank, world = self.shard or (0, 1)
        for i in range(rank, self._batches(), world):
            yield order[i * b:(i + 1) * b]

    def _make_batch(self, idxs) -> np.ndarray:
        batch = np.stack([self.dataset[int(i)] for i in idxs])[:, :, None]  # (B, T, 1, S, S)
        if self.transfer_dtype == "uint8":
            return np.clip(np.rint(batch * 255.0), 0, 255).astype(np.uint8)
        return np.ascontiguousarray(batch, np.float32)

    def __iter__(self) -> Iterator[np.ndarray]:
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=2)  # two batches assembled ahead
        batches = list(self._index_batches())

        def worker():
            for idxs in batches:
                q.put(self._make_batch(idxs))
            q.put(None)

        threading.Thread(target=worker, daemon=True).start()
        while (b := q.get()) is not None:
            yield b


def grouped(batches: Iterable[np.ndarray], k: int) -> Iterator[np.ndarray]:
    """``batches`` stacked k at a time into (k, B, ...) groups (JAX:
    ``grouped`` in adnm_tpu/train/loop.py:433-446). A batch of another shape
    than the group's (a ``drop_last=False`` tail) flushes the group: the
    batches held and the odd one then come one at a time, as do those left
    at the end. ``k = 1`` yields the batches as they are."""
    if k == 1:
        yield from batches
        return
    buf: list = []
    for b in batches:
        b = np.asarray(b)
        if buf and b.shape != buf[0].shape:
            yield from buf
            buf = []
        buf.append(b)
        if len(buf) == k:
            yield np.stack(buf)
            buf = []
    yield from buf


def to_device(batch, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: for CUDA, copied from pinned memory
    without waiting (the copy is ordered on the current stream). A tensor
    already on a device goes there as it is."""
    if isinstance(batch, torch.Tensor) and batch.device.type != "cpu":
        return batch.to(device)
    t = torch.from_numpy(np.ascontiguousarray(batch))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def device_prefetch(batches: Iterable[np.ndarray], device: torch.device,
                    depth: int = 2) -> Iterator[torch.Tensor]:
    """Yield the batches on ``device``, keeping ``depth`` of them already
    sent, so host-to-device copies overlap the step."""
    buf: collections.deque = collections.deque()
    for batch in batches:
        buf.append(to_device(batch, device))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
