"""Batch loader with background prefetch (counterpart of
adnm_tpu/data/loader.py, single host; reference: train.py:55-57).

A thread assembles (B, T, 1, S, S) batches ahead of consumption, so h5
reads and resizes overlap the device's work. ``device_prefetch`` keeps
the next batches' host-to-device copies in flight from pinned memory.
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
                 seed: int = 0, transfer_dtype: str = "float32"):
        """``transfer_dtype="uint8"`` ships batches as round(x * 255) uint8
        instead of float32: 4x fewer host-to-device bytes; the Trainer
        brings them back to [0, 1] on the device. Up to the post-resize
        requantization (<= 1/510 per pixel) that is the h5 clips' own
        storage format."""
        if transfer_dtype not in ("float32", "uint8"):
            raise ValueError(f"transfer_dtype must be float32|uint8, got {transfer_dtype}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.transfer_dtype = transfer_dtype
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        for i in range(len(self)):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]

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


def to_device(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``: for CUDA, copied from pinned memory
    without waiting (the copy is ordered on the current stream)."""
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
