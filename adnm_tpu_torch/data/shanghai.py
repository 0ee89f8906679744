"""Shanghai radar HDF5 clips (counterpart of adnm_tpu/data/shanghai.py;
reference: datasets/Shanghai.py).

  * shanghai.h5's 'train' group holds 25-frame uint8 clips (25, 565, 784),
    range 0..70; per item: /255, resize to img_size (default 256), shape
    (25, S, S) float32 (Shanghai.py:52-59).
  * The 'train' group is split 0.7 / 0.15 / 0.15 into train/val/test
    (Shanghai.py:131-136).
  * Each clip is kept in memory after its first read, as the reference
    materializes the set (Shanghai.py:126).
  * An h5 clip is decoded and resized by the native library
    (``data/native.py``, multithreaded C++), as the JAX package does
    (adnm_tpu/data/shanghai.py:116-121); ``ADNM_NATIVE=0`` selects the
    one-thread ``F.interpolate`` path, which agrees within 3e-7.

Without the h5 file a synthetic mode makes structured moving-blob fields
from numpy seeds, bit-equal to the JAX package's. ``h5py`` is imported
only when an h5 file is read.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from adnm_tpu_torch.data import native


def _resize_bilinear_antialias(frames: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W) float -> (T, size, size): bilinear with antialiasing, as
    torchvision's Resize does on tensors (the JAX package uses
    ``jax.image.resize(..., "bilinear", antialias=True)``)."""
    t = torch.from_numpy(np.ascontiguousarray(frames, np.float32))[:, None]
    out = F.interpolate(t, size=(size, size), mode="bilinear", align_corners=False,
                        antialias=True)
    return out[:, 0].numpy()


def decode_clip(imgs: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W) uint8 -> (T, size, size) float32 in [0, 1]: the native
    decode, or with ``ADNM_NATIVE=0`` /255 and ``F.interpolate``."""
    if native.enabled():
        return native.decode_resize_clip(imgs, size)
    return _resize_bilinear_antialias(imgs.astype(np.float32) / 255.0, size)


def _synthetic_clip(rng: np.random.Generator, frames: int, size: int) -> np.ndarray:
    """Structured moving-blob radar-like field in [0, 1], (frames, S, S)."""
    n_blobs = rng.integers(2, 5)
    ys = rng.uniform(0, size, n_blobs)
    xs = rng.uniform(0, size, n_blobs)
    vy = rng.uniform(-2, 2, n_blobs)
    vx = rng.uniform(-2, 2, n_blobs)
    amp = rng.uniform(0.3, 0.85, n_blobs)
    sig = rng.uniform(size / 16, size / 6, n_blobs)
    yy, xx = np.mgrid[0:size, 0:size]
    clip = np.zeros((frames, size, size), np.float32)
    for t in range(frames):
        f = np.zeros((size, size), np.float32)
        for i in range(n_blobs):
            cy = (ys[i] + vy[i] * t) % size
            cx = (xs[i] + vx[i] * t) % size
            f += amp[i] * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig[i] ** 2)))
        clip[t] = np.clip(f, 0, 1)
    return clip


class ShanghaiDataset:
    """Index-addressable clip store with the reference's split semantics."""

    def __init__(self, data_path: Optional[str], img_size: int = 256, split: str = "train",
                 synthetic_len: int = 64, seq_len: int = 25):
        if split not in ("train", "val", "test"):
            raise ValueError(f"split must be train, val or test, got {split!r}")
        self.img_size = img_size
        self.split = split
        self.seq_len = seq_len
        self._cached: dict[int, np.ndarray] = {}
        self.synthetic = data_path is None or not os.path.exists(data_path)
        self._h5 = None
        if self.synthetic:
            base = {"train": 0, "val": 10_000, "test": 20_000}[split]
            share = {"train": 0.7, "val": 0.15, "test": 0.15}[split]
            self._indices = list(range(base, base + max(int(synthetic_len * share), 1)))
            self.data_path = None
        else:
            import h5py

            self.data_path = data_path
            with h5py.File(data_path, "r") as f:
                total = int(f["train"]["all_len"][()])
            train_end, val_end = math.floor(total * 0.7), math.floor(total * 0.85)
            self._indices = {
                "train": list(range(0, train_end)),
                "val": list(range(train_end, val_end)),
                "test": list(range(val_end, total)),
            }[split]

    def __len__(self) -> int:
        return len(self._indices)

    def _load(self, raw_index: int) -> np.ndarray:
        if self.synthetic:
            return _synthetic_clip(np.random.default_rng(raw_index), self.seq_len, self.img_size)
        import h5py

        if self._h5 is None:
            self._h5 = h5py.File(self.data_path, "r")
        imgs = self._h5["train"][str(raw_index)][()]  # (25, 565, 784) uint8
        return decode_clip(imgs, self.img_size)

    def __getitem__(self, index: int) -> np.ndarray:
        """Returns (seq_len, img_size, img_size) float32 in [0, 1]."""
        raw = self._indices[index]
        if raw not in self._cached:
            self._cached[raw] = self._load(raw)
        return self._cached[raw]


def make_datasets(data_path: Optional[str], img_size: int = 256, synthetic_len: int = 64
                  ) -> Tuple[ShanghaiDataset, ShanghaiDataset, ShanghaiDataset]:
    return tuple(ShanghaiDataset(data_path, img_size, s, synthetic_len=synthetic_len)
                 for s in ("train", "val", "test"))
