"""The host-side radar decode and resize of the port (counterpart of
adnm_tpu/data/native.py): ``csrc/radar_io.cpp`` built with g++ at first use
into the package's build directory (``ops._build``'s rules) and called
through ctypes.

``decode_resize_clip`` turns a (T, H, W) uint8 clip into (T, S, S) float32
frames in [0, 1]: /255 and an antialiased bilinear resize, one frame per
thread. ``data/shanghai.py`` decodes every h5 clip with it. A failed build
raises; ``ADNM_NATIVE=0`` (the JAX package's switch) selects the one-thread
``F.interpolate`` path instead, explicitly.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from adnm_tpu_torch.ops._build import load_library

SOURCES = ("radar_io.cpp",)
_lib = None


def enabled() -> bool:
    """False where ``ADNM_NATIVE=0`` selects the ``F.interpolate`` path."""
    return os.environ.get("ADNM_NATIVE", "1") != "0"


def get_lib() -> ctypes.CDLL:
    """The library, built on first use; raises if it cannot be built."""
    global _lib
    if _lib is None:
        lib = load_library("radar_io", SOURCES, host=True)
        lib.decode_resize_clip.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ]
        lib.decode_resize_clip.restype = None
        _lib = lib
    return _lib


def decode_resize_clip(frames_u8: np.ndarray, out_size: int, n_threads: int = 4) -> np.ndarray:
    """(T, H, W) uint8 -> (T, out_size, out_size) float32 in [0, 1]."""
    lib = get_lib()
    frames_u8 = np.ascontiguousarray(frames_u8, np.uint8)
    if frames_u8.ndim != 3:
        raise ValueError(f"expected (T, H, W) uint8 frames, got shape {frames_u8.shape}")
    t, h, w = frames_u8.shape
    out = np.empty((t, out_size, out_size), np.float32)
    lib.decode_resize_clip(
        frames_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), t, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_size, n_threads,
    )
    return out
