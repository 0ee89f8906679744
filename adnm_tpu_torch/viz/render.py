"""Prediction-strip renderer (counterpart of adnm_tpu/viz/render.py;
reference: pic_results.py:104-219).

vis_res writes pred/gt/input sequences as horizontal PNG strips with
white gaps; even_index_only subsamples seq[1::2] (the reference's "even
index" selection, pic_results.py:131-140). The PNGs are written with the
standard library (zlib, struct): 8-bit, no PIL or cv2 needed.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Optional

import numpy as np

from adnm_tpu_torch.viz.colormap import gray2color as _default_gray2color

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, rgba: np.ndarray) -> None:
    """An (H, W, 4) uint8 image as an 8-bit RGBA PNG: IHDR, one IDAT of
    unfiltered rows, IEND."""
    if rgba.dtype != np.uint8 or rgba.ndim != 3 or rgba.shape[2] != 4:
        raise ValueError(f"write_png takes (H, W, 4) uint8, got {rgba.shape} {rgba.dtype}")
    h, w, _ = rgba.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))  # 6: RGBA
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _save_png(path: str, rgba: np.ndarray) -> None:
    write_png(path, (np.clip(rgba, 0, 1) * 255).astype(np.uint8))


def _process_seq(seq, pixel_scale):
    seq = np.asarray(seq).squeeze()
    if pixel_scale is not None:
        seq = (seq * pixel_scale).astype(np.uint8)
    return seq


def _grid_with_gap(seq: np.ndarray, gap: int) -> Optional[np.ndarray]:
    if len(seq) == 0:
        return None
    h, w, c = seq[0].shape
    gap_img = np.ones((h, gap, c), dtype=seq[0].dtype)
    parts = []
    for i, img in enumerate(seq):
        parts.append(img)
        if i < len(seq) - 1:
            parts.append(gap_img)
    return np.concatenate(parts, axis=1)


def vis_res(
    pred_seq,
    gt_seq=None,
    save_path: str = "result_pics",
    pic_name: str = "pred",
    pixel_scale: Optional[float] = 90.0,
    gray2color: Optional[Callable] = _default_gray2color,
    cmap=None,
    gap: int = 10,
    input_seq=None,
    even_index_only: bool = False,
):
    """Reference: pic_results.py:104-184 (vis_res)."""
    pred_seq = _process_seq(pred_seq, pixel_scale)
    if gt_seq is not None:
        gt_seq = _process_seq(gt_seq, pixel_scale)
    if input_seq is not None:
        input_seq = _process_seq(input_seq, pixel_scale)
    os.makedirs(save_path, exist_ok=True)

    def select(seq):
        return seq[1::2] if even_index_only else seq

    pred_seq = select(pred_seq)
    if gt_seq is not None:
        gt_seq = select(gt_seq)

    def colorize(seq):
        if gray2color is not None:
            return np.array([gray2color(seq[i], cmap=cmap) for i in range(len(seq))])
        return seq

    grid_pred = _grid_with_gap(colorize(pred_seq), gap)
    _save_png(os.path.join(save_path, f"{pic_name}.png"), grid_pred)
    if gt_seq is not None:
        _save_png(os.path.join(save_path, "gt.png"), _grid_with_gap(colorize(gt_seq), gap))
    if input_seq is not None:
        _save_png(os.path.join(save_path, "input.png"), _grid_with_gap(colorize(input_seq), gap))


def vis_res_1b1(
    pred_seq,
    save_path: str = "result_pics",
    pixel_scale: Optional[float] = 90.0,
    gray2color: Optional[Callable] = _default_gray2color,
    cmap=None,
):
    """One PNG per frame (reference: pic_results.py:192-219)."""
    pred_seq = _process_seq(pred_seq, pixel_scale)
    os.makedirs(save_path, exist_ok=True)
    for i in range(pred_seq.shape[0]):
        _save_png(os.path.join(save_path, f"gt{i}.png"), gray2color(pred_seq[i], cmap=cmap))
