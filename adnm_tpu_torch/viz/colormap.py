"""Radar reflectivity colormap (a copy of adnm_tpu/viz/colormap.py;
reference: datasets/Shanghai.py:63-102, duplicated at
pic_results.py:66-100).

gray2color maps uint8 reflectivity to RGBA via a 16-color palette with
BoundaryNorm bins. Implemented with pure numpy (np.digitize ==
matplotlib BoundaryNorm for these monotone bounds), so no matplotlib
dependency on the hot path.
"""

from __future__ import annotations

import numpy as np

PIXEL_SCALE = 90.0

COLOR_MAP = np.array(
    [
        [0, 0, 0, 0],
        [0, 236, 236, 255],
        [1, 160, 246, 255],
        [1, 0, 246, 255],
        [0, 239, 0, 255],
        [0, 200, 0, 255],
        [0, 144, 0, 255],
        [255, 255, 0, 255],
        [231, 192, 0, 255],
        [255, 144, 2, 255],
        [255, 0, 0, 255],
        [166, 0, 0, 255],
        [101, 0, 0, 255],
        [255, 0, 255, 255],
        [153, 85, 201, 255],
        [255, 255, 255, 255],
    ]
) / 255.0

# rendering bounds from pic_results.py:88 (note: ends at 80, unlike the
# dataset module's PIXEL_SCALE-terminated variant at Shanghai.py:82)
BOUNDS = [0, 5, 10, 15, 20, 25, 30, 35, 40, 45, 50, 55, 60, 65, 70, 75, 80]
THRESHOLDS = [20, 30, 35, 40]


def gray2color(image: np.ndarray, cmap=None, bounds=None) -> np.ndarray:
    """uint8 image -> (H, W, 4) float RGBA (reference: pic_results.py:93-100)."""
    cm = COLOR_MAP if cmap is None else cmap
    bounds = BOUNDS if bounds is None else bounds
    # BoundaryNorm: bin i for bounds[i] <= v < bounds[i+1]; clip outside
    idx = np.digitize(image, bounds[1:-1], right=False)
    idx = np.clip(idx, 0, len(cm) - 1)
    return np.asarray(cm)[idx]
