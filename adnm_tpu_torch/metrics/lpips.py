"""LPIPS with the AlexNet backbone (counterpart of
adnm_tpu/metrics/lpips_jax.py; reference: datasets/Shanghai_metrics.py:37-39,
154-169).

The reference uses the ``lpips`` pip package: AlexNet features and learned
per-layer 1x1 linear heads, pretrained. This module computes the same
architecture from an .npz of those weights:

  * set ``ADNM_LPIPS_WEIGHTS=/path/to/lpips_alex.npz``, with keys
    ``conv{0..4}_w`` (OIHW), ``conv{0..4}_b`` and ``lin{0..4}_w`` (O, I, 1, 1),
    as ``scripts/export_lpips.py`` writes them where the lpips package is
    installed.

Without weights ``default_lpips()`` raises and the evaluator reports LPIPS
as NaN.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# the ImageNet normalisation of lpips' scaling layer
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet features: (out_ch, kernel, stride, pad), max-pool(3, 2) after layers 0 and 1
_ALEX_CFG = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]


def _normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return feat / (feat.square().sum(dim=1, keepdim=True).sqrt() + eps)


class LpipsAlex:
    def __init__(self, weights_path: str, device="cpu"):
        raw = np.load(weights_path)
        self.device = torch.device(device)
        self.params = {}
        for i in range(5):
            for name in (f"conv{i}_w", f"conv{i}_b"):
                self.params[name] = torch.from_numpy(raw[name]).to(self.device, torch.float32)
            self.params[f"lin{i}_w"] = torch.from_numpy(raw[f"lin{i}_w"].reshape(-1)).to(
                self.device, torch.float32)
        self.shift = torch.from_numpy(_SHIFT).to(self.device).view(1, 3, 1, 1)
        self.scale = torch.from_numpy(_SCALE).to(self.device).view(1, 3, 1, 1)

    def _features(self, x: torch.Tensor):
        """x: (N, 3, H, W) in [-1, 1] -> the 5 ReLU feature maps."""
        x = (x - self.shift) / self.scale
        feats = []
        for i, (_, _, s, p) in enumerate(_ALEX_CFG):
            x = F.relu(F.conv2d(x, self.params[f"conv{i}_w"], self.params[f"conv{i}_b"],
                                stride=s, padding=p))
            feats.append(x)
            if i in (0, 1):
                x = F.max_pool2d(x, 3, 2)
        return feats

    @torch.no_grad()
    def __call__(self, pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
        """pred/true: (B, T, H, W) in [0, 1] -> (B, T) distances, after the
        reference's gray-to-RGB repeat and [-1, 1] scaling
        (Shanghai_metrics.py:155-158)."""
        b, t, h, w = pred.shape

        def rgb(v):
            return (v.reshape(b * t, 1, h, w).to(self.device, torch.float32) * 2 - 1).expand(
                -1, 3, -1, -1)

        total = 0.0
        for i, (xa, xb) in enumerate(zip(self._features(rgb(pred)), self._features(rgb(true)))):
            d = (_normalize(xa) - _normalize(xb)).square()
            lin = self.params[f"lin{i}_w"].view(1, -1, 1, 1)
            total = total + (d * lin).sum(dim=1).mean(dim=(1, 2))
        return total.reshape(b, t)


def default_lpips(device="cpu") -> LpipsAlex:
    path = os.environ.get("ADNM_LPIPS_WEIGHTS", "")
    if path and os.path.exists(path):
        return LpipsAlex(path, device)
    raise FileNotFoundError(
        "no LPIPS weights: set ADNM_LPIPS_WEIGHTS to an lpips_alex.npz "
        "(see adnm_tpu_torch/metrics/lpips.py docstring)"
    )
