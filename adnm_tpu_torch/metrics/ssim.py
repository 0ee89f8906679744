"""SSIM with cv2 parity (counterpart of adnm_tpu/metrics/ssim.py;
reference: datasets/Shanghai_metrics.py:132-152).

The reference filters with cv2.filter2D (11x11 Gaussian, sigma 1.5) and
crops [5:-5, 5:-5]; after the crop every remaining pixel has a fully
valid window, so border mode is irrelevant and the whole thing is a VALID
depthwise correlation: one grouped ``F.conv2d`` over the five stacked
filter inputs (img1, img2, img1*img2, img1^2, img2^2), on the inputs'
device, in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel_11_15(device=None) -> torch.Tensor:
    """cv2.getGaussianKernel(11, 1.5), float64: the analytic formula cv2
    uses for sigma > 0. Made on ``device`` itself, with no copy from the
    host, so a CUDA graph can capture the SSIM."""
    i = torch.arange(11, dtype=torch.float64, device=device)
    k = torch.exp(-((i - 5.0) ** 2) / (2.0 * 1.5 * 1.5))
    return k / k.sum()


def cv2_parity_ssim(img1: torch.Tensor, img2: torch.Tensor,
                    value_scale: float = 90.0) -> torch.Tensor:
    """Per-frame SSIM of (..., H, W) frames already in the 0..value_scale
    range (the reference multiplies by value_scale before cal_ssim,
    Shanghai_metrics.py:117-128). Returns the (...,) mean SSIM per frame."""
    c1 = (0.01 * value_scale) ** 2
    c2 = (0.03 * value_scale) ** 2
    lead = img1.shape[:-2]
    h, w = img1.shape[-2:]
    a = img1.reshape(-1, h, w).to(torch.float32)
    b = img2.reshape(-1, h, w).to(torch.float32)
    x = torch.stack([a, b, a * b, a * a, b * b], dim=1)  # (N, 5, H, W)
    k = gaussian_kernel_11_15(a.device)
    win = torch.outer(k, k).to(torch.float32)
    y = F.conv2d(x, win.expand(5, 1, 11, 11), groups=5)
    mu1, mu2, mu12, m1sq, m2sq = y.unbind(1)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = m1sq - mu1_sq
    sigma2_sq = m2sq - mu2_sq
    sigma12 = mu12 - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(-2, -1)).reshape(lead)
