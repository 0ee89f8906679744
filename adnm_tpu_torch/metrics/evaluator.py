"""Streaming nowcast evaluator (counterpart of adnm_tpu/metrics/evaluator.py;
reference: datasets/Shanghai_metrics.py).

The reference's SimplifiedEvaluator: CSI/POD/HSS/FAR per threshold and
MAE/MSE/RMSE/PSNR/SSIM/LPIPS. The per-frame work of a batch (the
contingency counts per threshold, MAE, MSE and SSIM) runs on ``device``
in a few tensor ops; the aggregation stays on the host in float64, line
for line as in the JAX package.

Orientation quirk kept: ``evaluate(true_batch, pred_batch)`` is called by
the reference's scripts as ``evaluate(preds, gts)`` (train.py:241,
validate.py:117), so POD/FAR have hit/miss roles swapped relative to
their names. The port's CLIs call it the same way.

LPIPS needs AlexNet weights (``adnm_tpu_torch.metrics.lpips``); without
them it is reported as NaN and ``LPIPS_available`` is False.
"""

from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import numpy as np
import torch

from adnm_tpu_torch.device import resolve_device
from adnm_tpu_torch.metrics.ssim import cv2_parity_ssim


def _batch_stats(true_b: torch.Tensor, pred_b: torch.Tensor, thresholds: Tuple,
                 value_scale: float):
    """Per-frame contingency counts and regression losses of a batch.

    true_b/pred_b: (B, T, H, W) fp32 in [0, 1] (already clipped), on one
    device. Returns counts (n_thr, B, T, 4) int64 [TP, FN, FP, TN] with
    obs = true_b as in _cal_frame (Shanghai_metrics.py:105-114), and (B, T)
    MAE, MSE and SSIM in the 0..value_scale domain.
    """
    # float2int: clip -> *scale -> truncation (Shanghai_metrics.py:45-47)
    gt_i = torch.floor(true_b * value_scale).to(torch.int32)
    pr_i = torch.floor(pred_b * value_scale).to(torch.int32)
    counts = []
    for thr in thresholds:
        obs = gt_i >= thr
        sim = pr_i >= thr
        cells = [obs & sim, obs & ~sim, ~obs & sim, ~obs & ~sim]
        counts.append(torch.stack([c.sum(dim=(-2, -1), dtype=torch.int64) for c in cells], -1))
    counts = torch.stack(counts, dim=0)

    ts = true_b * value_scale
    ps = pred_b * value_scale
    mae = (ps - ts).abs().mean(dim=(-2, -1))
    mse = (ps - ts).square().mean(dim=(-2, -1))
    ssim = cv2_parity_ssim(ps, ts, value_scale)
    return counts, mae, mse, ssim


class SimplifiedEvaluator:
    """Drop-in equivalent of the reference evaluator
    (datasets/Shanghai_metrics.py:14-314)."""

    def __init__(self, seq_len: int, value_scale: float,
                 thresholds: Sequence[int] = (20, 30, 35, 40), lpips_fn=None,
                 device="cuda"):
        """``device``: where each batch's statistics are computed (cuda by
        default, raising when CUDA is absent; the CLIs pass the trainer's).
        ``lpips_fn``: (pred, true) (B, T, H, W) tensors -> (B, T); None
        loads ``default_lpips()``, and without weights LPIPS is NaN."""
        self.seq_len = seq_len
        self.value_scale = value_scale
        self.thresholds = list(thresholds)
        self.device = resolve_device(device)
        if lpips_fn is None:
            from adnm_tpu_torch.metrics.lpips import default_lpips

            try:
                lpips_fn = default_lpips(self.device)
            except FileNotFoundError as e:
                warnings.warn(f"LPIPS disabled, reported as NaN ({e})", stacklevel=2)
                lpips_fn = None
        self.lpips_fn = lpips_fn
        self.reset()

    def reset(self):
        self.metrics = {
            t: {"hits": [], "misses": [], "falsealarms": [], "correctnegs": []}
            for t in self.thresholds
        }
        self.losses = {k: [] for k in ("mse", "mae", "rmse", "psnr", "ssim", "lpips")}
        self.total = 0
        self.TP, self.TN, self.FP, self.FN = [], [], [], []

    def _on_device(self, batch) -> torch.Tensor:
        # fp32 whatever the model computed in (bf16 predictions included)
        return torch.as_tensor(batch).to(self.device, torch.float32).clamp(0.0, 1.0)

    @torch.no_grad()
    def evaluate(self, true_batch, pred_batch):
        """true_batch/pred_batch: (B, T, H, W) arrays or tensors. NOTE the
        reference's scripts pass (preds, gts): keep that orientation."""
        true_b = self._on_device(true_batch)
        pred_b = self._on_device(pred_batch)
        counts, mae, mse, ssim = (t.cpu().numpy() for t in _batch_stats(
            true_b, pred_b, tuple(self.thresholds), float(self.value_scale)))
        rmse = np.sqrt(mse)
        psnr = 20 * np.log10(self.value_scale / np.sqrt(mse))

        bsz = true_b.shape[0]
        for k, thr in enumerate(self.thresholds):
            self.metrics[thr]["hits"].extend(counts[k, :, :, 0].tolist())
            self.metrics[thr]["misses"].extend(counts[k, :, :, 1].tolist())
            self.metrics[thr]["falsealarms"].extend(counts[k, :, :, 2].tolist())
            self.metrics[thr]["correctnegs"].extend(counts[k, :, :, 3].tolist())
        self.losses["mae"].extend(mae.tolist())
        self.losses["mse"].extend(mse.tolist())
        self.losses["rmse"].extend(rmse.tolist())
        self.losses["psnr"].extend(psnr.tolist())
        self.losses["ssim"].extend(ssim.tolist())
        if self.lpips_fn is not None:
            lp = self.lpips_fn(pred_b, true_b).cpu().numpy()  # (B, T)
            self.losses["lpips"].extend(lp.tolist())
        else:
            self.losses["lpips"].extend(np.full((bsz, true_b.shape[1]), np.nan).tolist())
        self.total += bsz

    def done(self) -> dict:
        """Aggregate (reference: Shanghai_metrics.py:218-290)."""
        threshold_metrics = {}
        all_far = []
        tp_sum = tn_sum = fp_sum = fn_sum = 0
        for thr in self.thresholds:
            hits = np.nan_to_num(np.array(self.metrics[thr]["hits"], dtype=np.float64))
            misses = np.nan_to_num(np.array(self.metrics[thr]["misses"], dtype=np.float64))
            fas = np.nan_to_num(np.array(self.metrics[thr]["falsealarms"], dtype=np.float64))
            cns = np.nan_to_num(np.array(self.metrics[thr]["correctnegs"], dtype=np.float64))
            TP, TN, FP, FN = hits.sum(), cns.sum(), fas.sum(), misses.sum()
            tp_sum += TP
            tn_sum += TN
            fp_sum += FP
            fn_sum += FN
            with np.errstate(divide="ignore", invalid="ignore"):
                CSI = TP / (TP + FP + FN)
                POD = TP / (TP + FN)
                HSS = (2 * (TP * TN - FP * FN)) / (
                    FP**2 + FN**2 + 2 * TP * TN + (FP + FN) * (TP + TN)
                )
                FAR = FP / (TP + FP)
            all_far.append(FAR)
            threshold_metrics[thr] = {
                "TP": TP, "TN": TN, "FP": FP, "FN": FN,
                "CSI": CSI, "POD": POD, "HSS": HSS,
            }
        n_thr = len(self.thresholds)
        self.TP.append(tp_sum / n_thr)
        self.FP.append(fp_sum / n_thr)
        self.TN.append(tn_sum / n_thr)
        self.FN.append(fn_sum / n_thr)
        rmse = np.mean(np.sqrt(np.mean(np.array(self.losses["mse"]), axis=0)))
        ssim = np.mean(self.losses["ssim"])
        lpips_v = np.mean(self.losses["lpips"])
        return {
            "threshold_metrics": threshold_metrics,
            "FAR": np.mean(all_far),
            "RMSE": rmse,
            "SSIM": ssim,
            "LPIPS": lpips_v,
            # consumers check this before publishing an LPIPS column: without
            # weights the column is NaN, never silently comparable
            "LPIPS_available": self.lpips_fn is not None,
        }


def metrics_table(results: dict, pod: bool = False) -> str:
    """The reference scripts' table, as ``print_metrics`` prints it: CSI
    (and POD, validate's) and HSS per threshold, then FAR, RMSE, SSIM and
    LPIPS (train.py:241-250, validate.py:117-126)."""
    lines = []
    for thresh, m in results["threshold_metrics"].items():
        middle = f" POD: {m['POD']:.4f}" if pod else ""
        lines.append(f"{thresh}mm CSI: {m['CSI']:.4f}{middle} HSS: {m['HSS']:.4f}")
    if not pod:
        lines += ["", "Overall Metrics:"]
    lines += [f"FAR:  {results['FAR']:.4f}", f"RMSE: {results['RMSE']:.2f}",
              f"SSIM: {results['SSIM']:.4f}"]
    if results["LPIPS_available"]:
        lines.append(f"LPIPS: {results['LPIPS']:.4f}")
    else:
        lines.append("LPIPS: UNAVAILABLE (no pretrained weights: set ADNM_LPIPS_WEIGHTS to an "
                     "exported lpips_alex.npz; the column must NOT be compared)")
    return "\n".join(lines) + "\n"


def print_metrics(results: dict, pod: bool = False) -> None:
    """Print ``metrics_table``."""
    print(metrics_table(results, pod), end="")
