"""Nowcast metrics of the port: the evaluator, SSIM and LPIPS."""

from adnm_tpu_torch.metrics.evaluator import SimplifiedEvaluator, metrics_table, print_metrics
from adnm_tpu_torch.metrics.ssim import cv2_parity_ssim

__all__ = ["SimplifiedEvaluator", "cv2_parity_ssim", "metrics_table", "print_metrics"]
