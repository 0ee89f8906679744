"""The LAPS task's data and evaluator (counterpart of adnm_tpu/data/laps.py).

The reference imports ``datasets/LAPS.py`` and ``datasets/LAPS_metrics.py``
(train.py:42-43) but neither file exists there; the JAX package restored
the path and the port follows it:

  * 5 input frames -> 3 output frames at a 60-minute interval, rain-rate
    thresholds (0.1, 0.3, 0.5, 0.7, 0.8) (``cli/common.py::TASKS``);
  * clips stored as Shanghai's (``ShanghaiDataset``) with 8-frame
    synthetic clips, bit-equal to the JAX package's;
  * ``laps_evaluate(preds, gts, thresholds)``, the reference's call on
    flat arrays (train.py:233-235), returning and printing CSI, POD, HSS
    and FAR per threshold.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from adnm_tpu_torch.data.shanghai import ShanghaiDataset

LAPS_THRESHOLDS = (0.1, 0.3, 0.5, 0.7, 0.8)


class LAPSDataset(ShanghaiDataset):
    """8-frame (5 in + 3 out) clips, in Shanghai's storage."""

    def __init__(self, data_path: Optional[str], img_size: int = 256, split: str = "train",
                 synthetic_len: int = 64):
        super().__init__(data_path, img_size, split, synthetic_len=synthetic_len, seq_len=8)


def make_laps_datasets(data_path: Optional[str], img_size: int = 256, synthetic_len: int = 64):
    return tuple(LAPSDataset(data_path, img_size, s, synthetic_len=synthetic_len)
                 for s in ("train", "val", "test"))


def laps_evaluate(preds: np.ndarray, gts: np.ndarray,
                  thresholds: Sequence[float] = LAPS_THRESHOLDS, verbose: bool = True) -> dict:
    """{threshold: TP, FN, FP, TN, CSI, POD, FAR, HSS} over the flattened
    arrays. As in the reference, ``preds`` takes the observation slot:
    a hit is counted where both exceed the threshold, a miss (FN) where
    only ``preds`` does."""
    obs = np.asarray(preds).reshape(-1)
    sim = np.asarray(gts).reshape(-1)
    out = {}
    for thr in thresholds:
        o, s = obs >= thr, sim >= thr
        TP = int(np.sum(o & s))
        FN = int(np.sum(o & ~s))
        FP = int(np.sum(~o & s))
        TN = int(np.sum(~o & ~s))
        CSI = TP / (TP + FP + FN) if TP + FP + FN else float("nan")
        POD = TP / (TP + FN) if TP + FN else float("nan")
        FAR = FP / (TP + FP) if TP + FP else float("nan")
        HSS = (2 * (TP * TN - FP * FN)) / (
            FP**2 + FN**2 + 2 * TP * TN + (FP + FN) * (TP + TN)
        ) if (TP + TN + FP + FN) else float("nan")
        out[thr] = {"TP": TP, "FN": FN, "FP": FP, "TN": TN,
                    "CSI": CSI, "POD": POD, "FAR": FAR, "HSS": HSS}
        if verbose:
            print(f"{thr}mm CSI: {CSI:.4f} POD: {POD:.4f} HSS: {HSS:.4f} FAR: {FAR:.4f}")
    return out
