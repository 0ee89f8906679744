"""Radar colormap and prediction strips of the port (PNG through the
standard library)."""

from adnm_tpu_torch.viz.colormap import BOUNDS, COLOR_MAP, THRESHOLDS, gray2color
from adnm_tpu_torch.viz.render import vis_res, vis_res_1b1

__all__ = ["BOUNDS", "COLOR_MAP", "THRESHOLDS", "gray2color", "vis_res", "vis_res_1b1"]
