"""Where two training steps' gradients of one batch differ on the card, for
the PyTorch port.

    python3 scripts/torch_backward_spread.py [MODEL ...]

The backward counterpart of ``scripts/torch_forward_spread.py``. Runs the
full-width duality and bimamba ADNM-UNet (seeded weights, the reference
init, 256^2, batch 1, the refiner without remat so that module hooks fire
once) through ``Trainer.grads`` twice on one batch, every module's output
and input gradients hooked (``chip_smoke.grad_spread_sources``), and prints
the largest difference of the two runs' parameter gradients and the module
calls whose output gradients were equal and whose input or own parameters'
gradients were not: as shipped, with cuDNN held to its deterministic
algorithms for the whole step, and under
``torch.use_deterministic_algorithms(True, warn_only=True)``, whose
warnings name the operations without a deterministic implementation.
With model names (SmaATUnet, ConvLSTM, TrajGRU, LPTQPN) it runs those
baselines instead (``chip_smoke.baseline_trainer``, 256^2, batch 1), and
two variants more: TrajGRU's warp on ``grid_sample``'s own backward, and
SmaAt's upsample as ``F.interpolate``, each the form the port replaced.
Needs CUDA.
"""

from __future__ import annotations

import os
import sys
import warnings

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from adnm_tpu_torch.device import resolve_device  # noqa: E402
from adnm_tpu_torch.models import smaat_unet, traj_gru  # noqa: E402
from adnm_tpu_torch.ops import _build, ssd  # noqa: E402
from adnm_tpu_torch.ops import rms_norm as k1  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_backward_spread: CUDA is not available")
    print(chip_smoke.card_line())
    models = sys.argv[1:] or ["duality", "bimamba"]
    if {"duality", "bimamba"} & set(models):  # the baselines run no hand kernel
        chip_smoke.build_all(_build, {"rms_norm": k1.SOURCES, "ssd_scan": ssd.SOURCES})
    device = resolve_device("cuda")
    batch = chip_smoke.train_batch(1)
    cudnn = torch.backends.cudnn

    def shipped(trainer):
        return chip_smoke.grad_spread_sources(trainer, batch)

    def cudnn_deterministic(trainer):
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                         allow_tf32=False):
            return chip_smoke.grad_spread_sources(trainer, batch)

    def deterministic_warnings(trainer):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                out = chip_smoke.grad_spread_sources(trainer, batch)
            finally:
                torch.use_deterministic_algorithms(False)
        names = sorted({str(w.message).split("\n")[0][:160] for w in caught
                        if "deterministic" in str(w.message)})
        print(f"  operations without a deterministic implementation: {names}")
        return out

    def patched(owner, name, value):
        def run(trainer):
            saved = getattr(owner, name)
            setattr(owner, name, value)
            try:
                return shipped(trainer)
            finally:
                setattr(owner, name, saved)
        return run

    class GridSampleOwnBackward:
        @staticmethod
        def apply(img, grid):
            return F.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

    def interpolate(x, factor=2):
        return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=True)

    variants = {"as shipped": shipped,
                "cuDNN deterministic for the whole step": cudnn_deterministic,
                "use_deterministic_algorithms(warn_only)": deterministic_warnings}
    extra = {"TrajGRU": {"the warp on grid_sample's own backward": patched(
                 traj_gru, "_GridSample", GridSampleOwnBackward)},
             "SmaATUnet": {"the upsample as F.interpolate": patched(
                 smaat_unet, "upsample_bilinear_align_corners", interpolate)}}
    for label in models:
        if label in ("duality", "bimamba"):
            kwargs = {} if label == "duality" else {"linear_attn_duality": False}
            trainer = chip_smoke.make_trainer(device, refiner_remat=False, **kwargs)
        else:
            trainer = chip_smoke.baseline_trainer(label, device)
        for variant, run in {**variants, **extra.get(label, {})}.items():
            spread, sources = run(trainer)
            print(f"{label}, {variant}: gradients' max_abs_diff {spread:.3e}; module calls "
                  f"whose gradients differ from equal output gradients: {sources}")
        del trainer
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
