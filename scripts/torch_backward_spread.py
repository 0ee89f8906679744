"""Where two training steps' gradients of one batch differ on the card, for
the PyTorch port.

    python3 scripts/torch_backward_spread.py

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
Needs CUDA.
"""

from __future__ import annotations

import os
import sys
import warnings

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from adnm_tpu_torch.device import resolve_device  # noqa: E402
from adnm_tpu_torch.ops import _build, ssd  # noqa: E402
from adnm_tpu_torch.ops import rms_norm as k1  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_backward_spread: CUDA is not available")
    print(chip_smoke.card_line())
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

    variants = {"as shipped": shipped,
                "cuDNN deterministic for the whole step": cudnn_deterministic,
                "use_deterministic_algorithms(warn_only)": deterministic_warnings}
    for label, kwargs in (("duality", {}), ("bimamba", {"linear_attn_duality": False})):
        trainer = chip_smoke.make_trainer(device, refiner_remat=False, **kwargs)
        for variant, run in variants.items():
            spread, sources = run(trainer)
            print(f"{label}, {variant}: gradients' max_abs_diff {spread:.3e}; module calls "
                  f"whose gradients differ from equal output gradients: {sources}")
        del trainer
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
