"""Where two forwards of one input differ on the card, for the PyTorch port.

    python3 scripts/torch_forward_spread.py

Runs the full-width duality and bimamba ADNM-UNet (seeded weights, 256^2,
batch 1) twice on one input with every module's inputs and outputs hooked
(``chip_smoke.spread_sources``), and prints the output's largest
difference and the module calls that computed differently from equal
inputs: once as shipped, once with the transposed convolutions on cuDNN's
default algorithm choice (``ConvTranspose2d``'s deterministic flag undone),
and once with K1 swapped for its plain version. Needs CUDA.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from adnm_tpu_torch.cli import predict  # noqa: E402
from adnm_tpu_torch.core import layers  # noqa: E402
from adnm_tpu_torch.ops import _build  # noqa: E402
from adnm_tpu_torch.ops import rms_norm as k1  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_forward_spread: CUDA is not available")
    print(chip_smoke.card_line())
    chip_smoke.build_all(_build, {"rms_norm": k1.SOURCES})
    x = np.random.RandomState(0).rand(1, 5, 1, 256, 256).astype(np.float32)
    x = torch.from_numpy(x).to("cuda")
    shipped = layers.ConvTranspose2d.forward

    def default_algorithms(self, v):
        return F.conv_transpose2d(v, self.weight, self.bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)

    variants = {
        "as shipped": {},
        "transposed conv on cuDNN's default algorithms":
            {(layers.ConvTranspose2d, "forward"): default_algorithms},
        "K1 plain": {(layers, "rms_norm"): k1.rms_norm_reference},
    }
    for label, kwargs in (("duality", {}), ("bimamba", {"linear_attn_duality": False})):
        model = predict.load_model(None, "cuda", **kwargs)
        for variant, patches in variants.items():
            saved = {key: getattr(*key) for key in patches}
            for (owner, name), value in patches.items():
                setattr(owner, name, value)
            try:
                spread, sources = chip_smoke.spread_sources(model, x)
            finally:
                for (owner, name), value in saved.items():
                    setattr(owner, name, value)
            print(f"{label}, {variant}: max_abs_diff {spread:.3e}; module calls computing "
                  f"differently from equal inputs: {sources[:2]}")
        del model
    assert layers.ConvTranspose2d.forward is shipped


if __name__ == "__main__":
    main()
