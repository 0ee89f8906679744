"""Kernel K1 (RMS norm) of the PyTorch port on an NVIDIA card.

Every test here is marked ``cuda`` and skips where there is no card. The
file imports no JAX; ``tests/conftest.py`` does, so on a machine with the
card and without JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py
"""

from __future__ import annotations

import pytest
import torch

from adnm_tpu_torch.ops.rms_norm import rms_norm, rms_norm_reference

# The main path's shapes: refiner (B, 32, 256, 256), the Blocks at
# 32^2 ... 8^2, and the Pallas contract's (rows, d) on the last axis; then
# ragged ones (C not a multiple of 8, H*W not of 32, d not of 32).
CARD_CASES = [((1, 32, 256, 256), 1), ((4, 32, 256, 256), 1), ((1, 128, 32, 32), 1),
              ((1, 1024, 8, 8), 1), ((4096, 32), -1), ((3, 33, 7, 5), 1), ((5, 1000), -1)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_the_card(card, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    for shape, axis in CARD_CASES:
        c = shape[axis]
        x = torch.randn(shape, generator=gen, device=card).to(dtype)
        w = torch.rand(c, generator=gen, device=card) + 0.5
        before = rms_norm.launches
        got = rms_norm(x, w, 1e-6, axis)
        torch.cuda.synchronize()
        assert rms_norm.launches == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        want = rms_norm_reference(x, w, 1e-6, axis)
        # fp32: a few ulp; bf16: one bf16 rounding step of the output.
        rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (8e-3, 1e-5)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take(card):
    """No silent fallback to the plain version on a CUDA tensor."""
    x = torch.randn(2, 8, 4, 4, device=card)
    w = torch.ones(8, device=card)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rms_norm(x.half(), w, 1e-6, 1)
    with pytest.raises(TypeError, match="float32 weight"):
        rms_norm(x, w.double(), 1e-6, 1)
    with pytest.raises(ValueError, match="contiguous"):
        rms_norm(x.transpose(2, 3), w, 1e-6, 1)
    with pytest.raises(ValueError, match="weight on"):
        rms_norm(x, w.cpu(), 1e-6, 1)
    with pytest.raises(RuntimeError, match="forward only"):
        rms_norm(x.requires_grad_(), w, 1e-6, 1)
