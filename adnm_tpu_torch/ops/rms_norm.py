"""RMS normalisation over one axis: kernel K1 and its plain version.

``rms_norm`` computes ``y = x * rsqrt(mean(x^2) + eps) * weight`` over
``axis`` with fp32 statistics and returns ``x``'s dtype, the function of
the Pallas kernel ``adnm_tpu/ops/pallas/fused_norm.py::rms_norm_pallas``
(there over the last axis only). A CPU tensor goes to
``rms_norm_reference``; a CUDA tensor goes to the hand-written Hopper
kernel in ``csrc/rms_norm.cu`` or the call raises. Forward only: a call
that would need a gradient through the kernel raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from adnm_tpu_torch.ops._build import load_library

SOURCES = ("rms_norm.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                       axis: int = -1) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same math, same dtypes)."""
    axis = axis % x.dim()
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    shape = [1] * x.dim()
    shape[axis] = -1
    return (xf * torch.rsqrt(ms + eps) * weight.float().view(shape)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("rms_norm", SOURCES)
    lib.adnm_rms_norm.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.adnm_rms_norm.restype = ctypes.c_int
    lib.adnm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.adnm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             axis: int = -1) -> torch.Tensor:
    """RMS norm of ``x`` over ``axis`` scaled by ``weight`` (shape (C,))."""
    if x.dim() == 0:
        raise ValueError("rms_norm needs at least one axis")
    axis = axis % x.dim()
    c = x.shape[axis]
    if weight.shape != (c,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({c},)")
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps, axis)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on CPU or CUDA tensors, got {x.device}")
    if weight.device != x.device:
        raise ValueError(f"weight on {weight.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rms_norm kernel takes float32 or bfloat16 x, got {x.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"rms_norm kernel takes a float32 weight, got {weight.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and weight")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise RuntimeError("the rms_norm CUDA kernel is forward only (no backward yet)")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    outer = math.prod(x.shape[:axis])
    inner = math.prod(x.shape[axis + 1:])
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.adnm_rms_norm(x.data_ptr(), weight.data_ptr(), y.data_ptr(),
                               outer, c, inner, float(eps), _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        msg = lib.adnm_cuda_error_string(rc).decode()
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc} ({msg})")
    rms_norm.launches += 1
    return y


rms_norm.launches = 0  # kernel launches since the last reset (set to 0 to reset)
