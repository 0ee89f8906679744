"""RMS normalisation over one axis: kernel K1, its backward, and kernel K3.

``rms_norm`` computes ``y = x * rsqrt(mean(x^2) + eps) * weight`` over
``axis`` with fp32 statistics and returns ``x``'s dtype, the function of
the Pallas kernel ``adnm_tpu/ops/pallas/fused_norm.py::rms_norm_pallas``
(there over the last axis only). It is differentiable: a
``torch.autograd.Function`` whose backward is ``rms_norm_backward``.

``gated_rms_norm`` computes ``RMSNorm(x * silu(z)) * weight``, the function
of ``gated_rms_norm_pallas`` (K3). It is differentiable over the last axis,
the JAX ``GatedRMSNorm``'s: a ``torch.autograd.Function`` whose backward is
``gated_rms_norm_backward`` (the Pallas kernel has no VJP; the JAX
module's gradient is XLA's).

A CPU tensor goes to the plain PyTorch versions (``rms_norm_reference``,
``rms_norm_backward_reference``, ``gated_rms_norm_reference``,
``gated_rms_norm_backward_reference``); a CUDA tensor goes to the
hand-written Hopper kernels in ``csrc/rms_norm.cu`` or the call raises.
Each wrapper counts its kernel launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from adnm_tpu_torch.ops._build import load_library

SOURCES = ("rms_norm.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# What the backward kernel holds: 8 warps x d fp32 sums in 48 KB of shared
# memory on the last axis; on an inner axis, 8 channels in the registers of
# each of 256 threads in each of a cluster's 8 blocks.
MAX_BACKWARD_ROW_D = 1536
MAX_BACKWARD_C = 16384


def _axis_shape(x: torch.Tensor, axis: int):
    shape = [1] * x.dim()
    shape[axis] = -1
    return shape


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                       axis: int = -1) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same math, same dtypes)."""
    axis = axis % x.dim()
    xf = x.float()
    ms = xf.square().mean(dim=axis, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * weight.float().view(_axis_shape(x, axis))).to(x.dtype)


def rms_norm_backward_reference(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                                eps: float = 1e-6,
                                axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: with
    ``r = rsqrt(mean(x^2) + eps)`` and ``gw = dy * w``,
    ``dx = r*gw - x*r^3*mean(gw*x)`` over ``axis`` (in x's dtype) and
    ``dw = sum(dy * x * r)`` over every other axis (fp32)."""
    axis = axis % x.dim()
    xf, gf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=axis, keepdim=True) + eps)
    gw = gf * weight.float().view(_axis_shape(x, axis))
    dx = r * gw - xf * r.pow(3) * (gw * xf).mean(dim=axis, keepdim=True)
    others = [d for d in range(x.dim()) if d != axis]
    dw = gf * xf * r
    return dx.to(x.dtype), (dw.sum(dim=others) if others else dw)


def gated_rms_norm_reference(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                             eps: float = 1e-6, axis: int = -1) -> torch.Tensor:
    """Plain PyTorch version of K3: ``g = x * silu(z)`` in fp32, then the
    RMS norm of ``g`` over ``axis`` scaled by ``weight``, in x's dtype."""
    axis = axis % x.dim()
    g = x.float() * F.silu(z.float())
    ms = g.square().mean(dim=axis, keepdim=True)
    return (g * torch.rsqrt(ms + eps) * weight.float().view(_axis_shape(x, axis))).to(x.dtype)


def gated_rms_norm_backward_reference(
        x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
        eps: float = 1e-6, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3's backward: with ``g = x * silu(z)``,
    ``dg`` and ``dw`` are ``rms_norm_backward_reference`` of g, then
    ``dx = dg * silu(z)`` and ``dz = dg * x * s * (1 + z * (1 - s))``,
    ``s = sigmoid(z)``; dx and dz in x's dtype, dw fp32."""
    xf, zf = x.float(), z.float()
    s = torch.sigmoid(zf)
    dg, dw = rms_norm_backward_reference(xf * F.silu(zf), weight, dy, eps, axis)
    dx = dg * F.silu(zf)
    dz = dg * xf * s * (1 + zf * (1 - s))
    return dx.to(x.dtype), dz.to(x.dtype), dw


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library("rms_norm", SOURCES)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.adnm_rms_norm.argtypes = [p, p, p, i64, i64, i64, ctypes.c_float, ctypes.c_int, p]
    lib.adnm_gated_rms_norm.argtypes = [p, p, p, p, i64, i64, i64, ctypes.c_float,
                                        ctypes.c_int, p]
    lib.adnm_rms_norm_backward.argtypes = [p, p, p, p, p, p, i64, i64, i64, ctypes.c_float,
                                           ctypes.c_int, i64, p]
    lib.adnm_gated_rms_norm_backward.argtypes = [p, p, p, p, p, p, p, p, i64, i64,
                                                 ctypes.c_float, ctypes.c_int, i64, p]
    lib.adnm_rms_norm_backward_rows.argtypes = [p, p, p, p, p, i64, i64, i64, ctypes.c_int]
    lib.adnm_rms_norm_backward_rows.restype = i64
    for fn in (lib.adnm_rms_norm, lib.adnm_gated_rms_norm, lib.adnm_rms_norm_backward,
               lib.adnm_gated_rms_norm_backward):
        fn.restype = ctypes.c_int
    lib.adnm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.adnm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, weight: torch.Tensor, axis: int, *like: torch.Tensor):
    """(axis, C) after checking the shapes; for a CUDA ``x``, also what the
    kernels take: device, dtypes and contiguity of x, weight and ``like``
    (tensors of x's shape and dtype). Raises on anything else."""
    if x.dim() == 0:
        raise ValueError(f"{name} needs at least one axis")
    axis = axis % x.dim()
    c = x.shape[axis]
    if weight.shape != (c,):
        raise ValueError(f"weight shape {tuple(weight.shape)} != ({c},)")
    for t in like:
        if t.shape != x.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != x's {tuple(x.shape)}")
    if x.device.type == "cpu":
        return axis, c
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    for t in (weight, *like):
        if t.device != x.device:
            raise ValueError(f"{name}: a tensor on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 x, got {x.dtype}")
    if weight.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes a float32 weight, got {weight.dtype}")
    for t in like:
        if t.dtype != x.dtype:
            raise TypeError(f"{name} kernel takes one dtype for x and {t.dtype} != {x.dtype}")
    if not all(t.is_contiguous() for t in (x, weight, *like)):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    return axis, c


def _raise_on(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.adnm_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def _outer_inner(x: torch.Tensor, axis: int):
    return math.prod(x.shape[:axis]), math.prod(x.shape[axis + 1:])


def _forward(x: torch.Tensor, weight: torch.Tensor, eps: float, axis: int) -> torch.Tensor:
    """K1 forward on a CUDA tensor, the plain version on a CPU tensor."""
    axis, c = _check("rms_norm", x, weight, axis)
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps, axis)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    outer, inner = _outer_inner(x, axis)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.adnm_rms_norm(x.data_ptr(), weight.data_ptr(), y.data_ptr(),
                               outer, c, inner, float(eps), _DTYPE_CODES[x.dtype], stream)
    _raise_on(lib, rc, "rms_norm")
    rms_norm.launches += 1
    return y


def _backward(name: str, x: torch.Tensor, z, weight: torch.Tensor, dy: torch.Tensor,
              eps: float, axis: int):
    """The backward kernel on CUDA tensors: K1's (dx, dw) for ``z`` None,
    K3's (dx, dz, dw) on the last axis otherwise. The caller has checked the
    tensors (``_check``)."""
    outer, inner = _outer_inner(x, axis)
    c = x.shape[axis]
    limit = MAX_BACKWARD_ROW_D if inner == 1 else MAX_BACKWARD_C
    if c > limit:
        raise ValueError(f"{name} kernel takes at most {limit} channels on this axis, got {c}")
    lib = _library()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dz = None if z is None else torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty((c,), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    dtype = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        # the kernel's split, and so its scratch, depends on the tensors' alignment
        rows = lib.adnm_rms_norm_backward_rows(x.data_ptr(), ptr(z), dy.data_ptr(), dx.data_ptr(),
                                               ptr(dz), outer, c, inner, dtype)
        partial = torch.empty((rows, c), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if z is None:
            rc = lib.adnm_rms_norm_backward(x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                                            dx.data_ptr(), partial.data_ptr(), dw.data_ptr(),
                                            outer, c, inner, float(eps), dtype, rows, stream)
        else:
            rc = lib.adnm_gated_rms_norm_backward(x.data_ptr(), z.data_ptr(), weight.data_ptr(),
                                                  dy.data_ptr(), dx.data_ptr(), dz.data_ptr(),
                                                  partial.data_ptr(), dw.data_ptr(), outer, c,
                                                  float(eps), dtype, rows, stream)
    _raise_on(lib, rc, name)
    return (dx, dw) if z is None else (dx, dz, dw)


def rms_norm_backward(x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-6, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rms_norm(x, weight, eps, axis)`` for the output
    gradient ``dy``: the K1 backward kernel on CUDA tensors (dx in x's
    dtype, dw fp32, bit-equal from run to run), the plain version on CPU
    tensors."""
    axis, _ = _check("rms_norm_backward", x, weight, axis, dy)
    if x.device.type == "cpu":
        return rms_norm_backward_reference(x, weight, dy, eps, axis)
    out = _backward("rms_norm_backward", x, None, weight, dy, eps, axis)
    rms_norm_backward.launches += 1
    return out


def gated_rms_norm_backward(
        x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor,
        eps: float = 1e-6, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dz, dw) of ``gated_rms_norm(x, z, weight, eps, axis)`` for the
    output gradient ``dy``, over the last axis only, as the JAX
    ``GatedRMSNorm`` normalises (another axis raises on every device): the
    K3 backward kernel on CUDA tensors (dx and dz in x's dtype, dw fp32,
    bit-equal from run to run), the plain version on CPU tensors."""
    axis, _ = _check("gated_rms_norm_backward", x, weight, axis, z, dy)
    if axis != x.dim() - 1:
        raise ValueError(f"gated_rms_norm_backward takes the last axis only (the JAX "
                         f"GatedRMSNorm's), got axis {axis} of a {x.dim()}-d tensor")
    if x.device.type == "cpu":
        return gated_rms_norm_backward_reference(x, z, weight, dy, eps, axis)
    out = _backward("gated_rms_norm_backward", x, z, weight, dy, eps, axis)
    gated_rms_norm_backward.launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    """K1 forward, and ``rms_norm_backward`` for the gradients. The
    backward recomputes the statistics from the saved x, which it reads
    anyway, so the forward saves nothing beyond its inputs."""

    @staticmethod
    def forward(ctx, x, weight, eps, axis):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.axis = eps, axis
        return _forward(x, weight, eps, axis)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_backward(x, weight, dy.contiguous(), ctx.eps, ctx.axis)
        return dx, dw, None, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
             axis: int = -1) -> torch.Tensor:
    """RMS norm of ``x`` over ``axis`` scaled by ``weight`` (shape (C,));
    differentiable in x and weight."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, eps, axis)
    return _forward(x, weight, eps, axis)


def _gated_forward(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, eps: float,
                   axis: int) -> torch.Tensor:
    """K3 forward on CUDA tensors, the plain version on CPU tensors."""
    axis, c = _check("gated_rms_norm", x, weight, axis, z)
    if x.device.type == "cpu":
        return gated_rms_norm_reference(x, z, weight, eps, axis)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    outer, inner = _outer_inner(x, axis)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.adnm_gated_rms_norm(x.data_ptr(), z.data_ptr(), weight.data_ptr(), y.data_ptr(),
                                     outer, c, inner, float(eps), _DTYPE_CODES[x.dtype], stream)
    _raise_on(lib, rc, "gated_rms_norm")
    gated_rms_norm.launches += 1
    return y


class _GatedRMSNorm(torch.autograd.Function):
    """K3 forward, and ``gated_rms_norm_backward`` for the gradients, which
    recomputes the statistics from the saved x and z (as ``_RMSNorm``)."""

    @staticmethod
    def forward(ctx, x, z, weight, eps, axis):
        ctx.save_for_backward(x, z, weight)
        ctx.eps, ctx.axis = eps, axis
        return _gated_forward(x, z, weight, eps, axis)

    @staticmethod
    def backward(ctx, dy):
        x, z, weight = ctx.saved_tensors
        dx, dz, dw = gated_rms_norm_backward(x, z, weight, dy.contiguous(), ctx.eps, ctx.axis)
        return dx, dz, dw, None, None


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
                   axis: int = -1) -> torch.Tensor:
    """K3: RMS norm of ``x * silu(z)`` over ``axis`` scaled by ``weight``,
    in x's dtype; differentiable in x, z and weight over the last axis."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, z, weight)):
        return _GatedRMSNorm.apply(x, z, weight, eps, axis)
    return _gated_forward(x, z, weight, eps, axis)


# Kernel launches since the last reset (set to 0 to reset); one backward
# launch is the dx (and dz) kernel and the dw reduction after it.
rms_norm.launches = 0
rms_norm_backward.launches = 0
gated_rms_norm.launches = 0
gated_rms_norm_backward.launches = 0
