"""Numerics debugging (counterpart of adnm_tpu/utils/debug.py): NaN and Inf
surfacing on request."""

from __future__ import annotations

import torch

_HOOK = None


def _check_finite(module, args, output):
    for t in output if isinstance(output, (tuple, list)) else (output,):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and not bool(
                torch.isfinite(t).all()):
            raise FloatingPointError(
                f"{type(module).__name__} returned a NaN or Inf (nan debugging is on)")


def enable_nan_debugging(enable: bool = True):
    """Turn on (or off) NaN and Inf surfacing, as JAX's ``jax_debug_nans``
    and ``jax_debug_infs`` do: autograd's anomaly mode raises where a
    backward function returns a NaN, and a global forward hook raises
    ``FloatingPointError`` where a module's output holds a NaN or Inf.
    Each check reads the tensor back to the host: slow, for debugging."""
    global _HOOK
    torch.autograd.set_detect_anomaly(enable)
    if enable and _HOOK is None:
        _HOOK = torch.nn.modules.module.register_module_forward_hook(_check_finite)
    elif not enable and _HOOK is not None:
        _HOOK.remove()
        _HOOK = None
