"""Profiling hooks (counterpart of adnm_tpu/utils/profiling.py): a
``torch.profiler`` trace of a region, a step timer, the FLOP counters
(``analytic_flops``: the matrix-unit count with depthwise convolutions
priced per group, JAX's fields; ``estimate_flops``: torch's own counter)
and the devices' memory statistics."""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Callable

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str = "adnm_trace"):
    """Trace the host and, where there is one, the CUDA device over the
    region; writes a Chrome trace (chrome://tracing, Perfetto) to
    ``{log_dir}/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def step_timer(name: str = "step", sync: bool = True, log_fn: Callable[[str], None] = print):
    """Host seconds of the region into ``box["seconds"]``; with ``sync``,
    the CUDA device's queued work is waited for before the clock stops."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        box["seconds"] = dt
        log_fn(f"[{name}] {dt * 1e3:.2f} ms")


def estimate_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` as ``torch.utils.flop_counter``
    counts them (its own total; counterpart of JAX's XLA cost analysis).
    Runs ``fn``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


_MATMULS = ("mm", "addmm", "bmm", "baddbmm")


def _matmul_flops(name: str, args) -> float:
    """2 x batch x m x n x k of an aten matrix product."""
    a, b = args[1:3] if name in ("addmm", "baddbmm") else args[:2]
    batch = a.shape[0] if a.dim() == 3 else 1
    return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]


def analytic_flops(fn: Callable, *args, **kwargs) -> dict:
    """The matrix-unit FLOPs of ``fn(*args, **kwargs)`` (2 x MACs of every
    matrix product and convolution, elementwise work ignored), with the
    fields and conventions of JAX's ``analytic_flops``
    (adnm_tpu/utils/profiling.py:68-150). Runs ``fn`` under a
    ``TorchDispatchMode`` and prices each aten op:

      * ``mm``, ``addmm``, ``bmm``, ``baddbmm``: 2 x batch x m x n x k
        (``dot_flops``, one ``n_dot`` site each); a 1x1 convolution whose
        weight is a view of a 2-D matrix (``core.layers.channel_linear``,
        a ``Linear`` over channels: JAX's ``Dense``) is priced the same;
      * ``convolution``: 2 x |out| x (C_in / groups) x kh x kw
        (``conv_flops``; ``conv_dense_flops`` the same times groups, as XLA
        prices it; ``n_conv`` and ``n_grouped_conv`` sites). A transposed
        convolution is priced as JAX's dilated-input convolution: |out| is
        the transposed conv's output, so it counts stride^2 times more
        than torch's ``flop_counter``, which prices its input;
      * ``convolution_backward``: each gradient it computes as a
        convolution of the forward's price (input and weight).

    A site is one op call, except inside a module whose class sets
    ``jax_scanned = True`` (the recurrent cells that JAX runs under
    ``nn.scan``): there the k-th op of every call is one site, as JAX
    counts a scan body once; its FLOPs count every call. Returns total,
    dot_flops, conv_flops, conv_dense_flops, n_dot, n_conv,
    n_grouped_conv and while_seen (always False: no op here hides a trip
    count)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    acc = {"total": 0.0, "dot_flops": 0.0, "conv_flops": 0.0, "conv_dense_flops": 0.0,
           "n_dot": 0, "n_conv": 0, "n_grouped_conv": 0, "while_seen": False}
    scans = []  # [module id, ops seen in its current call] of the scanned modules entered
    seen_sites = set()

    def site(kind: str) -> bool:
        """True where this op is a new site."""
        if not scans:
            return True
        key = (scans[-1][0], scans[-1][1], kind)
        scans[-1][1] += 1
        if key in seen_sites:
            return False
        seen_sites.add(key)
        return True

    def add_conv(out_numel: float, cin_per_group: int, k: float, groups: int):
        f = 2.0 * out_numel * cin_per_group * k
        acc["conv_flops"] += f
        acc["conv_dense_flops"] += f * groups
        if site("conv"):
            acc["n_conv"] += 1
            acc["n_grouped_conv"] += int(groups > 1)

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in _MATMULS:
                acc["dot_flops"] += _matmul_flops(name, args)
                acc["n_dot"] += int(site("dot"))
            elif name == "convolution":
                x, w = args[0], args[1]
                transposed, groups = args[6], args[8]
                k = math.prod(w.shape[2:])
                if not transposed and k == 1 and w._base is not None and w._base.dim() == 2:
                    acc["dot_flops"] += 2.0 * out.numel() * w.shape[1]
                    acc["n_dot"] += int(site("dot"))
                else:  # a transposed weight is (C_in, C_out / groups, kh, kw)
                    add_conv(out.numel(), x.shape[1] // groups, k, groups)
            elif name == "convolution_backward":
                grad_out, x, w = args[0], args[1], args[2]
                groups, mask = args[9], args[10]
                k = math.prod(w.shape[2:])
                for needed in mask[:2]:
                    if needed:
                        add_conv(grad_out.numel(), x.shape[1] // groups, k, groups)
            return out

    def enter(module, _):
        if getattr(module, "jax_scanned", False):
            scans.append([id(module), 0])

    def leave(module, _, __):
        if getattr(module, "jax_scanned", False):
            scans.pop()

    from torch.nn.modules.module import (register_module_forward_hook,
                                         register_module_forward_pre_hook)

    handles = [register_module_forward_pre_hook(enter), register_module_forward_hook(leave)]
    try:
        with Counter():
            fn(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    acc["total"] = acc["dot_flops"] + acc["conv_flops"]
    return acc


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` of every CUDA device, by name ("cuda:0",
    ...); empty without CUDA (counterpart of JAX's per-device
    ``memory_stats``)."""
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}


def optimizer_state_bytes(optimizer: torch.optim.Optimizer) -> int:
    """Bytes of the optimizer state tensors this process holds: under ZeRO-1
    (``ZeroRedundancyOptimizer``) its rank's share, else all of it."""
    inner = getattr(optimizer, "optim", optimizer)  # ZeRO-1's local optimizer
    return sum(v.numel() * v.element_size() for st in inner.state.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0)
