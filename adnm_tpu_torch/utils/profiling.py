"""Profiling hooks (counterpart of adnm_tpu/utils/profiling.py): a
``torch.profiler`` trace of a region and a step timer."""

from __future__ import annotations

import contextlib
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
