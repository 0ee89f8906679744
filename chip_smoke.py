#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adnm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Needs CUDA. Prints the card's name and power limit (nvidia-smi) and the
   torch/CUDA versions, and turns TF32 off for every fp32 comparison.
2. Builds every kernel of the serving paths from ``adnm_tpu_torch/csrc``,
   one nvcc per source, all started together, and prints each build time
   and ptxas report.
3. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call, with CUDA
   events around calls replayed from a CUDA graph (device time, without
   the host's launch cost); prints each beside its bound, the least time
   the card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s
   fp32). K1 (rms_norm) in fp32 and bf16; K2 (ssd_chunked_scan) in fp32
   at every Block shape of both bimamba configurations, at batch 1 and 4,
   plus cases with a small |dA|, in which the state carried between
   chunks dominates the output, and reversed scans.
4. Serves three paths at full width, 256x256, seeded weights, with the
   kernels' launch counts set to 0 just before each request and read just
   after:
   - the duality ``create_adnm_unet(5, 20, 6)`` through
     ``adnm_tpu_torch.cli.predict.main``: batch 1, batch 4, and batch 1
     chained to 40 frames; 20 K1 and no K2 launches per forward;
   - the bimamba ``create_adnm_unet(5, 20, 6, linear_attn_duality=False)``
     through ``predict.load_model`` and ``predict.forecast``: the same
     three requests; 20 K1 and 20 K2 launches per forward;
   - the VSSD bimamba configuration (``mixer_type="vssd"``): one batch-1
     request; 20 K1 and 20 K2 launches.
   Checks shapes and finiteness, and runs each batch-1 request on the CPU
   (the kernels' plain versions) against the card's output.
5. For the duality and the bimamba ADN-SSD models: times the batch-1
   forward latency and the batch-4 frames/s, reads the peak device
   memory, and traces 5 forwards at batch 1 and 4 with ``torch.profiler``
   (device busy time and share, kernels per forward, device time by
   kernel group and by kernel).
6. Prints the kernels' JSON line, the card line, then the result line last.

Any failure raises: the exit code is then non-zero and no result line is
printed.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

IMG = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
# Main path shapes of K1 (rms_norm): the refiner Blocks' (B, 32, 256, 256)
# at batch 1 and 4, the smallest and largest encoder/decoder Blocks, and
# the Pallas kernel's own (rows, d) contract on the last axis.
K1_CASES = [((1, 32, 256, 256), 1), ((4, 32, 256, 256), 1), ((1, 128, 32, 32), 1),
            ((1, 1024, 8, 8), 1), ((4096, 32), -1)]
# fp32: rsqrtf and the summation order differ from the plain version by a
# few ulp. bf16: both round the same fp32 value, so at most one bf16 step
# (2^-7 relative) apart where the fp32 values straddle a rounding boundary.
K1_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-5)}
# Main path shapes of K2 per path of a Block, (heads, L): encoder4 /
# decoder3 at 32^2, encoder5 / decoder2 at 16^2, encoder6 / decoder1 at
# 8^2, refiner1-4 at 256^2; P = 4, N = 16, chunks of 256 (64 at 8^2).
K2_SHAPES = [(32, 1024), (128, 1024), (64, 256), (256, 256), (128, 64), (256, 64), (8, 65536)]
K2_P, K2_N, K2_CHUNK = 4, 16, 256
# fp32 both; the kernel sums the causal pairs, the chunk states and the
# cumsums in other orders than the plain version and takes its own exps,
# on outputs of order 1-10.
K2_TOL = (1e-4, 1e-4)  # rtol, atol
# Whole 256^2 forward, card against CPU (and a chained request's first
# forward against the batch-1 request), both fp32 with TF32 off, outputs of
# order 1, per path. The sums run in other orders. Duality: the refiner's
# duality sums over L = 65,536 tokens before a LayerNorm removes their
# common part, which amplifies fp32 rounding about a hundredfold: two
# forwards on the card differ by ~3e-4 and card against CPU by ~7e-4 at
# seed 0 (H100, 700 W). Bimamba: the seeded decays (A in [-16, -1], dt
# from 1e-3) keep each scan's sums to a few tokens, nothing amplifies, and
# card against CPU measured 8.3e-7; the bound leaves two orders of margin.
FORWARD_ATOL = {"duality": 5e-3, "bimamba": 1e-4, "vssd-bimamba": 1e-4}
FORWARDS_PER_REQUEST = {"batch1": 1, "batch4": 1, "horizon40": 2}
K1_PER_FORWARD = 20  # 10 Blocks x (norm1, norm2)
K2_PER_FORWARD = 20  # 10 Blocks x (path 1, path 2), on the bimamba paths
BIMAMBA = {"linear_attn_duality": False}
VSSD_BIMAMBA = {"linear_attn_duality": False, "mixer_type": "vssd"}


def _elapsed_ms(run) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


@functools.cache
def timing_streams():
    """The warm-up and capture streams of ``device_ms``, made once: cuBLAS
    keeps a workspace for every stream it runs on, so new streams per call
    would pile up device memory that the peak-memory reading then counts."""
    return torch.cuda.Stream(), torch.cuda.Stream()


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's launch cost is left out."""
    side, capture = timing_streams()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=capture):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = min(_elapsed_ms(graph.replay) for _ in range(3)) / iters
    del graph
    return ms


def in_turns(kernel, plain, library=None, iters: int = 50, plain_iters: int = 50):
    """Device ms of kernel, plain (and library), timed plain, kernel, kernel,
    plain (library, library), each the mean of its two turns."""
    p1, k1, k2, p2 = (device_ms(f, n) for f, n in ((plain, plain_iters), (kernel, iters),
                                                   (kernel, iters), (plain, plain_iters)))
    lib = None if library is None else (device_ms(library, iters) + device_ms(library, iters)) / 2
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take, and what sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def build_all(_build, sources: dict) -> None:
    """One nvcc per kernel source, all started together."""
    def build(name):
        t0 = time.perf_counter()
        return name, _build.build_library(name, sources[name]), time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        for name, built, secs in pool.map(build, sources):
            print(f"build {name}: {secs:.2f} s ({built.path.name})")
            print(built.log.strip() or "(library already built)")


def check_k1(rms_norm, rms_norm_reference) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = K1_TOL[dtype]
        for shape, axis in K1_CASES:
            c = shape[axis]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.rand(c, generator=gen, device="cuda") + 0.5
            got = rms_norm(x, w, 1e-6, axis)
            torch.cuda.synchronize()
            want = rms_norm_reference(x, w, 1e-6, axis)
            err = (got.float() - want.float()).abs()
            max_err = err.max().item()
            w_lib = w.to(dtype)
            x_lib = x.movedim(axis, -1)  # F.rms_norm normalises the last axis

            ms, plain_ms, lib_ms = in_turns(
                lambda: rms_norm(x, w, 1e-6, axis),
                lambda: rms_norm_reference(x, w, 1e-6, axis),
                lambda: F.rms_norm(x_lib, (c,), w_lib, 1e-6))
            name = str(dtype).replace("torch.", "")
            bnd, by = bound_ms(2 * x.numel() * x.element_size() + 4 * c, 4 * x.numel())
            print(f"K1 {name} {shape} axis={axis}: max_abs_err={max_err:.3e} "
                  f"(tol {atol:g} + {rtol:g}*|ref|) device time: kernel {ms * 1e3:.2f} us, "
                  f"plain {plain_ms * 1e3:.2f} us, F.rms_norm {lib_ms * 1e3:.2f} us, "
                  f"bound {bnd * 1e3:.2f} us ({by}, {bnd / ms:.0%} of it)")
            if not bool((err <= atol + rtol * want.float().abs()).all()):
                raise AssertionError(f"K1 disagrees with its plain version at {name} {shape}")
            if dtype == torch.float32:
                worst = max(worst, max_err)
            timing[(name, shape)] = (ms, plain_ms, lib_ms, bnd, by)
    return {"max_abs_err": worst, "timing": timing}


def k2_flops(b: int, h: int, p: int, n: int, l: int) -> int:
    """The least operations of one scan: the state update per token and
    head, ``S = exp(dt A) S + B (x dt)``, ``y = C . S + D x``: dt*A and
    its exp (2), x*dt (P), the decay and the rank-1 update of the N x P
    state (3 N P), C . S (2 N P) and the D skip (2 P). The kernel's chunked
    form does more (every causal pair of a chunk); that is not counted."""
    return b * h * l * (5 * n * p + 3 * p + 2)


def k2_bytes(b: int, h: int, p: int, n: int, l: int) -> int:
    """x, dt, B, C, A, D read once and y written once, fp32."""
    return 4 * (2 * b * h * p * l + b * h * l + 2 * b * n * l + 2 * h)


def scan_inputs(b, h, l, gen, carry=False):
    """The model's scales (A = -exp(U(0, ln 16)), dt = softplus(N(0,1) - 4)
    ~ 0.02) or, with ``carry``, dt ~ 0.01 and A in [-0.05, -0.01], where the
    state carried from earlier chunks dominates y."""
    x = torch.randn(b, h, K2_P, l, generator=gen, device="cuda")
    u = torch.rand(b, h, l, generator=gen, device="cuda")
    if carry:
        dt = 0.005 + 0.01 * u
        A = -(0.01 + 0.04 * torch.rand(h, generator=gen, device="cuda"))
    else:
        dt = F.softplus(torch.randn(b, h, l, generator=gen, device="cuda") - 4)
        A = -torch.exp(torch.rand(h, generator=gen, device="cuda") * 2.77)
    B, C = (torch.randn(b, K2_N, l, generator=gen, device="cuda") for _ in range(2))
    D = 0.5 + torch.rand(h, generator=gen, device="cuda")
    return x, dt, A, B, C, D


def check_k2(ssd) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    rtol, atol = K2_TOL
    cases = [(b, h, l, False, False) for b in (1, 4) for h, l in K2_SHAPES]
    # small |dA| across many chunks, forward and reversed
    cases += [(1, 8, 65536, True, False), (1, 8, 65536, True, True), (4, 32, 1024, True, False),
              (1, 128, 1024, False, True)]
    worst, timing = 0.0, {}
    for b, h, l, carry, reverse in cases:
        x, dt, A, B, C, D = scan_inputs(b, h, l, gen, carry)
        q = min(K2_CHUNK, l)
        got = ssd.ssd_chunked_scan(x, dt, A, B, C, D, q, reverse=reverse)
        torch.cuda.synchronize()
        flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)

        def plain():
            return flip(ssd.ssd_chunked_scan_reference(flip(x), flip(dt), A, flip(B), flip(C),
                                                       D, q))

        want = plain()
        err = (got - want).abs()
        max_err = err.max().item()
        if not bool((err <= atol + rtol * want.abs()).all()):
            raise AssertionError(f"K2 disagrees with its plain version at b={b} h={h} l={l} "
                                 f"carry={carry} reverse={reverse}: max_abs_err {max_err:.3e}")
        worst = max(worst, max_err)
        label = f"K2 b={b} heads={h} L={l} chunks={l // q}" + (" small|dA|" if carry else "") + (
            " reverse" if reverse else "")
        if carry or reverse:
            print(f"{label}: max_abs_err={max_err:.3e} (tol {atol:g} + {rtol:g}*|ref|, "
                  f"max |ref| {want.abs().max().item():.3f})")
            continue
        ms, plain_ms, _ = in_turns(
            lambda: ssd.ssd_chunked_scan(x, dt, A, B, C, D, q),
            plain, iters=20, plain_iters=5)
        bnd, by = bound_ms(k2_bytes(b, h, K2_P, K2_N, l), k2_flops(b, h, K2_P, K2_N, l))
        print(f"{label}: max_abs_err={max_err:.3e} (tol {atol:g} + {rtol:g}*|ref|) device time: "
              f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound {bnd * 1e3:.2f} us "
              f"({by}, {bnd / ms:.0%} of it)")
        timing[(b, h, l)] = (ms, plain_ms, bnd, by)
    return {"max_abs_err": worst, "timing": timing}


class Counts:
    """The kernels' launch counters: ``reset`` just before a request,
    ``read`` just after."""

    def __init__(self, **wrappers):
        self.wrappers = wrappers

    def reset(self):
        for w in self.wrappers.values():
            w.launches = 0

    def read(self) -> dict:
        return {name: w.launches for name, w in self.wrappers.items()}


def check_requests(label, inputs, outs, per_request, per_forward) -> None:
    for name, n_fwd in FORWARDS_PER_REQUEST.items():
        if name not in outs:
            continue
        frames = 40 if name == "horizon40" else 20
        want = (inputs[name].shape[0], frames, 1, IMG, IMG)
        if outs[name].shape != want or not np.isfinite(outs[name]).all():
            raise AssertionError(f"{label} {name}: got {outs[name].shape}, want finite {want}")
        for kernel, k in per_forward.items():
            if per_request[name][kernel] != k * n_fwd:
                raise AssertionError(f"{label} {name}: {per_request[name][kernel]} {kernel} "
                                     f"launches, want {k * n_fwd}")
    if "horizon40" in outs:
        chain_err = np.abs(outs["horizon40"][:, :20] - outs["batch1"]).max()
        print(f"{label} horizon40 first 20 frames vs batch1: max_abs_err={chain_err:.3e} "
              f"(tol {FORWARD_ATOL[label]:g})")
        if not chain_err <= FORWARD_ATOL[label]:
            raise AssertionError(f"{label}: the chained request's first forward disagrees")


def compare_with_cpu(label, cpu_out, card_out) -> float:
    err = float(np.abs(cpu_out - card_out).max())
    print(f"{label} card vs CPU, full model at {IMG}^2 batch 1: max_abs_err={err:.3e} "
          f"(tol {FORWARD_ATOL[label]:g}), output max |y|={np.abs(cpu_out).max():.3f}")
    if not err <= FORWARD_ATOL[label]:
        raise AssertionError(f"{label}: the card's forward disagrees with the CPU's")
    return err


def serve_duality(predict, inputs, counts) -> dict:
    """The duality model's three requests through the predict CLI."""
    outs, per_request = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, x in inputs.items():
            paths[name] = os.path.join(tmp, f"{name}.npy")
            np.save(paths[name], x)

        def serve(name, *extra):
            return predict.main(["--input", paths[name], "--output",
                                 os.path.join(tmp, f"{name}_out.npy"),
                                 "--img-size", str(IMG), "--batch-size", "4", *extra])

        for name in FORWARDS_PER_REQUEST:
            t0 = time.perf_counter()
            counts.reset()
            outs[name] = serve(name, "--device", "cuda",
                               *(["--horizon", "40"] if name == "horizon40" else []))
            torch.cuda.synchronize()
            per_request[name] = counts.read()
            print(f"duality request {name}: {outs[name].shape} in "
                  f"{time.perf_counter() - t0:.2f} s, launches {per_request[name]}")
        check_requests("duality", inputs, outs, per_request,
                       {"rms_norm": K1_PER_FORWARD, "ssd_chunked_scan": 0})
        t0 = time.perf_counter()
        cpu = serve("batch1", "--device", "cpu")
        print(f"duality CPU run {time.perf_counter() - t0:.1f} s")
        compare_with_cpu("duality", cpu, outs["batch1"])
    return per_request


def serve_model(predict, label, kwargs, inputs, counts, requests) -> dict:
    """Requests through ``predict.load_model`` and ``predict.forecast``."""
    dev = torch.device("cuda")
    model = predict.load_model(None, dev, **kwargs)
    outs, per_request = {}, {}
    for name in requests:
        t0 = time.perf_counter()
        counts.reset()
        outs[name] = predict.forecast(model, inputs[name], 4, dev,
                                      40 if name == "horizon40" else None)
        torch.cuda.synchronize()
        per_request[name] = counts.read()
        print(f"{label} request {name}: {outs[name].shape} in {time.perf_counter() - t0:.2f} s, "
              f"launches {per_request[name]}")
    check_requests(label, inputs, outs, per_request,
                   {"rms_norm": K1_PER_FORWARD, "ssd_chunked_scan": K2_PER_FORWARD})
    t0 = time.perf_counter()
    cpu_dev = torch.device("cpu")
    cpu = predict.forecast(predict.load_model(None, cpu_dev, **kwargs), inputs["batch1"], 1,
                           cpu_dev)
    print(f"{label} CPU run {time.perf_counter() - t0:.1f} s")
    compare_with_cpu(label, cpu, outs["batch1"])
    return per_request


# Kernel groups of the forward's device time, matched on the kernel's name
# in this order; what matches none is elementwise or other.
KERNEL_GROUPS = {
    "K1 rms_norm": ("rms_norm",),
    "K2 ssd_chunked_scan": ("ssd_chunk", "ssd_carry"),
    "depthwise conv": ("depthwise",),
    "conv (cuDNN implicit gemm, transposes)": ("xmma_fprop", "implicit_convolve", "cudnn",
                                              "convolve", "fft", "winograd"),
    "bmm/gemm": ("gemm", "gemv", "Kernel2"),
    "reductions": ("reduce_kernel",),
    "softmax": ("softmax",),
    "cat/copy/index": ("Cat", "copy", "index", "gather"),
}


def profile_forward(model, x, card: str, label: str, n: int = 5) -> None:
    """Trace ``n`` forwards and print the device's busy time (the union of
    kernel intervals), its share of the first-to-last-kernel span, the
    kernels per forward, and device time by group and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                model(x)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no kernel on the card")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, start, end = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy, start = busy + end - start, s
        end = max(end, e)
    busy += end - start
    share = busy / (spans[-1][1] - spans[0][0])
    by_name = {}
    for e in kernels:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / n / 1e3, k + 1)
    groups = dict.fromkeys([*KERNEL_GROUPS, "elementwise and other"], 0.0)
    for name, (t, _) in by_name.items():
        group = next((g for g, pats in KERNEL_GROUPS.items() if any(p in name for p in pats)),
                     "elementwise and other")
        groups[group] += t
    print(f"[{card}] {label} profile batch {x.shape[0]}: device busy {busy / n / 1e3:.2f} "
          f"ms/forward, busy share {share:.3f}, {len(kernels) / n:.0f} kernels/forward "
          f"({n} forwards)")
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:40s} {t:8.3f} ms/forward")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t:8.3f} ms/forward {k / n:5.0f}x  {name[:100]}")


def time_forward(predict, label, kwargs, inputs, card) -> None:
    """Batch-1 latency, batch-4 frames/s and peak memory on the host's clock
    around synchronised forwards, then the profile at batch 1 and 4."""
    device = torch.device("cuda")
    model = predict.load_model(None, device, **kwargs)
    x1 = torch.from_numpy(inputs["batch1"]).to(device)
    x4 = torch.from_numpy(inputs["batch4"]).to(device)

    def host_times(x, n):
        times = []
        with torch.inference_mode():
            for _ in range(3):
                model(x)
            for _ in range(n):
                torch.cuda.synchronize()
                t = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
        return times

    lat = host_times(x1, 20)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # weights, inputs and whatever else is live
    step = host_times(x4, 10)
    peak = torch.cuda.max_memory_allocated()
    fps = 4 * 20 / (statistics.median(step) / 1e3)
    print(f"[{card}] {label} batch-1 forward latency: median {statistics.median(lat):.2f} ms, "
          f"min {min(lat):.2f} ms, mean {statistics.mean(lat):.2f} ms (20 runs)")
    print(f"[{card}] {label} batch-4 forward: median {statistics.median(step):.2f} ms -> "
          f"{fps:.1f} frames/s (4*20 frames per step)")
    print(f"[{card}] {label} peak device memory (batch-4 forward): {peak / 2**20:.1f} MiB, "
          f"of which {before / 2**20:.1f} MiB allocated before it")
    for x in (x1, x4):
        profile_forward(model, x, card, label)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from adnm_tpu_torch.cli import predict
    from adnm_tpu_torch.ops import _build, ssd
    from adnm_tpu_torch.ops import rms_norm as k1_module
    from adnm_tpu_torch.ops.rms_norm import rms_norm, rms_norm_reference

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- build ---------------------------------------------------------
    build_all(_build, {"rms_norm": k1_module.SOURCES, "ssd_scan": ssd.SOURCES})

    # -- kernels against their plain versions ---------------------------
    k1 = check_k1(rms_norm, rms_norm_reference)
    k2 = check_k2(ssd)

    # -- the main paths -------------------------------------------------
    counts = Counts(rms_norm=rms_norm, ssd_chunked_scan=ssd.ssd_chunked_scan)
    rng = np.random.RandomState(0)
    inputs = {"batch1": rng.rand(1, 5, 1, IMG, IMG).astype(np.float32),
              "batch4": rng.rand(4, 5, 1, IMG, IMG).astype(np.float32)}
    inputs["horizon40"] = inputs["batch1"]
    serve_duality(predict, inputs, counts)
    bimamba = serve_model(predict, "bimamba", BIMAMBA, inputs, counts, FORWARDS_PER_REQUEST)
    serve_model(predict, "vssd-bimamba", VSSD_BIMAMBA, inputs, counts, ["batch1"])

    # -- timing -----------------------------------------------------------
    time_forward(predict, "duality", {}, inputs, card)
    time_forward(predict, "bimamba", BIMAMBA, inputs, card)

    launches = {k: sum(r[k] for r in bimamba.values()) for k in counts.wrappers}
    k1_ms, k1_plain, k1_lib, k1_bound, k1_by = k1["timing"][("float32", K1_CASES[0][0])]
    k2_ms, k2_plain, k2_bound, k2_by = k2["timing"][(1, 8, 65536)]
    print(json.dumps({"kernels": [{
        "name": "rms_norm", "route": "cuda", "source": "adnm_tpu_torch/csrc/rms_norm.cu",
        "replaces": "adnm_tpu/ops/pallas/fused_norm.py:57", "launches": launches["rms_norm"],
        "max_abs_err": k1["max_abs_err"], "ms": k1_ms, "plain_ms": k1_plain,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
    }, {
        "name": "ssd_chunked_scan", "route": "cuda", "source": "adnm_tpu_torch/csrc/ssd_scan.cu",
        "replaces": "adnm_tpu/ops/pallas/ssd_scan.py:132",
        "launches": launches["ssd_chunked_scan"], "max_abs_err": k2["max_abs_err"],
        "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
