#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adnm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Needs CUDA. Prints the card's name and power limit (nvidia-smi) and the
   torch/CUDA versions, and turns TF32 off for every fp32 comparison.
2. Builds every kernel of the serving path from ``adnm_tpu_torch/csrc``
   with nvcc and prints the build time and the ptxas report.
3. Holds each kernel against its plain PyTorch version on the card at the
   main path's shapes, in fp32 and bf16, and times both with CUDA events
   around calls replayed from a CUDA graph (device time, without the
   host's launch cost).
4. Serves three requests through ``adnm_tpu_torch.cli.predict.main`` on
   the full-width ``create_adnm_unet(5, 20, 6)`` at 256x256 with seeded
   weights: batch 1, batch 4, and batch 1 chained to 40 frames. Checks
   shapes, finiteness and that K1 launched 20 times per forward.
5. Runs the batch-1 request on the CPU (the kernels' plain versions) and
   compares it with the card's output.
6. Times the batch-1 forward latency and the batch-4 frames/s, and reads
   the peak device memory. Traces 5 forwards at batch 1 and 4 with
   ``torch.profiler`` and prints the device's busy time and share, the
   kernels per forward, and device time by kernel group and by kernel.
7. Prints the kernels' JSON line, then the result line last.

Any failure raises: the exit code is then non-zero and no result line is
printed.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

IMG = 256
# Main path shapes of K1 (rms_norm): the refiner Blocks' (B, 32, 256, 256)
# at batch 1 and 4, the smallest and largest encoder/decoder Blocks, and
# the Pallas kernel's own (rows, d) contract on the last axis.
K1_CASES = [((1, 32, 256, 256), 1), ((4, 32, 256, 256), 1), ((1, 128, 32, 32), 1),
            ((1, 1024, 8, 8), 1), ((4096, 32), -1)]
# fp32: rsqrtf and the summation order differ from the plain version by a
# few ulp. bf16: both round the same fp32 value, so at most one bf16 step
# (2^-7 relative) apart where the fp32 values straddle a rounding boundary.
K1_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-5)}
# Whole 256^2 forward, card against CPU, both fp32 with TF32 off, outputs
# of order 1. The sums run in other orders, and the refiner's duality sums
# over L = 65,536 tokens before a LayerNorm removes their common part, which
# amplifies fp32 rounding about a hundredfold: two forwards on the card
# differ by ~2e-4 and card against CPU by ~7e-4 at seed 0 (H100, 700 W).
FORWARD_ATOL = 5e-3
FORWARDS_PER_REQUEST = {"batch1": 1, "batch4": 1, "horizon40": 2}
K1_PER_FORWARD = 20  # 10 Blocks x (norm1, norm2)


def _elapsed_ms(run) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's launch cost is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    ms = min(_elapsed_ms(graph.replay) for _ in range(3)) / iters
    del graph
    return ms


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


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
            bound = atol + rtol * want.float().abs()
            max_err = err.max().item()

            def kernel():
                return rms_norm(x, w, 1e-6, axis)

            def plain():
                return rms_norm_reference(x, w, 1e-6, axis)

            # in turns: plain, kernel, kernel, plain
            p1, k1, k2, p2 = (device_ms(f) for f in (plain, kernel, kernel, plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            name = str(dtype).replace("torch.", "")
            gbs = 2 * x.numel() * x.element_size() / ms / 1e6
            print(f"K1 {name} {shape} axis={axis}: max_abs_err={max_err:.3e} "
                  f"(tol {atol:g} + {rtol:g}*|ref|) device time: kernel {ms * 1e3:.2f} us "
                  f"({gbs:.0f} GB/s), plain {plain_ms * 1e3:.2f} us")
            if not bool((err <= bound).all()):
                raise AssertionError(f"K1 disagrees with its plain version at {name} {shape}")
            if dtype == torch.float32:
                worst = max(worst, max_err)
            timing[(name, shape)] = (ms, plain_ms)
    return {"max_abs_err": worst, "timing": timing}


# Kernel groups of the forward's device time, matched on the kernel's name
# in this order; what matches none is elementwise or other.
KERNEL_GROUPS = {
    "K1 rms_norm": ("rms_norm",),
    "depthwise conv": ("depthwise",),
    "conv (cuDNN implicit gemm, transposes)": ("xmma_fprop", "implicit_convolve", "cudnn",
                                              "convolve", "fft", "winograd"),
    "bmm/gemm": ("gemm", "gemv", "Kernel2"),
    "reductions": ("reduce_kernel",),
    "softmax": ("softmax",),
    "cat/copy/index": ("Cat", "copy", "index", "gather"),
}


def profile_forward(model, x, card: str, n: int = 5) -> None:
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
    print(f"[{card}] profile batch {x.shape[0]}: device busy {busy / n / 1e3:.2f} ms/forward, "
          f"busy share {share:.3f}, {len(kernels) / n:.0f} kernels/forward ({n} forwards)")
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:40s} {t:8.3f} ms/forward")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t:8.3f} ms/forward {k / n:5.0f}x  {name[:100]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from adnm_tpu_torch.cli import predict
    from adnm_tpu_torch.ops import _build
    from adnm_tpu_torch.ops import rms_norm as k1_module
    from adnm_tpu_torch.ops.rms_norm import rms_norm, rms_norm_reference

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_library("rms_norm", k1_module.SOURCES)
    print(f"build rms_norm: {time.perf_counter() - t0:.2f} s ({built.path.name})")
    print(built.log.strip() or "(library already built)")

    # -- kernels against their plain versions ---------------------------
    k1 = check_k1(rms_norm, rms_norm_reference)

    # -- the main path: three requests through the predict CLI ----------
    rng = np.random.RandomState(0)
    inputs = {"batch1": rng.rand(1, 5, 1, IMG, IMG).astype(np.float32),
              "batch4": rng.rand(4, 5, 1, IMG, IMG).astype(np.float32)}
    inputs["horizon40"] = inputs["batch1"]
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, x in inputs.items():
            paths[name] = os.path.join(tmp, f"{name}.npy")
            np.save(paths[name], x)

        def serve(name, *extra):
            return predict.main(["--input", paths[name], "--output",
                                 os.path.join(tmp, f"{name}_out.npy"),
                                 "--img-size", str(IMG), "--batch-size", "4", *extra])

        rms_norm.launches = 0
        per_request = {}
        for name in FORWARDS_PER_REQUEST:
            before = rms_norm.launches
            t0 = time.perf_counter()
            outs[name] = serve(name, "--device", "cuda",
                               *(["--horizon", "40"] if name == "horizon40" else []))
            torch.cuda.synchronize()
            per_request[name] = rms_norm.launches - before
            print(f"request {name}: {outs[name].shape} in {time.perf_counter() - t0:.2f} s, "
                  f"K1 launches {per_request[name]}")
        launches = rms_norm.launches

        for name, frames in (("batch1", 20), ("batch4", 20), ("horizon40", 40)):
            want = (inputs[name].shape[0], frames, 1, IMG, IMG)
            if outs[name].shape != want or not np.isfinite(outs[name]).all():
                raise AssertionError(f"{name}: got {outs[name].shape}, want finite {want}")
            if per_request[name] != K1_PER_FORWARD * FORWARDS_PER_REQUEST[name]:
                raise AssertionError(f"{name}: {per_request[name]} K1 launches, want "
                                     f"{K1_PER_FORWARD * FORWARDS_PER_REQUEST[name]}")
        chain_err = np.abs(outs["horizon40"][:, :20] - outs["batch1"]).max()
        print(f"horizon40 first 20 frames vs batch1: max_abs_err={chain_err:.3e}")
        if chain_err > FORWARD_ATOL:
            raise AssertionError("the chained request's first forward disagrees with batch1")

        # -- the same request on the CPU, through the plain versions ----
        t0 = time.perf_counter()
        cpu = serve("batch1", "--device", "cpu")
        err = float(np.abs(cpu - outs["batch1"]).max())
        print(f"card vs CPU, full model at {IMG}^2 batch 1: max_abs_err={err:.3e} "
              f"(tol {FORWARD_ATOL:g}), output max |y|={np.abs(cpu).max():.3f}, "
              f"CPU run {time.perf_counter() - t0:.1f} s")
        if not err <= FORWARD_ATOL:
            raise AssertionError("the card's forward disagrees with the CPU's")

    # -- timing -----------------------------------------------------------
    device = torch.device("cuda")
    model = predict.load_model(None, device)
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
    step = host_times(x4, 10)
    peak = torch.cuda.max_memory_allocated()
    fps = 4 * 20 / (statistics.median(step) / 1e3)
    print(f"[{card}] batch-1 forward latency: median {statistics.median(lat):.2f} ms, "
          f"min {min(lat):.2f} ms, mean {statistics.mean(lat):.2f} ms (20 runs)")
    print(f"[{card}] batch-4 forward: median {statistics.median(step):.2f} ms -> "
          f"{fps:.1f} frames/s (4*20 frames per step)")
    print(f"[{card}] peak device memory (batch-4 forward): {peak / 2**20:.1f} MiB")
    for x in (x1, x4):
        profile_forward(model, x, card)

    ms, plain_ms = k1["timing"][("float32", K1_CASES[0][0])]
    print(json.dumps({"kernels": [{
        "name": "rms_norm", "route": "cuda", "source": "adnm_tpu_torch/csrc/rms_norm.cu",
        "replaces": "adnm_tpu/ops/pallas/fused_norm.py:57", "launches": launches,
        "max_abs_err": k1["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
