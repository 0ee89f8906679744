#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``adnm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

1. Needs CUDA. Prints the card's name and power limit (nvidia-smi) and the
   torch/CUDA versions. Turns TF32 off through ``resolve_device``, as the
   entry points do, for the kernels' checks; before the first CLI call it
   allows TF32 again, as cuDNN starts, and after each predict CLI call it
   asserts that the entry point turned it off (fp32 comparisons).
2. Builds every kernel from ``adnm_tpu_torch/csrc``, one nvcc per source,
   all started together (``rms_norm.cu``: K1 and K3, forward and backward;
   ``ssd_scan.cu``: K2, forward and backward), and prints each build time
   and ptxas report.
3. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes and times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call, with CUDA
   events around calls replayed from a CUDA graph (device time, without
   the host's launch cost); prints each beside its bound, the least time
   the card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s
   fp32), and the kernel's time over the library call's. K1 (rms_norm)
   forward and backward (dx and dw, two launches bit-equal in dw) at every
   Block norm's shape and at MLA's (rows, rank) norms, and K3
   (gated_rms_norm) forward and backward (dx,
   dz and dw, bit-equal in dw) at its rows beside the unfused
   ``F.rms_norm(x * F.silu(z))`` and its autograd backward, in fp32 and
   bf16; K2 (ssd_chunked_scan) at every Block shape of both bimamba
   configurations, at batch 1 and 4, each with its kernel / bound and the
   time PERF.md records for the quadratic kernel it replaced, plus cases with
   a small |dA|, in which the state carried between chunks dominates the
   output, and reversed scans; K2's backward (dx, ddt, dA, dB, dC, dD,
   bit-equal across two launches) at the same shapes and cases and on
   channel slices, each timed with its kernel / bound and beside the time
   PERF.md records for its first, simple form. Both K2 kernels also on the
   same inputs rounded to bf16 (bf16 in and out, fp32 inside), within one
   bf16 step of their plain versions, the backward bit-equal across two
   launches, each timed beside its fp32 time with its bf16 bound. The LAPS
   model's new shapes too: K1 and its backward at the 16-channel refiner
   Blocks, (1 and 4, 16, 256, 256), and K2 and its backward at its bimamba
   refiner's 4 heads a path over 65,536 tokens, at batch 1 and 4 and with a
   small |dA|.
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
   (the kernels' plain versions) against the card's output. No backward
   kernel runs while serving.
5. Trains the duality model through ``adnm_tpu_torch.cli.train.main``:
   one epoch of 4 steps at batch 4, 256x256 (24 synthetic clips), then
   validation, an epoch snapshot, the test loss; with the launch counts
   set to 0 just before each step and read just after: 28 K1 forward (20
   and the refiner's 8 recomputed under remat), 20 K1 backward, no K2 or
   K3. The train CLI ends with the evaluator's CSI/HSS table of its final
   protocol.
5b. Evaluates, visualises and serves the train CLI's epoch snapshot, each
   CLI run with the launch counts set to 0 just before it and read just
   after (20 K1 launches, one forward, and no other kernel, each):
   ``cli.validate.main --ckpt`` on the card (the 3-clip synthetic test
   split; CSI/POD/HSS finite, or NaN only where their denominators are 0),
   then the same predictions and ground truths through the evaluator on
   the card and on the CPU (equal contingency counts, MAE and MSE within
   1e-6 relative, SSIM within 1e-5); ``cli.predict.main --ckpt --png`` on
   the test clips in one batch against validate's predictions (1e-5) and
   its strips; two forwards of the first clip bit-equal (else the modules
   that compute differently from equal inputs are named);
   ``cli.visualize.main --max-samples 2`` (PNG headers read with
   the standard library); the evaluator's device time on a 4 x 20 x 256^2
   batch (CUDA graph replay) beside its bound, and the validate wall.
6. Training the duality and the bimamba models through the ``Trainer``
   (the bimamba configurations have no CLI flag, in JAX either): the
   median, min and mean step time at batch 1 and 4, frames/s, the peak
   memory of a step with and without the refiner's remat, each with its
   launches counted from 0 and asserted (bimamba: 28 K2 with remat, 20
   without, and 20 K2 backward), a trace of 2 steps of bimamba at batch 1,
   and one VSSD bimamba measurement at batch 1. The fp32 forwards of both
   models are phase 6i (d)'s, eager beside graphed.
6b. bf16 compute (the JAX package's ``--bf16``): the duality model's three
   requests through ``cli.predict.main --bf16`` and the bimamba model's
   through ``forecast(compute_dtype=bfloat16)``, launches as in fp32 (20
   K1; 20 K2 for bimamba), the chained request's first forward bit-equal
   to the batch-1 request, and the batch-1 and batch-4 predictions against
   the fp32 ones from the same weights within ``BF16_FORWARD_REL``; the
   train CLI's 4-step epoch with ``--bf16`` (28 K1, 20 K1 backward a
   step); the batch-1 latency, batch-4 frames/s and a profile at batch 4
   of the duality forward; the bimamba forward's times; duality steps at
   batch 1 and 4 with remat and at 4 without (peak memory) and bimamba
   steps at batch 1 and 4 (28 K2, 20 K2 backward).
6c. One batch-1 training step of the duality and of the bimamba model from
   the same seeded weights and batch: two card runs bit-equal in fp32 and
   in bf16 compute; the fp32 loss, global gradient norm and every gradient
   tensor on the card against the CPU within the fixed ``STEP_TOL`` (the
   bimamba step runs K2's backward on the card and its plain version on
   the CPU); the bf16 loss and gradient norm against the fp32 ones on the
   card within ``BF16_STEP_REL``.
6d. The four baselines (SmaAt-UNet, ConvLSTM, TrajGRU, LPTQPN) at their
   published widths, 256x256, seeded weights, fp32, with every hand
   kernel's launch count asserted 0: (a) the batch-1 forward on the card
   against the CPU (``BASELINE_FORWARD_ATOL``; max abs and relative L2
   printed) and (b) two forwards bit-equal; (c) a batch-1 training step on
   the card against the CPU (``baseline_step_tol``: ``STEP_TOL``, or ten
   times the CPU's fp32 distance from fp64 where larger; SmaAt's running
   statistics within 1e-4) and (d) two card steps bit-equal; (f) the
   batch-1 latency, batch-4 frames/s and peak memory of the forward, the
   step time at batch 1 and 4 (median of 10 after 3) and the peak memory
   of a batch-4 step, the batch-1 forward's kernels and a profile of the
   batch-4 forward; (e) each through the train CLI (4 steps at
   batch 4, an epoch snapshot), ``predict --ckpt`` on the snapshot (two
   forwards of a clip bit-equal), and for SmaAt ``validate --ckpt`` (its
   counts equal the train CLI's final protocol on the same weights, and
   the evaluator's on the card and on the CPU; predict reproduces its
   predictions). Prints the phase's seconds.
6e. The last slice's models, at full width, 256x256, seeded weights:
   (a) the MLA ADNM-UNet (``attn_type="mla"``): its batch-1 and batch-4
   requests (26 K1 launches a forward), the batch-1 forward card against
   CPU (the duality bound) and twice bit-equal, the requests in bf16
   against fp32 (``BF16_FORWARD_REL``), a batch-1 step twice bit-equal in
   fp32 and bf16 and card against CPU (``STEP_TOL``), the train CLI with
   ``--attn-type mla`` (34 K1 and 26 K1 backward launches a step) and
   ``predict --ckpt --attn-type mla`` on its snapshot, the latency,
   frames/s, peak memory, step times and profiles; (b)
   ``compute_dead_features=True`` against False from one weight set:
   bit-equal predictions; (c) TransUnet and SwinUnet through the
   baselines' checks (a)-(f) (the card-against-CPU step with the dropout
   and DropPath rates at 0, two card steps at the published rates
   bit-equal, validate for TransUnet) and a reference .pth round trip
   through ``scripts/torch_convert_reference_ckpt.py``. Prints the phase's
   seconds.
6f. The LAPS task, at full width, 256x256, seeded weights: the duality
   ``create_adnm_unet(5, 3, 60)`` (no InstanceNorm, kernels (5, 3, 3),
   refiner widths 32, 32, 16, 16) and its bimamba configuration, each a
   batch-1 forward through ``predict.load_model(dataset="LAPS")`` with its
   launches counted from 0 (20 K1; and 20 K2), twice bit-equal and against
   the CPU (``LAPS_FORWARD_ATOL``); bimamba training steps at batch 1 and 4
   (28 K1, 20 K1 backward, 28 K2, 20 K2 backward); ``cli.train --dataset
   LAPS`` (4 steps at batch 4, launches a step, ``laps_evaluate``'s table),
   then ``validate``, ``visualize`` and ``predict --ckpt`` on its snapshot,
   and ConvLSTM (3 output frames) through the train CLI; the native
   decode-resize of a 25 x 565 x 784 uint8 clip against the
   ``F.interpolate`` path (``NATIVE_ATOL``) with the host ms per clip of
   both. Prints the phase's seconds.
6g. The six baselines at their published widths, 256x256, seeded weights,
   in bf16 compute (the JAX package's ``--bf16``): the batch-1 bf16
   forward against fp32 and a batch-1 step's loss and gradient norm
   against fp32 (``BASELINE_BF16_REL``), two bf16 forwards and two bf16
   steps bit-equal, no hand kernel launched; the train CLI with ``--bf16``
   for SmaAt-UNet and TransUnet
   and ``predict --bf16 --ckpt`` on each snapshot. Prints the phase's
   seconds.
6h. Data parallelism, full width, 256x256, fp32, the kernels built once
   before any rank starts (``parallel_phase``): (1) one rank over NCCL
   (``spawn``): one step of the DDP ``Trainer`` on a batch of 2 gives the
   plain ``Trainer``'s bits (loss, gradient norm, every parameter and
   buffer after AdamW), twice, with the second step's launches (28 K1, 20
   K1 backward), two DDP gradient calls bit-equal, and each one's step
   time and peak memory, and the bytes all-reduced a step; (2) two ranks on the one card over gloo (CUDA tensors), one row
   each, against one process on the same global batch: the duality and
   bimamba ADNM-UNet (K1, K2 and their backwards launched on each rank,
   counted from 0 per rank), SmaAt-UNet (cross-rank BatchNorm: running
   statistics within 1e-4) and SwinUnet at its Dropout and DropPath rates
   (the global batch's masks): the ranks bit-equal, the loss, gradient
   norm and every gradient within each model's card-against-CPU step
   bound, the AdamW parameters within 2 lr; (3) ZeRO-1 on the duality
   model: after two steps bit-equal to (2), each rank's optimizer state
   against the replicated one's, and its consolidated checkpoint resumed
   in one process, whose next step lands within 2 lr of the ranks'; with
   two or more cards, (2) again over NCCL, one card a rank; (4)
   ``cli.train --data-parallel`` (one rank per visible card, NCCL) for its
   4-step epoch and ``cli.validate`` on its snapshot (the same test loss).
6i. Single dispatch (``Trainer(scan_steps=K)``, ``--scan-steps K``, the
   eval and serving forwards as CUDA graph replays), 256x256, seeded
   weights (``single_dispatch_phase``; (b) and the CLIs of (c) run on
   phase 5's epoch): (a) two groups of K steps (the first run eagerly and
   captured, the second one replay) against 2K eager steps from the same
   weights, every loss, gradient norm, parameter, BatchNorm buffer and
   AdamW or SGD state entry bit for bit, the replay's launches as K eager
   steps' (counters; for the ADNM-UNet also the hand kernels' names in a
   ``torch.profiler`` trace of one replay, those of K eager steps, and the
   launches they make, ``trace_launches``): the duality model in fp32 at
   batch 4 with the refiner's remat and K = 4 (4 x (28 K1 + 20 K1
   backward)), bimamba at batch 1 and K = 2 (2 x (28 K1 + 20 K1 backward +
   28 K2 + 20 K2 backward)), duality in bf16 at batch 4, SmaAt-UNet,
   SwinUnet at its published Dropout and DropPath rates under ``--remat``
   and TrajGRU at batch 4, K = 2; an epoch of 5 batches at K = 2 (two
   replays and one eager tail) against five eager steps, and a change of
   LR and clip threshold between two replays; (b) ``cli.train
   --scan-steps 4`` and ``--scan-steps 2``: the epoch record and the epoch
   snapshot bit-equal to the eager CLI's; (c) ``forecast`` with the
   caller's ``GraphSet`` (capture, then replay) and with a set of the
   call's own against without graphs, bit for bit with the same launches,
   at batch 1 and 4 for duality, bimamba, MLA, LAPS duality, SmaAt-UNet,
   TrajGRU and SwinUnet, and for duality and bimamba a trace of a batch-4
   replay with the hand kernels of an eager forward, 20 K1 (and 20 K2)
   launches (the ``graphed`` forward launches of the JSON line come from
   it); ``predict --ckpt --horizon 40`` against
   the eager chain, and ``validate`` at batch 1 against the eager
   ``eval_epoch``; (d) beside each other from one run, eager and graphed:
   the batch-1 latency and batch-4 frames/s of the duality, bimamba,
   TransUnet and SwinUnet forwards, the step median of duality at batch 1
   and 4 and of TrajGRU and SwinUnet at batch 4, the forwards' and the
   graphed steps' busy share and kernels (``profile_device``), peak
   memory, and the capture's seconds and pool. Prints the phase's seconds.
   To keep the smoke within its limit with this phase, earlier phases time
   with fewer repeats, and every correctness check stays: phase 6 no longer
   times the fp32 forwards or traces the duality steps (6i (d) does both,
   eager beside graphed) and takes a step median over 3 steps after 1 (was
   10 after 3), each configuration's launches still asserted; the bf16
   forwards (6b), MLA (6e) and the baselines (6d, 6e) take the batch-1
   latency over 10 forwards (was 20) and the batch-4 forward over 5 (was
   10), the baselines a step median over 5 steps after 2 (was 10 after 3);
   the traces follow the timed calls without 3 more warm-up calls, over 2
   forwards or steps (was 3 or 5), and the baselines' separate batch-1
   kernel breakdown is gone (each trace lists device time by kernel); 6g
   no longer times the six baselines in fp32 against bf16 (bf16 buys them no
   speed, ``PERF.md`` §5) and keeps its bf16-against-fp32 forward and
   step checks, its bit-equality and launch checks and its CLIs.
6j. Multi-rank inference (``mesh_inference_phase``), full width, 256x256,
   seeded weights, fp32, two gloo ranks sharing the card
   (``parallel.spawn``), the kernels built once before: (a) ``validate``
   on data=2 (a test split of 9 clips in batches of 4, 4 and 1: rank 0
   has no rows of the tail) against one process: the predictions
   (``MESH_DATA_ATOL``, below the gap a row out of place would show), the
   ground truths equal, the test loss (1e-4 relative), the printed table
   (identical where the predictions are bit-equal); (b) ``forecast`` on model=2 (the heads and hidden channels
   split over the ranks) of the duality and bimamba models at batch 4
   against one process (``MESH_ATOL``), the two ranks bit-equal, each
   rank's launches counted and traced (20 K1, and 20 K2 on bimamba, on
   every rank), the bytes its collectives sent, its wall against one
   process's eager forward, its peak memory against one process's; (c)
   ``predict`` on data=2 against one process (``MESH_DATA_ATOL``). Each
   part's wall and peak memory per rank. With two or more cards, (b) again
   over NCCL, a card a rank. Prints the phase's seconds. To keep the
   smoke within its limit with this phase, 6h's DDP step timing takes 4 steps after 1 (was 6
   after 2) and 6i (d)'s step and forward timings take no warm-up calls
   beyond the capture's (was 1 and 3), and the traces of eager training
   steps (the profiler's slowest: tens of thousands of host and device
   events) are gone from 6h (1), 6i (d) (the graphed group's trace stays),
   the baselines' batch-4 steps (6d, 6e), and the bf16 duality and MLA
   batch-4 steps (6b, 6e); every check and every timing stays.
6k. The mesh's 'seq' axis (``mesh_seq_phase``), full width, 256x256,
   seeded weights, fp32, two gloo ranks sharing the card, each holding its
   band of 128 rows: (1) K2's carried form (``check_k2_carried``): from a
   random incoming state against its plain version (outputs, end state
   and decay) at (4, 8, 32,768), a rank's shape at batch 4, at the model's
   decays and at |dA| ~ 3e-4, fp32 and bf16, forward and reversed; the
   sequence in 2 and 4 segments chained from rank-order states equals the
   whole scan, forward and reversed, fp32 and bf16, at the model's decays
   and at |dA| ~ 3e-4 over many chunks; without a state one launch,
   bit-equal across calls and to the carried form from a zero state at
   the refiner's many tiles; timed with and without a state at
   (1, 8, 32,768) beside its bound, against the plain version; (2) ``forecast`` of the duality and
   bimamba models at batch 4 on seq=2 against phase 6j's one process
   (``SEQ_ATOL``), the ranks bit-equal, each rank's launches counted and
   traced (20 K1, and 20 K2 carried on bimamba), the bytes it sent over
   'seq', its wall and peak memory against one process's; (3)
   ``validate`` on data=1,seq=2 against phase 6j's one process
   (``SEQ_VALIDATE_ATOL``): the same table, the test loss within 1e-4
   relative, the ground truths equal. Its ranks run in phase 6j's spawn.
6l. Training on the mesh (``mesh_train_phase``), full width, 256x256,
   fp32, two gloo ranks sharing the card, their work in phase 6j's spawn
   too (a rank's start paid once for 6j, 6k and 6l): (1) K2's carried
   backward (``check_k2_carried_backward``): from a random entering state
   S0 and adjoint lambda against its plain version (dx, ddt, dA, dB, dC,
   dD, dS0 and the first phase's adjoint) at (4, 8, 32,768) and
   (1, 8, 32,768), a rank's shapes on seq=2, at the model's decays and at
   |dA| ~ 3e-4, fp32 and bf16, forward and reversed; chained over 2 and 4
   segments against the whole scan's backward kernel; from S0 = lambda =
   0 bit-equal to K2's backward kernel; timed with and without the
   boundary terms beside its bound, the plain version and the backward
   kernel on the segment; (2) two training steps (``MESH_TRAIN_STEPS``) of
   the duality and bimamba models at batch 2 on seq=2 and on model=2
   (``Trainer(ddp=True, mesh=...)``) against one process on the same
   batch: each step's loss, gradient norm and every gradient within
   STEP_TOL of one process's from the same parameters (the first step's
   from the same init, the second's from the rank's parameters after the
   first: AdamW moves a parameter whose gradient is near 0 by about lr
   along its sign, which rounding may flip), the parameters within 2 lr a
   step of one process's two steps, the ranks bit-equal,
   and, in a third step, each rank's launches counted (and traced in a
   fourth on the bimamba model, whose step runs all four hand kernels)
   (``mesh_step_launches``: on seq=2 the refiner's 8 scans through K2's
   carried backward), its bytes over the axis, forward and backward, its
   step wall and peak memory against one process's; (3) ``cli.train
   --mesh data=1,seq=2``, a 2-step epoch on both ranks.
7. Prints the kernels' JSON line (each K1 entry with its largest kernel /
   library time over the fp32 main-path shapes, ``worst_vs_library``, and
   its MLA launches and times at MLA's rows; K2's
   with its largest kernel / bound time over its timed shapes,
   ``worst_vs_bound``, and its walkers' sub-chunk T at each L; K2
   backward's likewise; both K2 entries with ``bf16_ms``,
   ``bf16_bound_ms`` and ``bf16_max_abs_err`` at the refiner; each K1 and
   K2 entry with a ``laps`` entry: its launches on the LAPS paths and its
   times at the LAPS shapes; each K1, K1 backward, K2 and K2 backward entry
   with a ``graphed`` entry: its launches per graphed forward and step;
   each K1 and K2 entry with a ``mesh_model2`` entry: its launches per
   rank and forward on model=2, phase 6j (b), and a ``mesh_seq2`` entry:
   its launches per rank and forward on seq=2, phase 6k, K2's with its
   carried form's ``carried`` times and error; each K1, K1 backward and K2
   entry with a ``mesh_train`` entry and the K2 backward entry with
   ``mesh_seq2_train`` and ``mesh_model2_train``: their launches a rank and
   step in phase 6l, and its carried backward's ``carried`` times and
   error),
   the script's total seconds, the card line, then the result line last.

Any failure raises: the exit code is then non-zero and no result line is
printed.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch
import torch.nn.functional as F

IMG = 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
# Main path shapes of K1 (rms_norm), over axis 1: the norm1 and norm2 of
# every Block of create_adnm_unet(5, 20, 6) at batch 1 (refiner1-4,
# encoder4, encoder5, encoder6, decoder1, decoder2, decoder3), and the
# refiner's at batch 4; then the Pallas kernel's own (rows, d) contract on
# the last axis, which no model runs.
K1_MAIN = [(1, 32, 256, 256), (4, 32, 256, 256), (1, 128, 32, 32), (1, 256, 16, 16),
           (1, 512, 8, 8), (1, 1024, 8, 8), (1, 1024, 16, 16), (1, 512, 32, 32)]
# MLA's two RMSNorms over the last axis (q_down_norm, kv_down_norm) at the
# three attention sites of create_adnm_unet(5, 20, 6, attn_type="mla"), at
# batch 1 and 4: rows (B*1024, 64) and (B*1024, 32) at encoder.attn and
# decoder.attn (32^2 tokens, dim 128), (B*64, 256) and (B*64, 128) at attn2
# (8^2 tokens, dim 1024).
K1_MLA_ROWS = [(b * l, c) for b in (1, 4) for l, c in ((1024, 64), (1024, 32), (64, 256),
                                                        (64, 128))]
# The LAPS ADNM-UNet's refiner (create_adnm_unet(5, 3, 60): refiner widths
# 32, 32, 16, 16) adds the 16-channel Blocks of refiner3-4, at batch 1 and
# 4; its other Block norms are the Shanghai model's shapes above.
K1_LAPS = [(1, 16, 256, 256), (4, 16, 256, 256)]
K1_CASES = [(shape, 1) for shape in K1_MAIN + K1_LAPS] + [
    (shape, -1) for shape in dict.fromkeys([(4096, 32), *K1_MLA_ROWS])]
# fp32: rsqrtf and the summation order differ from the plain version by a
# few ulp. bf16: both round the same fp32 value, so at most one bf16 step
# (2^-7 relative) apart where the fp32 values straddle a rounding boundary.
K1_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-5)}
# K1 backward: dx as K1's output (the same argument, on r*g*w - x*coef);
# dw sums up to 262,144 products per channel (batch 4 at 256^2) in another
# order than torch.sum: relative 1e-4 of the sum of the terms' magnitudes.
K1B_DW_RTOL = 1e-4
# Main path shapes of K3 (gated_rms_norm): the (B*L, d) rows of the JAX
# package's kernel benchmark at the refiner (scripts/bench_kernels.py
# :149-173), d in {32, 64}, and a small one.
K3_CASES = [((65536, 32), -1), ((262144, 32), -1), ((262144, 64), -1), ((4096, 32), -1)]
# Main path shapes of K2 per path of a Block, (heads, L): encoder4 /
# decoder3 at 32^2, encoder5 / decoder2 at 16^2, encoder6 / decoder1 at
# 8^2, refiner1-4 at 256^2; P = 4, N = 16, chunks of 256 (64 at 8^2).
K2_SHAPES = [(32, 1024), (128, 1024), (64, 256), (256, 256), (128, 64), (256, 64), (8, 65536)]
# The LAPS bimamba configuration's refiner3-4 (16 channels, 8 heads, 4 a
# path); its other Blocks run the shapes above.
K2_LAPS = (4, 65536)
K2_P, K2_N, K2_CHUNK = 4, 16, 256
# The quadratic chunked K2 that this kernel replaced, device us per call at
# (batch, heads, L), fp32, as PERF.md section 6 records them (NVIDIA H100
# 80GB HBM3, 700.00 W).
K2_QUADRATIC_US = {(1, 32, 1024): 27.93, (1, 128, 1024): 48.31, (1, 64, 256): 18.93,
                   (1, 256, 256): 24.02, (1, 128, 64): 8.49, (1, 256, 64): 8.31,
                   (1, 8, 65536): 137.71, (4, 32, 1024): 48.72, (4, 128, 1024): 140.29,
                   (4, 64, 256): 24.41, (4, 256, 256): 65.00, (4, 128, 64): 8.49,
                   (4, 256, 64): 10.86, (4, 8, 65536): 504.77}
# K2's backward in its first, simple form (a launch per phase over 32-token
# sub-chunks, per-token shuffle sums), device us per call at (batch, heads,
# L), fp32, as PERF.md section 6 records them (NVIDIA H100 80GB HBM3,
# 700.00 W): each shape's time is printed beside the kernel's.
K2_BWD_FIRST_US = {(1, 32, 1024): 31.42, (1, 128, 1024): 64.72, (1, 64, 256): 31.36,
                   (1, 256, 256): 47.13, (1, 128, 64): 34.72, (1, 256, 64): 41.70,
                   (1, 8, 65536): 256.80, (4, 32, 1024): 59.55, (4, 128, 1024): 231.03,
                   (4, 64, 256): 39.15, (4, 256, 256): 126.05, (4, 128, 64): 39.00,
                   (4, 256, 64): 52.57, (4, 8, 65536): 938.01}
# fp32 both; the kernel walks the state token by token, the plain version
# sums causal pairs within chunks and carries chunk states: sums in other
# orders and exps of their own, on outputs of order 1-20.
K2_TOL = (1e-4, 1e-4)  # rtol, atol
# K2 backward, the same argument: dx, ddt, dB and dC within rtol 1e-4 and
# an atol of 1e-4 of the largest entry (sums of up to 256 heads for dB and
# dC); dA and dD, sums over batch and L, within 1e-4 of the sum of their
# terms' magnitudes, as K1's dw.
K2B_TOL = (1e-4, 1e-4)  # rtol, atol relative to max |ref|
K2B_SUM_RTOL = 1e-4
# bf16 inputs and outputs, fp32 inside: the kernel and its plain version
# round fp32 values that differ within the fp32 tolerances above, so the two
# are at most one bf16 step (2^-7 relative: one rounding of the output)
# apart, beside those tolerances.
BF16_STEP = 2.0 ** -7
K2B_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
# Whole 256^2 forward, card against CPU, both fp32 with TF32 off, outputs
# of order 1, per path. The sums run in other orders. Duality: the
# refiner's duality sums over L = 65,536 tokens before a LayerNorm removes
# their common part, which amplifies fp32 rounding about a hundredfold:
# card against CPU differ by ~7e-4 at seed 0 (H100, 700 W). Bimamba: the seeded decays (A in [-16, -1], dt
# from 1e-3) keep each scan's sums to a few tokens, nothing amplifies, and
# card against CPU measured 8.3e-7; the bound leaves two orders of margin.
FORWARD_ATOL = {"duality": 5e-3, "bimamba": 1e-4, "vssd-bimamba": 1e-4, "mla": 5e-3}
FORWARDS_PER_REQUEST = {"batch1": 1, "batch4": 1, "horizon40": 2}
K1_PER_FORWARD = 20  # 10 Blocks x (norm1, norm2)
# MLA: and the q_down_norm and kv_down_norm of each of the 3 attention sites
K1_MLA_PER_FORWARD = 26
K2_PER_FORWARD = 20  # 10 Blocks x (path 1, path 2), on the bimamba paths
# Per training step: the forward's 20 K1 launches (26 with MLA) and the 8
# of the four refiner Blocks, whose forward the backward recomputes
# (refiner remat); one K1 backward launch per norm.
REFINER_K1 = 8
# Per bimamba training step: K2's 20 forward launches and the 8 of the
# refiner Blocks' recompute; one K2 backward launch per scan.
K2_PER_STEP, K2B_PER_STEP = 28, 20
SYNTHETIC_LEN = 24
DATA_ARGS = ["--synthetic", "--synthetic-len", str(SYNTHETIC_LEN), "--batch-size", "4"]
TRAIN_ARGS = [*DATA_ARGS, "--epochs", "1", "--save-every", "1"]
TRAIN_STEPS = 4  # int(24 * 0.7) = 16 training clips in batches of 4
LR, CLIP = 1e-3, 0.025  # the preset's first-epoch clip threshold
NO_LAUNCHES = dict.fromkeys(["rms_norm", "rms_norm_backward", "ssd_chunked_scan",
                             "ssd_chunked_scan_backward", "ssd_segment_backward",
                             "gated_rms_norm", "gated_rms_norm_backward"], 0)
BIMAMBA = {"linear_attn_duality": False}
MLA = {"attn_type": "mla"}
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
                  f"bound {bnd * 1e3:.2f} us ({by}, {bnd / ms:.0%} of it), kernel/library "
                  f"{ms / lib_ms:.2f}")
            if not bool((err <= atol + rtol * want.float().abs()).all()):
                raise AssertionError(f"K1 disagrees with its plain version at {name} {shape}")
            if dtype == torch.float32:
                worst = max(worst, max_err)
            timing[(name, shape)] = (ms, plain_ms, lib_ms, bnd, by)
    return {"max_abs_err": worst, "timing": timing}


def worst_vs_library(timing: dict) -> dict:
    """The largest kernel / library time over the fp32 main-path shapes."""
    ratios = [(None if t[2] is None else t[0] / t[2], shape) for shape in K1_MAIN
              for t in [timing[("float32", shape)]]]
    if any(r is None for r, _ in ratios):
        return {"ratio": None, "shape": None}
    ratio, shape = max(ratios)
    return {"ratio": ratio, "shape": list(shape)}


def mla_rows(timing: dict, shapes=K1_MLA_ROWS) -> dict:
    """K1's fp32 (kernel, plain, library, bound) device ms at MLA's rows (or
    at ``shapes``)."""
    return {str(list(shape)): {k: t for k, t in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                                                    timing[("float32", shape)])}
            for shape in shapes}


def k2_rows(timing: dict, shapes) -> dict:
    """K2's (or its backward's) (kernel, plain, bound) device ms at the
    (batch, heads, L) ``shapes``."""
    return {str(list(shape)): dict(zip(("ms", "plain_ms", "bound_ms"), timing[shape][:3]))
            for shape in shapes}


def worst_vs_bound(timing: dict) -> dict:
    """The largest kernel / bound time over the timed shapes."""
    ratio, shape = max((t[0] / t[2], key) for key, t in timing.items())
    return {"ratio": ratio, "shape": list(shape)}


def fused_rms_norm_backward(x, w, dy, axis):
    """PyTorch's one-call RMSNorm backward on the channel-last view, as a
    timed yardstick, or None (with the reason printed) where the
    installed torch has none for this card."""
    op = getattr(torch.ops.aten, "_fused_rms_norm_backward", None)
    if op is None:
        print("library yardstick: torch has no aten._fused_rms_norm_backward")
        return None
    c = x.shape[axis]
    x_lib, dy_lib, w_lib = x.movedim(axis, -1), dy.movedim(axis, -1), w.to(x.dtype)
    try:
        rstd = torch.ops.aten._fused_rms_norm(x_lib, [c], w_lib, 1e-6)[1]
        op(dy_lib, x_lib, [c], rstd, w_lib, [True, True])
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"library yardstick: aten._fused_rms_norm_backward refused: {str(e)[:200]}")
        return None
    return lambda: op(dy_lib, x_lib, [c], rstd, w_lib, [True, True])


def check_k1_backward(k1_module) -> dict:
    bwd, ref = k1_module.rms_norm_backward, k1_module.rms_norm_backward_reference
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, timing = 0.0, {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = K1_TOL[dtype]
        name = str(dtype).replace("torch.", "")
        for shape, axis in K1_CASES:
            c = shape[axis]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.rand(c, generator=gen, device="cuda") + 0.5
            dx, dw = bwd(x, w, dy, 1e-6, axis)
            dw_again = bwd(x, w, dy, 1e-6, axis)[1]
            torch.cuda.synchronize()
            if not torch.equal(dw, dw_again):
                raise AssertionError(f"K1 backward: two launches differ in dw at {name} {shape}")
            dx_want, dw_want = ref(x, w, dy, 1e-6, axis)
            dx_err = (dx.float() - dx_want.float()).abs()
            dims = [d for d in range(x.dim()) if d != axis % x.dim()]
            r = torch.rsqrt(x.float().square().mean(dim=axis, keepdim=True) + 1e-6)
            terms = (dy.float() * x.float() * r).abs().sum(dim=dims)
            dw_err = (dw - dw_want).abs()
            if not bool((dx_err <= atol + rtol * dx_want.float().abs()).all()):
                raise AssertionError(f"K1 backward dx disagrees with its plain version at "
                                     f"{name} {shape}: {dx_err.max().item():.3e}")
            if not bool((dw_err <= K1B_DW_RTOL * terms + 1e-6).all()):
                raise AssertionError(f"K1 backward dw disagrees with its plain version at "
                                     f"{name} {shape}: {dw_err.max().item():.3e}")
            max_err = max(dx_err.max().item(), dw_err.max().item())
            ms, plain_ms, lib_ms = in_turns(
                lambda: bwd(x, w, dy, 1e-6, axis), lambda: ref(x, w, dy, 1e-6, axis),
                fused_rms_norm_backward(x, w, dy, axis))
            n = x.numel()
            # x, dy read and dx written once, w and dw; per element about 12
            # fp32 operations (two sums of products, dx, the dw term)
            bnd, by = bound_ms(3 * n * x.element_size() + 8 * c, 12 * n)
            lib = "none" if lib_ms is None else (f"{lib_ms * 1e3:.2f} us (kernel/library "
                                                 f"{ms / lib_ms:.2f})")
            print(f"K1 backward {name} {shape} axis={axis}: max_abs_err dx "
                  f"{dx_err.max().item():.3e} (tol {atol:g} + {rtol:g}*|ref|), dw "
                  f"{dw_err.max().item():.3e} (tol {K1B_DW_RTOL:g}*sum|terms|, max |dw| "
                  f"{dw_want.abs().max().item():.3e}), dw bit-equal across launches; device "
                  f"time: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
                  f"aten._fused_rms_norm_backward {lib}, bound {bnd * 1e3:.2f} us ({by}, "
                  f"{bnd / ms:.0%} of it)")
            if dtype == torch.float32:
                worst = max(worst, max_err)
            timing[(name, shape)] = (ms, plain_ms, lib_ms, bnd, by)
    return {"max_abs_err": worst, "timing": timing}


def unfused_gated(x, z, w, dy):
    """The unfused composition ``F.rms_norm(x * F.silu(z), (d,), w, eps)``
    (several PyTorch calls; no one call computes K3): a forward, and a
    forward with its autograd backward, each to be captured in a CUDA graph."""
    d, w_lib = x.shape[-1], w.to(x.dtype)

    def forward():
        return F.rms_norm(x * F.silu(z), (d,), w_lib, 1e-6)

    def forward_backward():
        xg, zg, wg = (t.detach().requires_grad_() for t in (x, z, w_lib))
        y = F.rms_norm(xg * F.silu(zg), (d,), wg, 1e-6)
        return torch.autograd.grad(y, (xg, zg, wg), dy)

    return forward, forward_backward


def check_k3(k1_module) -> dict:
    """K3 forward and backward against their plain versions at K3_CASES,
    timed in turns, beside their bounds and the unfused composition."""
    k3, ref = k1_module.gated_rms_norm, k1_module.gated_rms_norm_reference
    bwd, bwd_ref = k1_module.gated_rms_norm_backward, k1_module.gated_rms_norm_backward_reference
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, worst_bwd, timing, timing_bwd = 0.0, 0.0, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        rtol, atol = K1_TOL[dtype]  # K1's argument, with the kernel's own exp
        name = str(dtype).replace("torch.", "")
        for shape, axis in K3_CASES:
            c = shape[axis]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            z = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
            w = torch.rand(c, generator=gen, device="cuda") + 0.5
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = k3(x, z, w, 1e-6, axis)
            torch.cuda.synchronize()
            want = ref(x, z, w, 1e-6, axis)
            err = (got.float() - want.float()).abs()
            max_err = err.max().item()
            if not bool((err <= atol + rtol * want.float().abs()).all()):
                raise AssertionError(f"K3 disagrees with its plain version at {name} {shape}")
            dx, dz, dw = bwd(x, z, w, dy, 1e-6, axis)
            dw_again = bwd(x, z, w, dy, 1e-6, axis)[2]
            torch.cuda.synchronize()
            if not torch.equal(dw, dw_again):
                raise AssertionError(f"K3 backward: two launches differ in dw at {name} {shape}")
            dx_want, dz_want, dw_want = bwd_ref(x, z, w, dy, 1e-6, axis)
            dxz_err = 0.0
            for a, b, what in ((dx, dx_want, "dx"), (dz, dz_want, "dz")):
                e = (a.float() - b.float()).abs()
                dxz_err = max(dxz_err, e.max().item())
                if not bool((e <= atol + rtol * b.float().abs()).all()):
                    raise AssertionError(f"K3 backward {what} disagrees with its plain version "
                                         f"at {name} {shape}: {e.max().item():.3e}")
            g = x.float() * F.silu(z.float())
            r = torch.rsqrt(g.square().mean(dim=axis, keepdim=True) + 1e-6)
            terms = (dy.float() * g * r).abs().sum(dim=0)
            dw_err = (dw - dw_want).abs()
            if not bool((dw_err <= K1B_DW_RTOL * terms + 1e-6).all()):
                raise AssertionError(f"K3 backward dw disagrees with its plain version at "
                                     f"{name} {shape}: {dw_err.max().item():.3e}")
            ms, plain_ms, _ = in_turns(lambda: k3(x, z, w, 1e-6, axis),
                                       lambda: ref(x, z, w, 1e-6, axis))
            b_ms, b_plain_ms, _ = in_turns(lambda: bwd(x, z, w, dy, 1e-6, axis),
                                           lambda: bwd_ref(x, z, w, dy, 1e-6, axis))
            fwd_u, fwd_bwd_u = unfused_gated(x, z, w, dy)
            u_fwd_ms = device_ms(fwd_u)
            u_bwd_ms = device_ms(fwd_bwd_u) - u_fwd_ms
            n, elt = x.numel(), x.element_size()
            # x, z read and y written once, and w; per element about 10 fp32
            # operations (the gate's exp, reciprocal and products, the sum, the scale)
            bnd, by = bound_ms(3 * n * elt + 4 * c, 10 * n)
            # x, z, dy read and dx, dz written once, w read and dw written;
            # per element about 20 (the gate and its derivative, two sums,
            # dg, dx, dz and the dw term)
            b_bnd, b_by = bound_ms(5 * n * elt + 8 * c, 20 * n)
            print(f"K3 {name} {shape} axis={axis}: max_abs_err={max_err:.3e} (tol {atol:g} + "
                  f"{rtol:g}*|ref|) device time: kernel {ms * 1e3:.2f} us, plain "
                  f"{plain_ms * 1e3:.2f} us, library none, bound {bnd * 1e3:.2f} us ({by}, "
                  f"{bnd / ms:.0%} of it); unfused F.rms_norm(x * F.silu(z)) "
                  f"{u_fwd_ms * 1e3:.2f} us (several calls)")
            print(f"K3 backward {name} {shape} axis={axis}: max_abs_err dx, dz {dxz_err:.3e} "
                  f"(tol {atol:g} + {rtol:g}*|ref|), dw {dw_err.max().item():.3e} (tol "
                  f"{K1B_DW_RTOL:g}*sum|terms|, max |dw| {dw_want.abs().max().item():.3e}), dw "
                  f"bit-equal across launches; device time: kernel {b_ms * 1e3:.2f} us, plain "
                  f"{b_plain_ms * 1e3:.2f} us, library none, bound {b_bnd * 1e3:.2f} us ({b_by}, "
                  f"{b_bnd / b_ms:.0%} of it); unfused autograd backward {u_bwd_ms * 1e3:.2f} us "
                  f"(several calls: its forward and backward less its forward)")
            if dtype == torch.float32:
                worst = max(worst, max_err)
                worst_bwd = max(worst_bwd, dxz_err, dw_err.max().item())
            timing[(name, shape)] = (ms, plain_ms, bnd, by)
            timing_bwd[(name, shape)] = (b_ms, b_plain_ms, b_bnd, b_by)
    return {"max_abs_err": worst, "timing": timing, "backward_max_abs_err": worst_bwd,
            "backward_timing": timing_bwd}


def recorded_us(table: dict, key) -> str:
    """A time PERF.md records for an earlier form, or "none recorded" for a
    shape it was never timed at (the LAPS shapes)."""
    return f"{table[key]:.2f} us" if key in table else "none recorded"


def k2_flops(b: int, h: int, p: int, n: int, l: int) -> int:
    """The least operations of one scan: the state update per token and
    head, ``S = exp(dt A) S + B (x dt)``, ``y = C . S + D x``: dt*A and
    its exp (2), x*dt (P), the decay and the rank-1 update of the N x P
    state (3 N P), C . S (2 N P) and the D skip (2 P). The kernel's chunked
    form does more (every causal pair of a chunk); that is not counted."""
    return b * h * l * (5 * n * p + 3 * p + 2)


def k2_bytes(b: int, h: int, p: int, n: int, l: int, size: int = 4) -> int:
    """x, dt, B, C, A, D read once and y written once, ``size`` bytes a value
    (4 fp32, 2 bf16)."""
    return size * (2 * b * h * p * l + b * h * l + 2 * b * n * l + 2 * h)


def k2_bwd_flops(b: int, h: int, p: int, n: int, l: int) -> int:
    """The least operations of the scan's backward per token and head: the
    forward's state recomputed (with S_t . dy_t for dC in place of y) and
    the adjoint walk, G = C dy^T + a G (3 N P), and its contractions u = G^T B,
    <G, S_{t-1}> and G (x dt) for dB (2 N P each); dx, x . u, the dD term
    (7 P) and ddt, dA (5)."""
    return b * h * l * (14 * n * p + 10 * p + 7)


def k2_bwd_bytes(b: int, h: int, p: int, n: int, l: int, size: int = 4) -> int:
    """x, dt, B, C, dy, A, D read once; dx, ddt, dB, dC, dA, dD written once,
    ``size`` bytes a value."""
    return size * (b * l * (3 * h * p + 2 * h + 4 * n) + 4 * h)


def k2_grad_terms(x, dt, A, B, C, D, dy, grads) -> dict:
    """Per head, the sums of the magnitudes of the terms that dA and dD add
    up: |dt_t a_t <G_t, S_{t-1}>| = |dt_t ddt_t - x_t . (dx_t - D dy_t)| / |A|
    (from the plain backward's dx and ddt), and |x_t dy_t|; fp64."""
    dx, ddt = grads[0].double(), grads[1].double()
    x, dt, A, D, dy = x.double(), dt.double(), A.double(), D.double(), dy.double()
    g = dt * ddt - (x * (dx - D[None, :, None, None] * dy)).sum(2)
    return {"dA": g.abs().sum((0, 2)) / A.abs(), "dD": (x * dy).abs().sum((0, 2, 3))}


def channel_slices(x, dt, B, C):
    """Copies of x, dt, B and C that are channel slices of one wider
    (batch, channels, L) tensor, each sample contiguous, as the mixers hand
    them to K2."""
    b, h, p, l = x.shape
    n = B.shape[1]
    big = torch.zeros(b, h * p + h + 2 * n + 3, l, dtype=x.dtype, device=x.device)
    parts, c0 = [], 1
    for t in (x.reshape(b, h * p, l), dt, B, C):
        big[:, c0:c0 + t.shape[1]] = t
        parts.append(big[:, c0:c0 + t.shape[1]])
        c0 += t.shape[1]
    return parts[0].view(b, h, p, l), parts[1], parts[2], parts[3]


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
    """K2 against its plain version at every K2_SHAPES shape at batch 1 and
    4, small-|dA| and reversed cases, in fp32 and on the same inputs
    rounded to bf16; the fp32 kernel and plain version timed in turns, the
    bf16 kernel beside them, each with its bound."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rtol, atol = K2_TOL
    cases = [(b, h, l, False, False) for b in (1, 4) for h, l in (*K2_SHAPES, K2_LAPS)]
    # small |dA| across many chunks, forward and reversed
    cases += [(1, 8, 65536, True, False), (1, 8, 65536, True, True), (4, 32, 1024, True, False),
              (1, 128, 1024, False, True), (1, *K2_LAPS, True, False)]
    worst, worst16, timing, timing16 = 0.0, 0.0, {}, {}
    for b, h, l, carry, reverse in cases:
        args32 = scan_inputs(b, h, l, gen, carry)
        q = min(K2_CHUNK, l)
        flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
        label = f"K2 b={b} heads={h} L={l} chunks={l // q}" + (" small|dA|" if carry else "") + (
            " reverse" if reverse else "")
        errs = {}
        for dtype, args in ((torch.float32, args32),
                            (torch.bfloat16, [t.bfloat16() for t in args32])):
            x, dt, A, B, C, D = args
            got = ssd.ssd_chunked_scan(x, dt, A, B, C, D, q, reverse=reverse)
            torch.cuda.synchronize()
            want = flip(ssd.ssd_chunked_scan_reference(flip(x), flip(dt), A, flip(B), flip(C),
                                                       D, q))
            step = BF16_STEP if dtype == torch.bfloat16 else 0.0
            err = (got.float() - want.float()).abs()
            errs[dtype] = err.max().item()
            if got.dtype != dtype or not bool(
                    (err <= atol + (rtol + step) * want.float().abs()).all()):
                raise AssertionError(f"{label} {dtype}: K2 disagrees with its plain version, "
                                     f"max_abs_err {errs[dtype]:.3e}")
        worst, worst16 = max(worst, errs[torch.float32]), max(worst16, errs[torch.bfloat16])
        text = (f"{label}: max_abs_err fp32 {errs[torch.float32]:.3e} (tol {atol:g} + "
                f"{rtol:g}*|ref|), bf16 {errs[torch.bfloat16]:.3e} (tol {atol:g} + "
                f"({rtol:g} + 2^-7)*|ref|), max |ref| {want.float().abs().max().item():.3f}")
        if carry or reverse:
            print(text)
            continue
        x, dt, A, B, C, D = args32
        ms, plain_ms, _ = in_turns(
            lambda: ssd.ssd_chunked_scan(x, dt, A, B, C, D, q),
            lambda: ssd.ssd_chunked_scan_reference(x, dt, A, B, C, D, q), iters=20, plain_iters=5)
        ms16 = device_ms(lambda: ssd.ssd_chunked_scan(*args, q), iters=20)
        bnd, by = bound_ms(k2_bytes(b, h, K2_P, K2_N, l), k2_flops(b, h, K2_P, K2_N, l))
        bnd16, by16 = bound_ms(k2_bytes(b, h, K2_P, K2_N, l, 2), k2_flops(b, h, K2_P, K2_N, l))
        print(f"{text}; device time: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
              f"bound {bnd * 1e3:.2f} us ({by}, {bnd / ms:.0%} of it; kernel / bound "
              f"{ms / bnd:.1f}), quadratic kernel {recorded_us(K2_QUADRATIC_US, (b, h, l))}; bf16 "
              f"kernel {ms16 * 1e3:.2f} us, bound {bnd16 * 1e3:.2f} us ({by16}; kernel / bound "
              f"{ms16 / bnd16:.1f}; bf16 / fp32 {ms16 / ms:.2f})")
        timing[(b, h, l)] = (ms, plain_ms, bnd, by)
        timing16[(b, h, l)] = (ms16, None, bnd16, by16)
        if (h, l) == (8, 65536) and b == 1:
            kernel_breakdown(lambda: ssd.ssd_chunked_scan(*args, q), f"{label} bf16")
    return {"max_abs_err": worst, "timing": timing, "bf16_max_abs_err": worst16,
            "bf16_timing": timing16}


def check_k2_backward(ssd) -> dict:
    """K2's backward against its plain version at every K2_SHAPES shape at
    batch 1 and 4, the small-|dA| and reversed cases of check_k2, and a
    case read from channel slices; two launches bit-equal in every
    gradient; kernel and plain timed in turns beside the bound."""
    bwd, ref = ssd.ssd_chunked_scan_backward, ssd.ssd_chunked_scan_backward_reference
    gen = torch.Generator(device="cuda").manual_seed(6)
    rtol, atol = K2B_TOL
    cases = [(b, h, l, False, False, False) for b in (1, 4) for h, l in (*K2_SHAPES, K2_LAPS)]
    cases += [(1, 8, 65536, True, False, False), (1, 8, 65536, True, True, False),
              (4, 32, 1024, True, False, False), (1, 128, 1024, False, True, False),
              (2, 64, 1024, False, True, True), (1, *K2_LAPS, True, False, False)]
    worst, timing = {torch.float32: 0.0, torch.bfloat16: 0.0}, {}
    timing16 = {}
    for b, h, l, carry, reverse, sliced in cases:
        inputs32 = [*scan_inputs(b, h, l, gen, carry),
                    torch.randn(b, h, K2_P, l, generator=gen, device="cuda")]
        q = min(K2_CHUNK, l)
        label = (f"K2 backward b={b} heads={h} L={l} chunks={l // q}"
                 + (" small|dA|" if carry else "") + (" reverse" if reverse else "")
                 + (" channel slices" if sliced else ""))
        texts = []
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, B, C, D, dy = (t.to(dtype) for t in inputs32)
            if sliced:
                x, dt, B, C = channel_slices(x, dt, B, C)
            args = (x, dt, A, B, C, D, dy, q, reverse)
            got, again = bwd(*args), bwd(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{label} {dtype}: two launches differ")
            want = ref(*args)
            terms = k2_grad_terms(x, dt, A, B, C, D, dy, want)
            step = BF16_STEP if dtype == torch.bfloat16 else 0.0
            errs = []
            for name, g, w in zip(K2B_NAMES, got, want):
                g, w = g.float(), w.float()
                e = (g - w).abs()
                if name in terms:
                    tol = f"{K2B_SUM_RTOL:g}*sum|terms| + {step:g}*|ref|"
                    ok = bool((e <= K2B_SUM_RTOL * terms[name] + step * w.abs() + 1e-6).all())
                else:
                    tol = f"{rtol + step:g}*|ref| + {atol:g}*max|ref|"
                    ok = bool((e <= (rtol + step) * w.abs() + atol * w.abs().max()).all())
                if not ok:
                    raise AssertionError(f"{label} {dtype}: {name} disagrees with the plain "
                                         f"version, max_abs_err {e.max().item():.3e} (tol {tol})")
                errs.append(f"{name} {e.max().item():.2e} (max |ref| {w.abs().max().item():.2e})")
                worst[dtype] = max(worst[dtype], e.max().item())
            texts.append(f"{str(dtype)[6:]} " + ", ".join(errs))
            if dtype == torch.float32:
                args32 = args
        text = f"{label}: max_abs_err " + "; ".join(texts) + "; bit-equal across launches"
        if carry or reverse or sliced:
            print(text)
            continue
        ms, plain_ms, _ = in_turns(lambda: bwd(*args32), lambda: ref(*args32), iters=20,
                                   plain_iters=3)
        ms16 = device_ms(lambda: bwd(*args), iters=20)
        flops = k2_bwd_flops(b, h, K2_P, K2_N, l)
        bnd, by = bound_ms(k2_bwd_bytes(b, h, K2_P, K2_N, l), flops)
        bnd16, by16 = bound_ms(k2_bwd_bytes(b, h, K2_P, K2_N, l, 2), flops)
        first = K2_BWD_FIRST_US.get((b, h, l))
        versus = "" if first is None else f" (kernel / first form {ms * 1e3 / first:.2f})"
        print(f"{text}; device time: kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
              f"bound {bnd * 1e3:.2f} us ({by}, {bnd / ms:.0%} of it; kernel / bound "
              f"{ms / bnd:.1f}), first form {recorded_us(K2_BWD_FIRST_US, (b, h, l))}"
              f"{versus}; bf16 kernel {ms16 * 1e3:.2f} us, bound "
              f"{bnd16 * 1e3:.2f} us ({by16}; kernel / bound {ms16 / bnd16:.1f}; bf16 / fp32 "
              f"{ms16 / ms:.2f})")
        timing[(b, h, l)] = (ms, plain_ms, bnd, by)
        timing16[(b, h, l)] = (ms16, None, bnd16, by16)
        if (h, l) in ((8, 65536), (128, 64)):
            kernel_breakdown(lambda: bwd(*args32), label)
            if b == 1:
                kernel_breakdown(lambda: bwd(*args), f"{label} bf16")
    return {"max_abs_err": worst[torch.float32], "timing": timing,
            "bf16_max_abs_err": worst[torch.bfloat16], "bf16_timing": timing16}


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
    if "horizon40" in outs:  # its first forward is the batch-1 request's: the same bits
        chain_err = np.abs(outs["horizon40"][:, :20] - outs["batch1"]).max()
        print(f"{label} horizon40 first 20 frames vs batch1: max_abs_err={chain_err:.3e} "
              f"(tol 0)")
        if chain_err:
            raise AssertionError(f"{label}: the chained request's first forward differs")


def compare_with_cpu(label, cpu_out, card_out) -> float:
    err = float(np.abs(cpu_out - card_out).max())
    print(f"{label} card vs CPU, full model at {IMG}^2 batch 1: max_abs_err={err:.3e} "
          f"(tol {FORWARD_ATOL[label]:g}), output max |y|={np.abs(cpu_out).max():.3f}")
    if not err <= FORWARD_ATOL[label]:
        raise AssertionError(f"{label}: the card's forward disagrees with the CPU's")
    return err


def serve_duality(predict, inputs, counts, bf16: bool = False) -> tuple:
    """The duality model's three requests through the predict CLI (with
    ``--bf16``: in bf16 compute), each followed by a check that TF32 is off;
    in fp32 the batch-1 request again on the CPU against the card. Returns
    the launches and the outputs of each request."""
    from adnm_tpu_torch.device import tf32_enabled

    outs, per_request = {}, {}
    label = "duality bf16" if bf16 else "duality"
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, x in inputs.items():
            paths[name] = os.path.join(tmp, f"{name}.npy")
            np.save(paths[name], x)

        def serve(name, *extra):  # --root: no checkpoint there, the seeded init
            return predict.main(["--input", paths[name], "--output",
                                 os.path.join(tmp, f"{name}_out.npy"), "--root", tmp,
                                 "--img-size", str(IMG), "--batch-size", "4", *extra])

        for name in FORWARDS_PER_REQUEST:
            t0 = time.perf_counter()
            counts.reset()
            outs[name] = serve(name, "--device", "cuda", *(["--bf16"] if bf16 else []),
                               *(["--horizon", "40"] if name == "horizon40" else []))
            torch.cuda.synchronize()
            per_request[name] = counts.read()
            if tf32_enabled():
                raise AssertionError("the predict CLI left TF32 on for cuBLAS or cuDNN")
            if outs[name].dtype != np.float32:
                raise AssertionError(f"{label} {name}: predictions in {outs[name].dtype}")
            print(f"{label} request {name}: {outs[name].shape} in "
                  f"{time.perf_counter() - t0:.2f} s, launches {per_request[name]}")
        check_requests(label, inputs, outs, per_request,
                       {**NO_LAUNCHES, "rms_norm": K1_PER_FORWARD})
        if not bf16:
            t0 = time.perf_counter()
            cpu = serve("batch1", "--device", "cpu")
            print(f"duality CPU run {time.perf_counter() - t0:.1f} s")
            compare_with_cpu("duality", cpu, outs["batch1"])
    return per_request, outs


def serve_model(predict, label, kwargs, inputs, counts, requests,
                compute_dtype=torch.float32, per_forward=None) -> tuple:
    """Requests through ``predict.load_model`` and ``predict.forecast`` in
    ``compute_dtype``, each with the launches ``per_forward`` (by default a
    bimamba model's); in fp32 the batch-1 request again on the CPU against
    the card. Returns the launches and the outputs of each request. The
    requests share the model's graphs, as a server's would."""
    from adnm_tpu_torch.utils.graphs import GraphSet

    dev = torch.device("cuda")
    model = predict.load_model(None, dev, compute_dtype=compute_dtype, **kwargs)
    graphs = GraphSet(dev)
    outs, per_request = {}, {}
    for name in requests:
        t0 = time.perf_counter()
        counts.reset()
        outs[name] = predict.forecast(model, inputs[name], 4, dev,
                                      40 if name == "horizon40" else None, compute_dtype,
                                      graphs=graphs)
        torch.cuda.synchronize()
        per_request[name] = counts.read()
        print(f"{label} request {name}: {outs[name].shape} in {time.perf_counter() - t0:.2f} s, "
              f"launches {per_request[name]}")
    check_requests(label, inputs, outs, per_request,
                   per_forward or {**NO_LAUNCHES, "rms_norm": K1_PER_FORWARD,
                                   "ssd_chunked_scan": K2_PER_FORWARD})
    if compute_dtype == torch.float32:
        t0 = time.perf_counter()
        cpu_dev = torch.device("cpu")
        cpu = predict.forecast(predict.load_model(None, cpu_dev, **kwargs), inputs["batch1"], 1,
                               cpu_dev)
        print(f"{label} CPU run {time.perf_counter() - t0:.1f} s")
        compare_with_cpu(label, cpu, outs["batch1"])
    return per_request, outs


def compare_bf16_with_fp32(label: str, bf16_outs: dict, fp32_outs: dict) -> float:
    """Card bf16 against card fp32, the same weights and requests: relative
    L2 of every request's predictions within BF16_FORWARD_REL[label]."""
    err = max(rel(torch.from_numpy(bf16_outs[k]).double(), torch.from_numpy(fp32_outs[k]).double())
              for k in bf16_outs)
    print(f"{label} card bf16 vs card fp32, same weights, {sorted(bf16_outs)}: largest relative "
          f"L2 {err:.3e} (bound {BF16_FORWARD_REL[label]:g})")
    if not err <= BF16_FORWARD_REL[label]:
        raise AssertionError(f"{label}: bf16 predictions too far from fp32")
    return err


# Kernel groups of the device time, matched on the kernel's name in this
# order; what matches none is elementwise or other.
KERNEL_GROUPS = {
    "K2 backward (ssd_bwd_*)": ("ssd_bwd_",),
    "K1 backward (rms_norm_bwd, dw reduce)": ("rms_norm_bwd", "rms_norm_dw_reduce"),
    "K1 rms_norm": ("rms_norm",),
    "K2 ssd_chunked_scan": ("ssd_scan_", "ssd_carry"),
    "depthwise conv": ("depthwise",),
    "conv (cuDNN implicit gemm, transposes)": ("xmma_fprop", "implicit_convolve", "cudnn",
                                              "convolve", "fft", "winograd", "wgrad", "dgrad",
                                              "nchwToNhwc", "nhwcToNchw"),
    "bmm/gemm": ("gemm", "gemv", "Kernel2"),
    "AdamW and grad norm (multi-tensor)": ("multi_tensor_apply",),
    "reductions": ("reduce_kernel",),
    "softmax": ("softmax",),
    "grid_sample (TrajGRU warp)": ("grid_sampler",),
    "max pooling": ("max_pool",),
    "cat/copy/index": ("Cat", "copy", "index", "gather", "scatter"),
}


def profile_device(run, card: str, label: str, unit: str, n: int, warm: int = 3) -> None:
    """Trace ``n`` calls of ``run`` (after ``warm`` untraced ones) and print
    the device's busy time (the union of kernel intervals), its share of
    the first-to-last-kernel span, the kernels per call, and device time by
    group and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    # device events, without the ranges that annotate them (the optimizer's
    # "Optimizer.step#AdamW.step" spans its kernels and the gaps between them)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
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
    print(f"[{card}] {label}: device busy {busy / n / 1e3:.2f} ms/{unit}, busy share "
          f"{share:.3f}, {len(kernels) / n:.0f} kernels/{unit} ({n} {unit}s)")
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {group:40s} {t:8.3f} ms/{unit}")
    for name, (t, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  {t:8.3f} ms/{unit} {k / n:5.0f}x  {name[:100]}")


def kernel_breakdown(run, label: str, n: int = 10) -> None:
    """Device us per call of each kernel that ``run`` launches, from a
    trace of ``n`` calls after 3 untraced ones."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / n
    def short(name):  # the kernel's own name, without namespace, template or arguments
        m = re.search(r"(\w+)(<[^()]*>)?\(", name)
        return m.group(1) if m else name[:40]

    print(f"{label}, device us per call by kernel: " + ", ".join(
        f"{short(name)} {t:.2f}" for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])))


def host_times(run, n: int, warm: int = 3) -> list:
    """Host-clock ms of ``n`` synchronised calls of ``run``, after ``warm``."""
    for _ in range(warm):
        run()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def time_forward(predict, label, kwargs, inputs, card, compute_dtype=torch.float32,
                 profile_batches=(1, 4)) -> None:
    """Batch-1 latency, batch-4 frames/s and peak memory on the host's clock
    around synchronised forwards in ``compute_dtype``, then the profile at
    ``profile_batches``."""
    device = torch.device("cuda")
    model = predict.load_model(None, device, compute_dtype=compute_dtype, **kwargs)
    x1 = torch.from_numpy(inputs["batch1"]).to(device, compute_dtype)
    x4 = torch.from_numpy(inputs["batch4"]).to(device, compute_dtype)
    with torch.inference_mode():
        lat = host_times(lambda: model(x1), 10)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()  # weights, inputs and whatever else is live
        step = host_times(lambda: model(x4), 5)
        peak = torch.cuda.max_memory_allocated()
        fps = 4 * 20 / (statistics.median(step) / 1e3)
        print(f"[{card}] {label} batch-1 forward latency: median "
              f"{statistics.median(lat):.2f} ms, min {min(lat):.2f} ms, mean "
              f"{statistics.mean(lat):.2f} ms (10 runs)")
        print(f"[{card}] {label} batch-4 forward: median {statistics.median(step):.2f} ms -> "
              f"{fps:.1f} frames/s (4*20 frames per step)")
        print(f"[{card}] {label} peak device memory (batch-4 forward): {peak / 2**20:.1f} MiB, "
              f"of which {before / 2**20:.1f} MiB allocated before it")
        for x in (x1, x4):
            if x.shape[0] in profile_batches:
                profile_device(lambda: model(x), card, f"{label} profile batch {x.shape[0]}",
                               "forward", 3, warm=0)


# -- training -------------------------------------------------------------

def train_through_cli(counts, root: str, *extra: str, k1_forward: int = K1_PER_FORWARD,
                      dataset: str = "Shanghai") -> tuple:
    """One epoch through ``cli.train.main --dataset dataset`` on the card
    under ``root`` (with the ``extra`` flags), with each step's launches
    counted from 0 (``Trainer.train_step`` wrapped for the run) and held to
    those of a model of ``k1_forward`` K1 launches a forward. Returns the
    launches summed over the steps, the epoch snapshot's path and the final
    protocol's results (the evaluator's; ``laps_evaluate``'s for LAPS)."""
    from adnm_tpu_torch.cli import train as train_cli
    from adnm_tpu_torch.train.checkpoint import best_ckpt_dir
    from adnm_tpu_torch.train.loop import Trainer

    per_step, step = [], Trainer.train_step

    def counted(self, batch, lr, clip_norm):
        torch.cuda.synchronize()
        counts.reset()
        out = step(self, batch, lr, clip_norm)
        torch.cuda.synchronize()
        per_step.append(counts.read())
        return out

    Trainer.train_step = counted
    try:
        t0 = time.perf_counter()
        out = train_cli.main([*TRAIN_ARGS, "--img-size", str(IMG), "--root", root,
                              "--dataset", dataset, *extra])
        secs = time.perf_counter() - t0
    finally:
        Trainer.train_step = step
    snapshot = best_ckpt_dir(root, dataset, "ADNMUnet") + "_epoch1"
    trainer, (log,) = out["trainer"], out["logs"]
    print(f"train CLI --dataset {dataset}{' ' + ' '.join(extra) if extra else ''}: "
          f"{trainer.step} steps at batch 4 "
          f"on {trainer.device} in {trainer.compute_dtype} in {secs:.1f} s; "
          f"train loss {log.train_loss:.6f}, val loss {log.val_loss:.6f}, best-checkpoint "
          f"test loss {out['test_loss']:.6f}, grad norm {log.grad_norm_avg:.4f}; launches per "
          f"step {per_step}")
    if trainer.device.type != "cuda" or trainer.step != TRAIN_STEPS or len(per_step) != TRAIN_STEPS:
        raise AssertionError(f"train CLI: {trainer.step} steps on {trainer.device}, want "
                             f"{TRAIN_STEPS} on cuda")
    if not all(np.isfinite([log.train_loss, log.val_loss, out["test_loss"], log.grad_norm_avg])):
        raise AssertionError("train CLI: a loss or the gradient norm is not finite")
    if not os.path.exists(snapshot):
        raise AssertionError("train CLI: no epoch snapshot was written")
    want = step_launches(True, False, k1_forward)
    if any(c != want for c in per_step):
        raise AssertionError(f"train CLI: launches per step {per_step}, want {want}")
    check_metrics("train CLI", out["metrics"] if dataset == "Shanghai"
                  else {"threshold_metrics": out["metrics"]})
    return {k: sum(c[k] for c in per_step) for k in want}, snapshot, out["metrics"]


# -- evaluation -------------------------------------------------------------

# The test split of TRAIN_ARGS' 24 synthetic clips: int(24 * 0.15) = 3 clips,
# one batch of 4, so one forward per CLI run.
TEST_CLIPS, EVAL_FORWARDS = 3, 1
THRESHOLDS = (20, 30, 35, 40)
# The same (preds, gts) evaluated on the card and on the CPU: floor and
# compare are exact in fp32 on both, so the counts are equal; MAE and MSE
# are fp32 means over 65,536 pixels in another order (1e-6 relative); SSIM
# sums 121 taps on values up to 90^2 in another order, then takes ratios of
# order 1 (1e-5 absolute, as the port's CPU tests hold it against JAX).
EVAL_MEAN_RTOL, EVAL_SSIM_ATOL = 1e-6, 1e-5
# predict --ckpt on the test clips, in one batch as validate ran them,
# against validate's predictions from the same checkpoint, on the same card
# and code: 1e-5. Two forwards of one input on the card are bit-equal (the
# phase checks it on the first clip, and names the modules that compute
# differently from equal inputs if they are not).
SERVE_ATOL = 1e-5
# A batch of the evaluator's device timing: 4 clips of 20 frames at 256^2.
EVAL_TIMING_SHAPE = (4, 20, IMG, IMG)


def spread_sources(model, x, top: int = 8) -> tuple:
    """Two forwards of ``x``, every module's inputs and outputs recorded by
    forward hooks: (the largest difference of the two outputs, the first
    ``top`` calls, in call order, whose inputs were equal in both forwards
    and whose outputs were not, as (module name, class, max abs diff)).
    Such a call computes differently from the same data: a source of the
    spread, not a carrier of it."""
    records = [[], []]

    def hook(name):
        def record(module, args, out):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            if isinstance(out, torch.Tensor):
                records[run].append((name, type(module).__name__,
                                     [t.detach().clone() for t in tensors], out.detach().clone()))
        return record

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    try:
        outs = []
        with torch.inference_mode():
            for run in range(2):
                outs.append(model(x))
    finally:
        for h in handles:
            h.remove()
    sources = []
    for (name, cls, ins_a, out_a), (_, _, ins_b, out_b) in zip(*records):
        if all(torch.equal(a, b) for a, b in zip(ins_a, ins_b)) and not torch.equal(out_a, out_b):
            sources.append((name, cls, float((out_a - out_b).abs().max())))
    return float((outs[0] - outs[1]).abs().max()), sources[:top]


def grad_spread_sources(trainer, batch: np.ndarray, top: int = 8) -> tuple:
    """Two backward passes of one batch (``trainer.grads``), every module
    call's output and input gradients recorded by full backward hooks and
    every parameter's gradient kept: (the largest difference of the two
    runs' parameter gradients, the first ``top`` module calls, in backward
    order, whose output gradients were equal in both runs and whose input
    gradients or own parameters' gradients were not, as (module name,
    class, max abs diff)). A module whose child is such a call is left
    out: the innermost call is the source. Hooks on a module inside a
    ``torch.utils.checkpoint`` region fire again in the recompute, so build
    ``trainer`` without the refiner's remat."""
    model = trainer.model
    records = [[], []]

    def hook(name):
        def record(module, grad_in, grad_out):
            def keep(gs):
                return [None if g is None else g.detach().clone() for g in gs]
            records[run].append((name, type(module).__name__, keep(grad_out), keep(grad_in)))
        return record

    handles = [m.register_full_backward_hook(hook(n)) for n, m in model.named_modules() if n]
    owner = {id(p): n for n, m in model.named_modules() if n
             for p in m.parameters(recurse=False)}
    grads = []
    try:
        for run in range(2):
            _, g = trainer.grads(batch)
            grads.append({k: v.detach().clone() for k, v in g.items()})
    finally:
        for h in handles:
            h.remove()

    def diff(a, b):
        pairs = [(x, y) for x, y in zip(a, b) if x is not None]
        return max((float((x - y).abs().max()) for x, y in pairs), default=0.0)

    params = dict(model.named_parameters())
    param_diff = {}
    for k in grads[0]:
        d = diff([grads[0][k]], [grads[1][k]])
        if d:
            name = owner[id(params[k])]
            param_diff[name] = max(param_diff.get(name, 0.0), d)
    flagged, equal_out = [], {}
    for (name, cls, out_a, in_a), (_, _, out_b, in_b) in zip(*records):
        same_out = diff(out_a, out_b) == 0.0
        equal_out[name] = equal_out.get(name, True) and same_out
        if same_out and diff(in_a, in_b):
            flagged.append((name, cls, diff(in_a, in_b)))
    classes = dict((n, type(m).__name__) for n, m in model.named_modules())
    flagged += [(n, classes[n], d) for n, d in param_diff.items()
                if equal_out.get(n) and all(f[0] != n for f in flagged)]
    inner = [f for f in flagged if not any(g[0].startswith(f[0] + ".") for g in flagged)]
    spread = max((diff([grads[0][k]], [grads[1][k]]) for k in grads[0]), default=0.0)
    return spread, inner[:top]


def check_metrics(label: str, results: dict) -> None:
    """Every count finite, and CSI, POD and HSS finite or NaN only where
    their denominators are 0."""
    for thr, m in results["threshold_metrics"].items():
        tp, tn, fp, fn = (m[k] for k in ("TP", "TN", "FP", "FN"))
        if not np.isfinite([tp, tn, fp, fn]).all():
            raise AssertionError(f"{label} {thr}: a count is not finite")
        denominators = {"CSI": tp + fp + fn, "POD": tp + fn,
                        "HSS": fp**2 + fn**2 + 2 * tp * tn + (fp + fn) * (tp + tn)}
        for k, den in denominators.items():
            if not (np.isfinite(m[k]) or (np.isnan(m[k]) and den == 0)):
                raise AssertionError(f"{label} {thr}: {k} = {m[k]} with denominator {den}")


def png_header(path: str) -> tuple:
    """(width, height, colour type) of a PNG, from its signature and its
    IHDR chunk, whose CRC is checked."""
    with open(path, "rb") as f:
        head = f.read(33)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path}: not a PNG")
    if struct.unpack(">I", head[29:33])[0] != zlib.crc32(head[12:29]) & 0xFFFFFFFF:
        raise AssertionError(f"{path}: IHDR CRC mismatch")
    width, height, depth, colour = struct.unpack(">IIBB", head[16:26])
    if depth != 8:
        raise AssertionError(f"{path}: bit depth {depth}")
    return width, height, colour


def strip_width(frames: int) -> int:
    return frames * IMG + (frames - 1) * 10  # 10-pixel gaps


def evaluate_through_clis(counts, root: str, snapshot: str, trained_metrics: dict,
                          card: str) -> dict:
    """validate, predict --ckpt --png and visualize on the train CLI's
    epoch snapshot, each with the launch counts set to 0 just before it
    and read just after; the validate run's predictions evaluated on the
    card and on the CPU; two forwards of one clip bit-equal; the
    evaluator's device time."""
    from adnm_tpu_torch.cli import predict
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.cli import visualize as visualize_cli
    from adnm_tpu_torch.data.shanghai import ShanghaiDataset
    from adnm_tpu_torch.metrics.evaluator import SimplifiedEvaluator, _batch_stats

    t_phase = time.perf_counter()
    cli_args = [*DATA_ARGS, "--img-size", str(IMG), "--root", root, "--ckpt", snapshot]
    want = {**NO_LAUNCHES, "rms_norm": K1_PER_FORWARD * EVAL_FORWARDS}
    launches = {}

    def counted(name, run):
        counts.reset()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = counts.read()
        print(f"{name} CLI on {snapshot.rsplit(os.sep, 1)[-1]}: {secs:.2f} s wall, "
              f"launches {launches[name]}")
        if launches[name] != want:
            raise AssertionError(f"{name} CLI: launches {launches[name]}, want {want}")
        return out, secs

    val, val_secs = counted("validate", lambda: validate_cli.main(cli_args))
    trainer, preds, gts, metrics = val["trainer"], val["preds"], val["gts"], val["metrics"]
    if trainer.device.type != "cuda":
        raise AssertionError(f"validate CLI ran on {trainer.device}")
    if preds.shape != (TEST_CLIPS, 20, IMG, IMG) or not np.isfinite(preds).all():
        raise AssertionError(f"validate CLI: predictions {preds.shape}")
    check_metrics("validate CLI", metrics)
    cells, trained_cells = metrics["threshold_metrics"], trained_metrics["threshold_metrics"]
    differ = max(abs(cells[t][k] - trained_cells[t][k])
                 for t in THRESHOLDS for k in ("TP", "TN", "FP", "FN"))
    print(f"validate vs the train CLI's final protocol, same weights: largest count difference "
          f"{differ:.0f}; " + "; ".join(
              f"{t}mm CSI {cells[t]['CSI']:.4f} / {trained_cells[t]['CSI']:.4f}"
              for t in THRESHOLDS))
    if differ:
        raise AssertionError("validate's counts differ from the train CLI's on the same weights")

    # the same arrays on the card and on the CPU
    evs = []
    for dev in ("cuda", "cpu"):
        ev = SimplifiedEvaluator(20, 90, THRESHOLDS, device=dev)
        ev.evaluate(preds, gts)  # the reference orientation
        evs.append(ev)
    on_card, on_cpu = evs
    if on_card.metrics != on_cpu.metrics:
        raise AssertionError("evaluator: the card's contingency counts differ from the CPU's")
    errs = {}
    for k in ("mae", "mse", "ssim"):
        a, b = np.asarray(on_card.losses[k]), np.asarray(on_cpu.losses[k])
        errs[k] = float(np.max(np.abs(a - b) / (np.abs(b) if k != "ssim" else 1.0)))
    print(f"evaluator card vs CPU on validate's {preds.shape}: counts equal; MAE rel err "
          f"{errs['mae']:.3e}, MSE rel err {errs['mse']:.3e} (tol {EVAL_MEAN_RTOL:g}), SSIM abs "
          f"err {errs['ssim']:.3e} (tol {EVAL_SSIM_ATOL:g})")
    if not (errs["mae"] <= EVAL_MEAN_RTOL and errs["mse"] <= EVAL_MEAN_RTOL
            and errs["ssim"] <= EVAL_SSIM_ATOL):
        raise AssertionError("evaluator: the card's MAE, MSE or SSIM disagree with the CPU's")
    if on_card.done()["threshold_metrics"].keys() != metrics["threshold_metrics"].keys():
        raise AssertionError("evaluator: thresholds differ from validate's")

    with tempfile.TemporaryDirectory() as tmp:
        test = ShanghaiDataset(None, IMG, "test", synthetic_len=SYNTHETIC_LEN)
        clips = np.stack([test[i][:5] for i in range(len(test))])[:, :, None]
        np.save(os.path.join(tmp, "x.npy"), clips)
        png = os.path.join(tmp, "png")
        served, _ = counted("predict", lambda: predict.main(
            ["--input", os.path.join(tmp, "x.npy"), "--output", os.path.join(tmp, "y.npy"),
             "--img-size", str(IMG), "--ckpt", snapshot, "--png", png, "--root", root]))
        serve_err = float(np.abs(served[:, :, 0] - preds).max())
        print(f"predict --ckpt vs validate's predictions of the {len(clips)} test clips: "
              f"max_abs_err {serve_err:.3e} (tol {SERVE_ATOL:g})")
        if not serve_err <= SERVE_ATOL:
            raise AssertionError("predict --ckpt does not reproduce validate's predictions")
        model = predict.load_model(None, "cuda", ckpt=snapshot)
        spread, sources = spread_sources(model, torch.from_numpy(clips[:1]).to("cuda"))
        del model
        print(f"two batch-1 forwards of the first test clip on the card: max_abs_diff "
              f"{spread:.3e}; modules computing differently from equal inputs: {sources}")
        if spread:
            raise AssertionError("two forwards of one clip differ on the card")
        headers = {name: png_header(os.path.join(png, "sample0", name))
                   for name in ("pred.png", "input.png")}
        if headers != {"pred.png": (strip_width(20), IMG, 6),
                       "input.png": (strip_width(5), IMG, 6)}:
            raise AssertionError(f"predict --png: {headers}")

        vis_out = os.path.join(tmp, "vis")
        written, _ = counted("visualize", lambda: visualize_cli.main(
            cli_args + ["--out", vis_out, "--max-samples", "2"]))
        if len(written) != 2:
            raise AssertionError(f"visualize CLI wrote {written}")
        for d in written:
            headers = {name: png_header(os.path.join(d, name))
                       for name in ("ADNMUnet.png", "gt.png", "input.png")}
            if headers != {"ADNMUnet.png": (strip_width(10), IMG, 6),
                           "gt.png": (strip_width(10), IMG, 6),
                           "input.png": (strip_width(5), IMG, 6)}:
                raise AssertionError(f"visualize CLI: {d}: {headers}")
        print(f"predict --png and visualize wrote {len(clips) + len(written)} sample "
              f"directories; "
              f"PNG headers {headers}")

    # the evaluator's device time on a 4 x 20 x 256^2 batch
    gen = torch.Generator(device="cuda").manual_seed(0)
    t_b = torch.rand(EVAL_TIMING_SHAPE, generator=gen, device="cuda")
    p_b = torch.rand(EVAL_TIMING_SHAPE, generator=gen, device="cuda")
    ev_ms = device_ms(lambda: _batch_stats(t_b, p_b, THRESHOLDS, 90.0), iters=20)
    kernel_breakdown(lambda: _batch_stats(t_b, p_b, THRESHOLDS, 90.0),
                     f"evaluator _batch_stats on {EVAL_TIMING_SHAPE}")
    n_frames = EVAL_TIMING_SHAPE[0] * EVAL_TIMING_SHAPE[1]
    nbytes = 2 * t_b.numel() * 4
    flops = 2 * 121 * 5 * n_frames * (IMG - 10) ** 2  # the SSIM filter's taps
    bnd, by = bound_ms(nbytes, flops)
    ev = SimplifiedEvaluator(20, 90, THRESHOLDS, device="cuda")
    host = host_times(lambda: ev.evaluate(p_b, t_b), 5, warm=1)
    print(f"[{card}] evaluator on {EVAL_TIMING_SHAPE}: device {ev_ms:.3f} ms per batch "
          f"(_batch_stats, CUDA graph replay), bound {bnd:.3f} ms ({by}); evaluate() wall "
          f"median {statistics.median(host):.2f} ms (5 calls, from device tensors); validate "
          f"CLI wall {val_secs:.2f} s; K1 launches per CLI run "
          f"{ {k: v['rms_norm'] for k, v in launches.items()} }; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def train_batch(b: int, size: int = IMG) -> np.ndarray:
    """(b, 25, 1, size, size) synthetic clips, as the CLI's loader makes them."""
    from adnm_tpu_torch.data.shanghai import _synthetic_clip

    return np.stack([_synthetic_clip(np.random.default_rng(i), 25, size)
                     for i in range(b)])[:, :, None]


def make_trainer(device, compute_dtype=torch.float32, dataset: str = "Shanghai",
                 trainer_kwargs: dict = None, **model_kwargs):
    """The CLI's trainer for ``dataset``'s task: seeded init, reference init,
    the ADNMUnet preset; ``trainer_kwargs`` (``ddp``, ``zero1``) go to the
    Trainer."""
    from adnm_tpu_torch.cli.common import TASKS
    from adnm_tpu_torch.models.adnm_unet import apply_reference_init, create_adnm_unet
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset

    t_in, t_out, interval, _ = TASKS[dataset]
    return Trainer(create_adnm_unet(t_in, t_out, interval, **model_kwargs),
                   get_preset("ADNMUnet", t_in, t_out, interval, dataset), t_in, device,
                   seed=0, param_transform=apply_reference_init, compute_dtype=compute_dtype,
                   **(trainer_kwargs or {}))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||, 0 where both are 0."""
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb else (0.0 if float(a.norm()) == 0 else float("inf"))


def rel_all(ga: dict, gb: dict) -> float:
    """rel of the gradients of every parameter as one vector."""
    return float(torch.sqrt(sum((ga[k] - gb[k]).square().sum() for k in gb))) / gnorm(gb)


# Card against CPU for one fp32 training step, fixed bounds: the loss 1e-5
# and the global gradient norm 1e-3 relative, each gradient tensor 2e-2 of
# its norm plus 1e-7 of the global norm (the gates' gradients of
# 1e-9...1e-8 are rounding noise on both sides). Two card runs of the step
# give the same bits (cuDNN's deterministic algorithms in the backward;
# K1's and K2's backward kernels sum in one fixed order), so no spread of
# the card's own enters a bound.
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-3, "tensor": 2e-2, "tensor_of_global": 1e-7}
# bf16 compute on the card against fp32 on the card, the same weights, set
# in PERF.md before the first chip run of the bf16 phase: 4 times the port's
# bf16-vs-fp32 distance on the CPU for the full-width model at 32^2 (seed 0,
# a forward of 2 clips and a batch-1 step: relative L2 of the predictions
# 2.12e-2 duality and 6.33e-3 bimamba, the loss 1.70e-4 and 7.59e-5, the
# global gradient norm 1.98e-2 and 2.32e-3), rounded up.
# MLA: 4 times the larger of its distances at 32^2 and 64^2 (forward
# 1.149e-2 and 1.610e-2, loss 7.05e-5 and 1.218e-4; scripts/torch_bf16_distance.py),
# rounded up: at 256^2 the duality model's distance was 2.2 times its 32^2
# one. Its gradients' distance is not bounded by the CPU's at 32^2 and
# 64^2: at 256^2 the refiner's bf16 duality over 65,536 tokens sets it,
# with about the same norm of difference in both models, which at MLA's
# seeded weights is a large share of a gradient norm 6.5 times smaller
# (PERF.md section 2; JAX's own distance, on a narrow model at 256^2, is
# larger than the port's: scripts/torch_bf16_grad_vs_jax.py). The step
# holds it to twice the duality model's in the same run (``mla_phase``).
BF16_FORWARD_REL = {"duality": 0.09, "bimamba": 0.03, "mla": 0.07}
BF16_STEP_REL = {"duality": {"loss": 7e-4, "grad_norm": 0.08},
                 "bimamba": {"loss": 4e-4, "grad_norm": 0.01},
                 "mla": {"loss": 5e-4}}


def grads_of(trainer, batch) -> tuple:
    """(loss, {name: fp64 CPU gradient}) of one batch."""
    loss, grads = trainer.grads(batch)
    return float(loss), {k: g.detach().to("cpu", torch.float64) for k, g in grads.items()}


def gnorm(g: dict) -> float:
    return float(torch.sqrt(sum(v.square().sum() for v in g.values())))


def compare_step_with_cpu(label: str, kwargs: dict, bf16_grad_err: float = None) -> float:
    """One batch-1 step from the same seeded weights and batch: two card
    runs bit-equal in fp32 and in bf16 compute; the fp32 loss, global
    gradient norm and every gradient tensor on the card against the CPU
    (STEP_TOL); bf16's loss and global gradient norm against fp32's on the
    card (BF16_STEP_REL), or, given ``bf16_grad_err``, the norm of the bf16
    gradients' difference from the fp32 ones within it. Returns that
    norm."""
    batch = train_batch(1)
    card = make_trainer(torch.device("cuda"), **kwargs)
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        card.compute_dtype = dtype  # read by _split_batch alone
        runs[dtype] = [grads_of(card, batch) for _ in range(2)]
        (loss_a, ga), (loss_b, gb) = runs[dtype]
        if loss_a != loss_b or any(not torch.equal(ga[k], gb[k]) for k in ga):
            raise AssertionError(f"{label} {dtype}: two card runs of one step differ: "
                                 f"{[k for k in ga if not torch.equal(ga[k], gb[k])][:5]}")
        print(f"{label} train step {dtype} on the card, two runs: bit-equal (loss "
              f"{loss_a:.8f}, grad norm {gnorm(ga):.6f})")
    del card
    (loss32, g32), (loss16, g16) = runs[torch.float32][0], runs[torch.bfloat16][0]
    diff16 = rel_all(g16, g32) * gnorm(g32)
    err16 = {"loss": abs(loss16 - loss32) / abs(loss32),
             "grad_norm": abs(gnorm(g16) - gnorm(g32)) / gnorm(g32), "grad_err": diff16}
    tol16 = dict(BF16_STEP_REL[label])
    if bf16_grad_err is not None:
        tol16["grad_err"] = bf16_grad_err
    print(f"{label} train step card bf16 vs card fp32: " + ", ".join(
        f"{k} {'rel ' if k != 'grad_err' else ''}{err16[k]:.3e} (bound {tol16.get(k, 'none')})"
        for k in err16) + f", every gradient rel L2 {rel_all(g16, g32):.3e}")
    if not all(err16[k] <= tol16[k] for k in tol16):
        raise AssertionError(f"{label}: the bf16 step is too far from the fp32 one")
    t0 = time.perf_counter()
    loss_cpu, grads_cpu = make_trainer(torch.device("cpu"), **kwargs).grads(batch)
    print(f"{label} train step on the CPU (full width, {IMG}^2, batch 1): "
          f"{time.perf_counter() - t0:.1f} s")
    grads_cpu = {k: g.to(torch.float64) for k, g in grads_cpu.items()}
    loss_cpu = float(loss_cpu)
    err = {"loss": abs(loss32 - loss_cpu) / abs(loss_cpu),
           "grad_norm": abs(gnorm(g32) - gnorm(grads_cpu)) / gnorm(grads_cpu)}
    print(f"{label} train step card vs CPU: loss {loss32:.8f} vs {loss_cpu:.8f} (rel "
          f"{err['loss']:.3e}, tol {STEP_TOL['loss']:g}); grad norm {gnorm(g32):.6f} vs "
          f"{gnorm(grads_cpu):.6f} (rel {err['grad_norm']:.3e}, tol {STEP_TOL['grad_norm']:g})")
    rows, total = [], gnorm(grads_cpu)
    for k, want in grads_cpu.items():
        norm = float(want.norm())
        t = STEP_TOL["tensor"] + (STEP_TOL["tensor_of_global"] * total / norm if norm
                                  else float("inf"))
        e = rel(g32[k], want)
        rows.append((e / t if norm else e, e, t, norm, k))  # e: 0 or inf at norm 0
    rows.sort(reverse=True)
    errs = sorted(r[1] for r in rows if np.isfinite(r[1]))
    print(f"{label} train step card vs CPU, {len(rows)} gradient tensors: rel err median "
          f"{errs[len(errs) // 2]:.3e}, max {errs[-1]:.3e}; worst against its tolerance:")
    for ratio, e, t, norm, k in rows[:8]:
        print(f"  {k}: rel err {e:.3e}, tol {t:.3e}, |g| {norm:.3e}")
    big = [r for r in rows if r[3] > 1e-4 * total]
    print(f"  tensors with |g| > 1e-4 of the global norm: {len(big)}, rel err max "
          f"{max(r[1] for r in big):.3e}")
    bad = [r[-1] for r in rows if not r[0] <= 1.0]
    if not (err["loss"] <= STEP_TOL["loss"] and err["grad_norm"] <= STEP_TOL["grad_norm"]) or bad:
        raise AssertionError(f"{label} train step: card disagrees with CPU (loss, grad norm or "
                             f"{bad[:5]})")
    return diff16


def step_launches(remat: bool, scan: bool, k1_forward: int = K1_PER_FORWARD) -> dict:
    """Each kernel's launches in one training step of a model with
    ``k1_forward`` K1 launches a forward."""
    k1 = k1_forward + REFINER_K1 if remat else k1_forward
    want = {**NO_LAUNCHES, "rms_norm": k1, "rms_norm_backward": k1_forward}
    if scan:
        want["ssd_chunked_scan"] = K2_PER_STEP if remat else K2_PER_FORWARD
        want["ssd_chunked_scan_backward"] = K2B_PER_STEP
    return want


def time_train(card, label: str, kwargs: dict, counts, runs,
               compute_dtype=torch.float32, k1_forward: int = K1_PER_FORWARD) -> list:
    """For each (batch, refiner remat, profile) of ``runs``: the median,
    min and mean step time, frames/s and the peak memory of a step in
    ``compute_dtype``, that step's launches (asserted), and with
    ``profile`` a trace of 3 steps. Returns the launches of the counted
    steps."""
    device = torch.device("cuda")
    scan = kwargs.get("linear_attn_duality") is False
    trainer, launches = None, []
    for b, remat, profile in runs:
        if trainer is None or trainer.model.refiner.remat != remat:
            trainer = None  # freed before the next one is built
            torch.cuda.empty_cache()
            trainer = make_trainer(device, compute_dtype, refiner_remat=remat, **kwargs)
        batch = torch.from_numpy(train_batch(b)).to(device)

        def run():
            trainer.train_step(batch, LR, CLIP)

        times = host_times(run, 3, warm=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()  # weights, optimizer state, batch
        counts.reset()
        run()
        torch.cuda.synchronize()
        launches.append(counts.read())
        peak = torch.cuda.max_memory_allocated()
        med = statistics.median(times)
        what = f"{label} {'refiner remat' if remat else 'no refiner remat'}"
        if compute_dtype != torch.float32:
            what = f"{what} {str(compute_dtype)[6:]}"
        print(f"[{card}] train {what} batch {b}: step median {med:.2f} ms, min "
              f"{min(times):.2f} ms, mean {statistics.mean(times):.2f} ms (3 steps after 1) -> "
              f"{b * 20 / (med / 1e3):.1f} frames/s; peak device memory of a step "
              f"{peak / 2**20:.1f} MiB, of which {before / 2**20:.1f} MiB allocated before it; "
              f"launches {launches[-1]}")
        want = step_launches(remat, scan, k1_forward)
        if launches[-1] != want:
            raise AssertionError(f"train {what} batch {b}: launches {launches[-1]}, want {want}")
        if profile:
            profile_device(run, card, f"train {what} profile batch {b}", "step", 2, warm=0)
    return launches


# -- the baselines -------------------------------------------------------------

BASELINES = ("SmaATUnet", "ConvLSTM", "TrajGRU", "LPTQPN")
ALL_BASELINES = (*BASELINES, "TransUnet", "SwinUnet")
# Card against CPU for a baseline's batch-1 forward at 256^2, fp32 without
# TF32, seeded init, outputs up to ~1: set in PERF.md before the first chip
# run of the phase from the CPU's fp32 against fp64 at 64^2 (4.5e-8 ...
# 6.3e-7 max abs, scripts/torch_baseline_precision.py), with two orders of
# margin for 256^2 and the card's own order of sums.
BASELINE_FORWARD_ATOL = 1e-4
# A batch-1 step at 256^2, card against CPU: STEP_TOL, or ten times the
# CPU's own fp32 distance from fp64 at 256^2 where that is larger (seeded
# init, the smoke's clip; scripts/torch_baseline_precision.py --img-size
# 256): (loss rel, grad norm rel, the worst tensor's rel L2 among those
# above 1e-4 of the global norm, the largest error of an ``exact_zero_gradient``
# gradient over the global norm). The weighted MSE+MAE loss's gradient
# sums signs over 1.3 M output pixels, which cancel, so the fp32 sums of
# ConvLSTM's and TrajGRU's last convolutions lose three digits; SmaAt's
# train-mode BatchNorms amplify rounding, and the gradient of a conv bias
# before a BatchNorm, 0 in exact arithmetic, is rounding noise. TransUnet
# and SwinUnet at the stochastic rates 0; TransUnet's step loses digits in
# its ResNetV2 (worst tensor 4.1e-2 from fp64), and its key biases have an
# exact gradient of 0 (measured on the card machine's CPU, NVIDIA H100
# 80GB HBM3 host, with the same script).
BASELINE_FP64_DISTANCE = {"SmaATUnet": (6.7e-7, 5.0e-5, 1.18e-2, 2.1e-6),
                          "ConvLSTM": (1.4e-7, 1.7e-3, 2.3e-3, 0.0),
                          "TrajGRU": (6.3e-8, 9.0e-4, 2.8e-3, 0.0),
                          "LPTQPN": (1.6e-8, 9.7e-8, 2.6e-5, 0.0),
                          "TransUnet": (3.3e-7, 1.0e-3, 4.1e-2, 3.0e-12),
                          "SwinUnet": (3.8e-8, 3.2e-8, 3.9e-6, 0.0)}


def baseline_step_tol(name: str) -> dict:
    loss, grad_norm, tensor, noise = (10 * d for d in BASELINE_FP64_DISTANCE[name])
    return {"loss": max(STEP_TOL["loss"], loss),
            "grad_norm": max(STEP_TOL["grad_norm"], grad_norm),
            "tensor": max(STEP_TOL["tensor"], tensor),
            "tensor_of_global": STEP_TOL["tensor_of_global"],
            "zero_gradient_of_global": max(STEP_TOL["tensor_of_global"], noise)}


def exact_zero_gradient(name: str) -> bool:
    """A parameter whose gradient is 0 in exact arithmetic, rounding noise
    in fp32: a SmaAt conv bias that feeds a BatchNorm in train mode through
    linear maps alone (the depthwise and pointwise biases of each
    DoubleConvDS), and TransUnet's key biases (each query's logits move by
    one constant, which the softmax removes)."""
    return (name.endswith(("depthwise.bias", "pointwise.bias")) and ".conv" in name) or \
        name.endswith(".key.bias")


def baseline_trainer(name: str, device, size: int = IMG, rates0: bool = False,
                     **trainer_kwargs):
    """A baseline's trainer as the train CLI builds it: seeded init, the
    model's preset, no reference init; with ``rates0`` its Dropout and
    DropPath rates at 0 (a CPU and a CUDA generator draw different
    masks); ``trainer_kwargs`` (``ddp``, ``zero1``) go to the Trainer."""
    from adnm_tpu_torch.core.stochastic import zero_rates
    from adnm_tpu_torch.models.registry import create_model
    from adnm_tpu_torch.train.loop import Trainer
    from adnm_tpu_torch.train.presets import get_preset

    model = create_model(name, 5, 20, 6, img_size=size)
    return Trainer(zero_rates(model) if rates0 else model,
                   get_preset(name, 5, 20, 6, "Shanghai"), 5, device, seed=0, **trainer_kwargs)


def check_baseline_step(name: str) -> None:
    """(c), (d): one batch-1 step twice on the card (Dropout and DropPath at
    their published rates, the masks of one step), bit-equal in loss and
    every gradient; then on the CPU from the same seeded weights (with
    stochastic rates at 0 on both devices where the model has them): the
    loss, global gradient norm and every gradient tensor within
    ``baseline_step_tol``, the running statistics after the step within
    1e-4 relative."""
    from adnm_tpu_torch.core.stochastic import stochastic_layers

    batch = train_batch(1)
    card = baseline_trainer(name, torch.device("cuda"))
    masks = bool(stochastic_layers(card.model))
    runs = []
    for _ in range(2):
        loss, grads = grads_of(card, batch)
        runs.append((loss, grads, {k: b.detach().to("cpu", torch.float64).clone()
                                   for k, b in card.model.named_buffers()}))
    (loss_a, ga, sa), (loss_b, gb, _) = runs
    if loss_a != loss_b or any(not torch.equal(ga[k], gb[k]) for k in ga):
        raise AssertionError(f"{name}: two card runs of one step differ: "
                             f"{[k for k in ga if not torch.equal(ga[k], gb[k])][:5]}")
    del card
    if masks:  # the card-against-CPU step without masks
        print(f"{name} train step at the published rates: two card runs bit-equal (loss "
              f"{loss_a:.8f})")
        card = baseline_trainer(name, torch.device("cuda"), rates0=True)
        loss_a, ga = grads_of(card, batch)
        sa = {k: b.detach().to("cpu", torch.float64).clone()
              for k, b in card.model.named_buffers()}
        del card
    t0 = time.perf_counter()
    cpu = baseline_trainer(name, torch.device("cpu"), rates0=masks)
    loss_cpu, grads_cpu = grads_of(cpu, batch)
    secs = time.perf_counter() - t0
    total, tol = gnorm(grads_cpu), baseline_step_tol(name)
    err = {"loss": abs(loss_a - loss_cpu) / abs(loss_cpu),
           "grad_norm": abs(gnorm(ga) - total) / total}
    rows = []
    for k, want in grads_cpu.items():
        norm = float(want.norm())
        floor = tol["zero_gradient_of_global" if exact_zero_gradient(k) else "tensor_of_global"]
        rows.append((float((ga[k] - want).norm()) / (tol["tensor"] * norm + floor * total),
                     rel(ga[k], want), norm / total, k))
    rows.sort(reverse=True)
    stats = {k: rel(sa[k], b.to(torch.float64)) for k, b in cpu.model.named_buffers()}
    print(f"{name} train step {IMG}^2 batch 1: "
          + ("at rates 0 (loss " if masks else "two card runs bit-equal (loss ")
          + f"{loss_a:.8f}); card vs CPU ({secs:.1f} s on the CPU): loss rel {err['loss']:.3e} (tol "
          f"{tol['loss']:g}), grad norm rel {err['grad_norm']:.3e} (tol "
          f"{tol['grad_norm']:g}), {len(rows)} gradient tensors (tol {tol['tensor']:g} of "
          f"the norm + {tol['tensor_of_global']:g} of the global norm, "
          f"{tol['zero_gradient_of_global']:g} for an exact-zero gradient), the worst over their "
          f"bounds: " + ", ".join(f"{k} {r:.3e} (rel {e:.3e}, |g|/global {g:.3e})"
                                  for r, e, g, k in rows[:3])
          + (f"; running statistics rel L2 max {max(stats.values()):.3e} (tol 1e-4)"
             if stats else ""))
    if not (err["loss"] <= tol["loss"] and err["grad_norm"] <= tol["grad_norm"]) \
            or rows[0][0] > 1.0 or any(v > 1e-4 for v in stats.values()):
        raise AssertionError(f"{name} train step: card disagrees with CPU")


def lptqpn_gram_bound_ms(batch: int, dim: int = 20, blocks=(4, 6, 6, 8), refine: int = 2) -> float:
    """The byte bound of LPTQPN's q·kᵀ products in one forward at IMG^2: q
    and k (each B x C x L fp32) read once, for every TransformerBlock
    (levels 1-3 in the encoder and decoder, the central level, the
    refinement at level 1, dim doubling and L quartering per level; dec1
    and refine at 2 * dim); their (heads, C/heads)^2 outputs are
    negligible."""
    per_level = [(dim * 2 ** i, IMG * IMG // 4 ** i) for i in range(4)]
    counts = [blocks[0], blocks[1], blocks[2], blocks[3], blocks[2], blocks[1]]
    levels = [0, 1, 2, 3, 2, 1]
    nbytes = sum(n * 2 * batch * per_level[lv][0] * per_level[lv][1] * 4
                 for n, lv in zip(counts, levels))
    nbytes += (blocks[0] + refine) * 2 * batch * (2 * dim) * IMG * IMG * 4  # dec1, refine
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_baseline(name: str, counts, card: str) -> None:
    """(f): batch-1 forward latency, batch-4 frames/s and the forward's peak
    memory; step time at batch 1 and 4 (median of 10 after 3) and the peak
    memory of a batch-4 step; a profile of the batch-4 forward and the
    batch-1 forward's kernels. No hand kernel launches."""
    from adnm_tpu_torch.cli import predict

    device = torch.device("cuda")
    model = predict.load_model(None, device, model_name=name, img_size=IMG)
    rng = np.random.RandomState(0)
    x1 = torch.from_numpy(rng.rand(1, 5, 1, IMG, IMG).astype(np.float32)).to(device)
    x4 = torch.from_numpy(rng.rand(4, 5, 1, IMG, IMG).astype(np.float32)).to(device)
    with torch.inference_mode():
        lat = host_times(lambda: model(x1), 10)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fwd4 = host_times(lambda: model(x4), 5)
        peak = torch.cuda.max_memory_allocated()
        print(f"[{card}] {name} batch-1 forward latency: median {statistics.median(lat):.2f} ms, "
              f"min {min(lat):.2f} ms, mean {statistics.mean(lat):.2f} ms (10 runs); batch-4 "
              f"forward median {statistics.median(fwd4):.2f} ms -> "
              f"{4 * 20 / (statistics.median(fwd4) / 1e3):.1f} frames/s; peak device memory "
              f"(batch-4 forward) {peak / 2**20:.1f} MiB, of which {before / 2**20:.1f} MiB "
              f"allocated before it")
        profile_device(lambda: model(x4), card, f"{name} profile batch 4", "forward", 2, warm=0)
        if name == "LPTQPN":
            print(f"[{card}] LPTQPN's q·kᵀ products (42 a forward, the gemm group above): byte "
                  f"bound {lptqpn_gram_bound_ms(4):.3f} ms a batch-4 forward (q and k read "
                  f"once, {HBM_BYTES_PER_S / 1e12:g} TB/s)")
    del model
    trainer = baseline_trainer(name, device)
    for b in (1, 4):
        batch = torch.from_numpy(train_batch(b)).to(device)

        def run():
            trainer.train_step(batch, trainer.preset.lr(1, trainer.preset.epochs), 0.0)

        times = host_times(run, 5, warm=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        counts.reset()
        run()
        torch.cuda.synchronize()
        launches, peak = counts.read(), torch.cuda.max_memory_allocated()
        med = statistics.median(times)
        print(f"[{card}] train {name} batch {b}: step median {med:.2f} ms, min {min(times):.2f} "
              f"ms, mean {statistics.mean(times):.2f} ms (5 steps after 2) -> "
              f"{b * 20 / (med / 1e3):.1f} frames/s; peak device memory of a step "
              f"{peak / 2**20:.1f} MiB, of which {before / 2**20:.1f} MiB allocated before it")
        if launches != NO_LAUNCHES:
            raise AssertionError(f"train {name}: hand kernels launched {launches}")
    del trainer
    torch.cuda.empty_cache()


def baselines_through_clis(counts, root: str, names=BASELINES) -> None:
    """(e): each of ``names`` through the train CLI (one epoch of 4 steps at
    batch 4 with an epoch snapshot, no hand kernel launched), then
    ``predict --ckpt`` on the snapshot (the test clips; two forwards of the
    first clip bit-equal); for the models with BatchNorm (SmaAt, TransUnet)
    also ``validate --ckpt``, whose counts equal the train CLI's final
    protocol on the same weights and whose predictions the evaluator counts
    alike on the card and on the CPU, and which ``predict --ckpt``
    reproduces; for TransUnet and SwinUnet a round trip through a
    reference .pth (``reference_round_trip``)."""
    from adnm_tpu_torch.cli import predict
    from adnm_tpu_torch.cli import train as train_cli
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.data.shanghai import ShanghaiDataset
    from adnm_tpu_torch.metrics.evaluator import SimplifiedEvaluator
    from adnm_tpu_torch.train.checkpoint import best_ckpt_dir

    test = ShanghaiDataset(None, IMG, "test", synthetic_len=SYNTHETIC_LEN)
    clips = np.stack([test[i][:5] for i in range(len(test))])[:, :, None]
    x_path = os.path.join(root, "x.npy")
    np.save(x_path, clips)
    for name in names:
        args = [*TRAIN_ARGS, "--model", name, "--img-size", str(IMG), "--root", root]
        counts.reset()
        t0 = time.perf_counter()
        out = train_cli.main(args)
        secs = time.perf_counter() - t0
        trainer, (log,) = out["trainer"], out["logs"]
        print(f"{name} train CLI: {trainer.step} steps at batch 4 on {trainer.device} in "
              f"{secs:.1f} s; train loss {log.train_loss:.6f}, val loss {log.val_loss:.6f}, "
              f"best-checkpoint test loss {out['test_loss']:.6f}, grad norm "
              f"{log.grad_norm_avg:.4f}, lr {log.lr:.2e}, clip ratio {log.clip_ratio}")
        if trainer.device.type != "cuda" or trainer.step != TRAIN_STEPS or log.clip_ratio:
            raise AssertionError(f"{name} train CLI: {trainer.step} steps on {trainer.device}")
        if not np.isfinite([log.train_loss, log.val_loss, out["test_loss"]]).all():
            raise AssertionError(f"{name} train CLI: a loss is not finite")
        if counts.read() != NO_LAUNCHES:
            raise AssertionError(f"{name} train CLI launched hand kernels {counts.read()}")
        check_metrics(f"{name} train CLI", out["metrics"])
        snapshot = best_ckpt_dir(root, "Shanghai", name) + "_epoch1"
        served = predict.main(["--model", name, "--input", x_path, "--output",
                               os.path.join(root, "y.npy"), "--img-size", str(IMG), "--ckpt",
                               snapshot, "--root", root])
        if served.shape != (len(clips), 20, 1, IMG, IMG) or not np.isfinite(served).all():
            raise AssertionError(f"{name} predict --ckpt: {served.shape}")
        model = predict.load_model(None, "cuda", ckpt=snapshot, model_name=name, img_size=IMG)
        spread, sources = spread_sources(model, torch.from_numpy(clips[:1]).to("cuda"))
        del model
        print(f"{name} predict --ckpt on its epoch-1 snapshot: {served.shape}; two forwards of "
              f"the first test clip: max_abs_diff {spread:.3e} {sources}")
        if spread:
            raise AssertionError(f"{name}: two forwards of one clip differ on the card")
        if name in ("TransUnet", "SwinUnet"):
            reference_round_trip(name, snapshot, x_path, served, root)
        if name not in ("SmaATUnet", "TransUnet"):
            continue
        val = validate_cli.main([*DATA_ARGS, "--model", name, "--img-size", str(IMG), "--root",
                                 root, "--ckpt", snapshot])
        cells, trained = val["metrics"]["threshold_metrics"], out["metrics"]["threshold_metrics"]
        differ = max(abs(cells[t][k] - trained[t][k])
                     for t in THRESHOLDS for k in ("TP", "TN", "FP", "FN"))
        evs = []
        for dev in ("cuda", "cpu"):
            ev = SimplifiedEvaluator(20, 90, THRESHOLDS, device=dev)
            ev.evaluate(val["preds"], val["gts"])
            evs.append(ev)
        serve_err = float(np.abs(served[:, :, 0] - val["preds"]).max())
        print(f"{name} validate --ckpt: " + "; ".join(
            f"{t}mm CSI {cells[t]['CSI']:.4f} POD {cells[t]['POD']:.4f} HSS {cells[t]['HSS']:.4f}"
            for t in THRESHOLDS) + f"; largest count difference from the train CLI's final "
              f"protocol {differ:.0f}; evaluator counts card == CPU: "
              f"{evs[0].metrics == evs[1].metrics}; predict vs validate max_abs_err "
              f"{serve_err:.3e} (tol {SERVE_ATOL:g})")
        check_metrics(f"{name} validate CLI", val["metrics"])
        if differ or evs[0].metrics != evs[1].metrics or not serve_err <= SERVE_ATOL:
            raise AssertionError(f"{name}: validate disagrees with the train CLI, the CPU's "
                                 f"evaluator or predict")


def reference_round_trip(name: str, snapshot: str, x_path: str, served: np.ndarray,
                         root: str) -> None:
    """The snapshot's weights (and running statistics) exported as a
    reference state_dict (``torch_import.export_reference_state_dict``),
    saved as a .pth, converted back by
    ``scripts/torch_convert_reference_ckpt.py`` and served by ``predict
    --ckpt``: the predictions of the snapshot, bit for bit."""
    import importlib.util

    from adnm_tpu_torch.cli import predict
    from adnm_tpu_torch.train.torch_import import export_reference_state_dict

    spec = importlib.util.spec_from_file_location(
        "torch_convert_reference_ckpt",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                     "torch_convert_reference_ckpt.py"))
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)
    t0 = time.perf_counter()
    model = predict.load_model(None, "cpu", ckpt=snapshot, model_name=name, img_size=IMG)
    pth = os.path.join(root, f"{name}_best.pth")
    torch.save({k: torch.from_numpy(v) for k, v in export_reference_state_dict(name, model).items()},
               pth)
    del model
    converted = converter.main(["--model", name, "--pth", pth, "--out",
                                os.path.join(root, "converted"), "--img-size", str(IMG)])
    again = predict.main(["--model", name, "--input", x_path, "--output",
                          os.path.join(root, "y_converted.npy"), "--img-size", str(IMG), "--ckpt",
                          converted])
    print(f"{name} reference .pth round trip ({time.perf_counter() - t0:.1f} s): predict --ckpt "
          f"on the converted checkpoint bit-equal to the snapshot's: "
          f"{np.array_equal(again, served)}")
    if not np.array_equal(again, served):
        raise AssertionError(f"{name}: the converted checkpoint predicts otherwise")


def baseline_phase(counts, card: str) -> None:
    """The four baselines at 256^2: (a) card against CPU and (b) two
    forwards bit-equal, (c) and (d) a training step, (f) the card's figures,
    (e) the CLIs; no hand kernel on their path."""
    from adnm_tpu_torch.cli import predict

    t_phase = time.perf_counter()
    for name in BASELINES:
        check_baseline(predict, name, counts, card)
    with tempfile.TemporaryDirectory() as root:
        baselines_through_clis(counts, root)
    print(f"baseline phase: {time.perf_counter() - t_phase:.1f} s")


def check_baseline(predict, name: str, counts, card: str) -> None:
    """(a) the batch-1 forward card against CPU, (b) twice bit-equal, no
    hand kernel launched; (c), (d) a training step; (f) the card's
    figures."""
    x = np.random.RandomState(1).rand(1, 5, 1, IMG, IMG).astype(np.float32)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    model = predict.load_model(None, dev, model_name=name, img_size=IMG)
    counts.reset()
    a, b = (predict.forecast(model, x, 1, dev) for _ in range(2))
    if counts.read() != NO_LAUNCHES:
        raise AssertionError(f"{name} forward launched hand kernels {counts.read()}")
    del model
    t0 = time.perf_counter()
    want = predict.forecast(predict.load_model(None, cpu, model_name=name, img_size=IMG), x,
                            1, cpu)
    err = float(np.abs(a - want).max())
    rel_l2 = float(np.linalg.norm(a - want) / np.linalg.norm(want))
    print(f"{name} forward {IMG}^2 batch 1, card vs CPU ({time.perf_counter() - t0:.1f} s "
          f"on the CPU): max_abs_err {err:.3e} (tol {BASELINE_FORWARD_ATOL:g}), rel L2 "
          f"{rel_l2:.3e}, max |y| {np.abs(want).max():.3f}; two card forwards bit-equal: "
          f"{np.array_equal(a, b)}")
    if a.shape != (1, 20, 1, IMG, IMG) or not np.isfinite(a).all():
        raise AssertionError(f"{name}: forward {a.shape}")
    if not np.array_equal(a, b) or not err <= BASELINE_FORWARD_ATOL:
        raise AssertionError(f"{name}: the card's forward differs from itself or the CPU's")
    check_baseline_step(name)
    time_baseline(name, counts, card)


# -- the models of the last slice: MLA, the dead features, TransUnet, SwinUnet ----

NEW_BASELINES = ("TransUnet", "SwinUnet")


def serve_snapshot(predict, counts, label: str, snapshot: str, root: str, *extra: str,
                   per_forward: dict) -> np.ndarray:
    """``predict.main --ckpt`` on the test clips of TRAIN_ARGS' split, in one
    batch (one forward), with its launches counted from 0."""
    from adnm_tpu_torch.data.shanghai import ShanghaiDataset

    test = ShanghaiDataset(None, IMG, "test", synthetic_len=SYNTHETIC_LEN)
    x_path = os.path.join(root, "x.npy")
    np.save(x_path, np.stack([test[i][:5] for i in range(len(test))])[:, :, None])
    counts.reset()
    out = predict.main(["--input", x_path, "--output", os.path.join(root, "y.npy"),
                        "--img-size", str(IMG), "--ckpt", snapshot, "--root", root, *extra])
    torch.cuda.synchronize()
    launches = counts.read()
    print(f"{label} predict --ckpt {' '.join(extra)} on its epoch-1 snapshot: {out.shape}, "
          f"launches {launches}")
    if out.shape != (len(test), 20, 1, IMG, IMG) or not np.isfinite(out).all():
        raise AssertionError(f"{label} predict --ckpt: {out.shape}")
    if launches != per_forward:
        raise AssertionError(f"{label} predict --ckpt: launches {launches}, want {per_forward}")
    return out


def mla_phase(predict, inputs, counts, card, duality_bf16_grad_err: float) -> dict:
    """(a) The MLA ADNM-UNet at full width, 256^2: the batch-1 and batch-4
    requests (26 K1 launches a forward), the batch-1 forward card against
    CPU (the duality bound) and twice bit-equal; the same requests in bf16
    against fp32; a batch-1 step twice bit-equal and card against CPU
    (``compare_step_with_cpu``; in bf16 the loss within
    ``BF16_STEP_REL`` and the gradients' distance from fp32 within twice
    the duality model's in this run: the refiner's bf16 duality, which both
    share, sets it); the train CLI with ``--attn-type mla``
    (34 K1 and 26 K1 backward launches a step) and ``predict --ckpt
    --attn-type mla`` on its snapshot; latency, frames/s, peak memory and
    a profile of the forward; step times and peak memory. Returns the K1
    launches of a forward and of a step."""
    dev = torch.device("cuda")
    per_forward = {**NO_LAUNCHES, "rms_norm": K1_MLA_PER_FORWARD}
    requests, outs = serve_model(predict, "mla", MLA, inputs, counts, ["batch1", "batch4"],
                                 per_forward=per_forward)
    again = predict.forecast(predict.load_model(None, dev, **MLA), inputs["batch1"], 4, dev)
    print(f"mla two card forwards of the batch-1 request bit-equal: "
          f"{np.array_equal(again, outs['batch1'])}")
    if not np.array_equal(again, outs["batch1"]):
        raise AssertionError("mla: two forwards of one input differ on the card")
    _, outs16 = serve_model(predict, "mla bf16", MLA, inputs, counts, ["batch1", "batch4"],
                            torch.bfloat16, per_forward=per_forward)
    compare_bf16_with_fp32("mla", outs16, outs)
    compare_step_with_cpu("mla", MLA, 2 * duality_bf16_grad_err)
    with tempfile.TemporaryDirectory() as root:
        trained, snapshot, _ = train_through_cli(counts, root, "--attn-type", "mla",
                                                 k1_forward=K1_MLA_PER_FORWARD)
        serve_snapshot(predict, counts, "mla", snapshot, root, "--attn-type", "mla",
                       per_forward=per_forward)
    time_forward(predict, "mla", MLA, inputs, card, profile_batches=(4,))
    time_train(card, "mla", MLA, counts, [(1, True, False), (4, True, False)],
               k1_forward=K1_MLA_PER_FORWARD)
    return {"forward": requests["batch1"]["rms_norm"], "step": trained["rms_norm"] // TRAIN_STEPS,
            "backward_step": trained["rms_norm_backward"] // TRAIN_STEPS}


def check_dead_features(predict, inputs, counts) -> None:
    """(b) ``compute_dead_features=True`` against False from one weight set
    (the model with the dead e2ds seeded, the other loaded from it without
    them): bit-equal batch-1 predictions on the card, 20 K1 launches each."""
    from adnm_tpu_torch.models.adnm_unet import create_adnm_unet

    dev = torch.device("cuda")
    dead = predict.load_model(None, dev, compute_dead_features=True)
    live = create_adnm_unet(5, 20, 6)
    dead_keys = tuple(f"decoder.e2d_{i}." for i in range(3, 7))
    live.load_state_dict({k: v for k, v in dead.state_dict().items()
                          if not k.startswith(dead_keys)})
    live.to(dev).eval()
    outs, launches = [], []
    for model in (dead, live):
        counts.reset()
        outs.append(predict.forecast(model, inputs["batch1"], 1, dev))
        torch.cuda.synchronize()
        launches.append(counts.read())
    n_dead, n_live = (sum(p.numel() for p in m.parameters()) for m in (dead, live))
    print(f"compute_dead_features True ({n_dead:,} parameters) vs False ({n_live:,}), one weight "
          f"set: batch-1 predictions bit-equal {np.array_equal(*outs)}; launches {launches}")
    want = {**NO_LAUNCHES, "rms_norm": K1_PER_FORWARD}
    if not np.array_equal(*outs) or any(c != want for c in launches):
        raise AssertionError("compute_dead_features changes the prediction or the launches")


def new_models_phase(predict, inputs, counts, card, duality_bf16_grad_err: float) -> dict:
    """(a) the MLA ADNM-UNet, (b) the dead features, (c) TransUnet and
    SwinUnet through the baselines' checks (a)-(f) and a reference .pth
    round trip; prints the phase's seconds. Returns MLA's K1 launches."""
    t_phase = time.perf_counter()
    mla = mla_phase(predict, inputs, counts, card, duality_bf16_grad_err)
    check_dead_features(predict, inputs, counts)
    for name in NEW_BASELINES:
        check_baseline(predict, name, counts, card)
    with tempfile.TemporaryDirectory() as root:
        baselines_through_clis(counts, root, NEW_BASELINES)
    print(f"new models phase (MLA, dead features, TransUnet, SwinUnet): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return mla


# -- the LAPS task (5 -> 3 frames, 60 minutes; its own ADNM-UNet) ----------------

LAPS = "LAPS"
LAPS_T_OUT = 3
# Card against CPU for the LAPS model's batch-1 forward at 256^2, fp32 without
# TF32, seeded init: set in PERF.md before the phase's first chip run from the
# CPU's fp32 distance from fp64 at 256^2 (max abs 3.0e-6 duality, 2.5e-7
# bimamba; no InstanceNorm, so nothing amplifies rounding as the Shanghai
# duality model's refiner does), with 30 times margin for the card's own
# order of sums.
LAPS_FORWARD_ATOL = {"duality": 1e-4, "bimamba": 1e-4}
# The native decode against the F.interpolate path: both compute the same
# antialiased bilinear weights in other orders and precisions (the library
# in fp32 taps normalised in fp64; torch in fp32); 3e-7 measured on the CPU.
NATIVE_ATOL = 1e-6


def check_laps_model(predict, label: str, kwargs: dict, counts) -> dict:
    """The LAPS model's batch-1 forward on the card, launches counted from 0,
    twice bit-equal, against the CPU within LAPS_FORWARD_ATOL. Returns the
    launches of one forward."""
    x = np.random.RandomState(2).rand(1, 5, 1, IMG, IMG).astype(np.float32)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    model = predict.load_model(None, dev, dataset=LAPS, **kwargs)
    n_params = sum(p.numel() for p in model.parameters())
    counts.reset()
    a = predict.forecast(model, x, 1, dev)
    torch.cuda.synchronize()
    launches = counts.read()
    b = predict.forecast(model, x, 1, dev)
    del model
    t0 = time.perf_counter()
    want = predict.forecast(predict.load_model(None, cpu, dataset=LAPS, **kwargs), x, 1, cpu)
    err = float(np.abs(a - want).max())
    print(f"LAPS {label} create_adnm_unet(5, 3, 60) ({n_params:,} parameters) forward {IMG}^2 "
          f"batch 1: launches {launches}; card vs CPU ({time.perf_counter() - t0:.1f} s on the "
          f"CPU) max_abs_err {err:.3e} (tol {LAPS_FORWARD_ATOL[label]:g}), rel L2 "
          f"{np.linalg.norm(a - want) / np.linalg.norm(want):.3e}, max |y| "
          f"{np.abs(want).max():.3f}; two card forwards bit-equal: {np.array_equal(a, b)}")
    per_forward = {**NO_LAUNCHES, "rms_norm": K1_PER_FORWARD}
    if kwargs:
        per_forward["ssd_chunked_scan"] = K2_PER_FORWARD
    if a.shape != (1, LAPS_T_OUT, 1, IMG, IMG) or not np.isfinite(a).all():
        raise AssertionError(f"LAPS {label}: forward {a.shape}")
    if launches != per_forward:
        raise AssertionError(f"LAPS {label}: launches {launches}, want {per_forward}")
    if not np.array_equal(a, b) or not err <= LAPS_FORWARD_ATOL[label]:
        raise AssertionError(f"LAPS {label}: the card's forward differs from itself or the CPU's")
    return launches


def laps_bimamba_step(counts, card: str) -> dict:
    """Batch-1 and batch-4 training steps of the LAPS bimamba model (refiner
    remat) with their launches counted from 0: 28 K1, 20 K1 backward, 28 K2
    and 20 K2 backward; the step time (median of 5 after 3) and peak
    memory. Returns the batch-1 step's launches."""
    trainer = make_trainer(torch.device("cuda"), dataset=LAPS, **BIMAMBA)
    first = None
    for b in (1, 4):
        batch = torch.from_numpy(train_batch(b)[:, :5 + LAPS_T_OUT]).to("cuda")
        times = host_times(lambda: trainer.train_step(batch, LR, CLIP), 5)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        loss = float(trainer.train_step(batch, LR, CLIP)[0])
        torch.cuda.synchronize()
        launches = counts.read()
        first = first or launches
        print(f"[{card}] train LAPS bimamba refiner remat batch {b}: loss {loss:.6f}, step "
              f"median {statistics.median(times):.2f} ms (5 steps after 3); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; launches {launches}")
        want = step_launches(True, True)
        if launches != want or not np.isfinite(loss):
            raise AssertionError(f"LAPS bimamba step batch {b}: launches {launches}, want {want}, "
                                 f"loss {loss}")
    del trainer
    torch.cuda.empty_cache()
    return first


def laps_through_clis(predict, counts, root: str) -> dict:
    """The LAPS duality model through ``cli.train --dataset LAPS`` (4 steps at
    batch 4, launches asserted a step, ``laps_evaluate``'s table), then on
    its epoch snapshot ``cli.validate`` (3 frames, the LAPS thresholds; 20
    K1 launches, one forward), ``cli.visualize`` (every frame of the
    3-frame strips) and ``cli.predict --dataset LAPS --ckpt`` on the test
    clips (validate's predictions within SERVE_ATOL); and ConvLSTM
    (3 output frames) through the train CLI with no hand kernel launched.
    Returns the train CLI's launches summed over its steps."""
    from adnm_tpu_torch.cli import train as train_cli
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.cli import visualize as visualize_cli
    from adnm_tpu_torch.data.laps import LAPS_THRESHOLDS, LAPSDataset, laps_evaluate

    trained, snapshot, table = train_through_cli(counts, root, dataset=LAPS)
    per_forward = {**NO_LAUNCHES, "rms_norm": K1_PER_FORWARD}
    args = [*DATA_ARGS, "--dataset", LAPS, "--img-size", str(IMG), "--root", root,
            "--ckpt", snapshot]
    counts.reset()
    val = validate_cli.main(args)
    torch.cuda.synchronize()
    launches = counts.read()
    check_metrics("LAPS validate CLI", val["metrics"])
    recount = laps_evaluate(val["preds"], val["gts"], verbose=False)
    same = all(recount[t][k] == table[t][k] for t in LAPS_THRESHOLDS
               for k in ("TP", "FN", "FP", "TN"))
    print(f"LAPS validate --ckpt: preds {val['preds'].shape}, thresholds "
          f"{sorted(val['metrics']['threshold_metrics'])}, launches {launches}; laps_evaluate of "
          f"its predictions equals the train CLI's final table: {same}")
    if val["preds"].shape[1:] != (LAPS_T_OUT, IMG, IMG) or launches != per_forward or not same:
        raise AssertionError("LAPS validate: shape, launches or table")
    counts.reset()
    written = visualize_cli.main(args + ["--out", os.path.join(root, "pics"),
                                         "--max-samples", "2"])
    launches = counts.read()
    heads = [png_header(os.path.join(d, "ADNMUnet.png")) for d in written]
    print(f"LAPS visualize: {len(written)} strips {heads}, launches {launches}")
    if len(written) != 2 or any(h[0] != strip_width(LAPS_T_OUT) for h in heads) \
            or launches != per_forward:
        raise AssertionError("LAPS visualize: strips or launches")
    test = LAPSDataset(None, IMG, "test", synthetic_len=SYNTHETIC_LEN)
    x_path = os.path.join(root, "x.npy")
    np.save(x_path, np.stack([test[i][:5] for i in range(len(test))])[:, :, None])
    counts.reset()
    served = predict.main(["--dataset", LAPS, "--input", x_path, "--output",
                           os.path.join(root, "y.npy"), "--img-size", str(IMG), "--ckpt",
                           snapshot, "--root", root])
    launches = counts.read()
    err = float(np.abs(served[:, :, 0] - val["preds"]).max())
    print(f"LAPS predict --ckpt: {served.shape}, launches {launches}, against validate's "
          f"predictions max_abs_err {err:.3e} (tol {SERVE_ATOL:g})")
    if served.shape != (len(test), LAPS_T_OUT, 1, IMG, IMG) or launches != per_forward \
            or not err <= SERVE_ATOL:
        raise AssertionError("LAPS predict: shape, launches or predictions")
    counts.reset()
    t0 = time.perf_counter()
    out = train_cli.main([*TRAIN_ARGS, "--dataset", LAPS, "--model", "ConvLSTM", "--img-size",
                          str(IMG), "--root", root])
    log = out["logs"][0]
    print(f"LAPS ConvLSTM train CLI: {out['trainer'].step} steps in "
          f"{time.perf_counter() - t0:.1f} s, train loss {log.train_loss:.6f}, test loss "
          f"{out['test_loss']:.6f}, launches {counts.read()}")
    if out["trainer"].step != TRAIN_STEPS or counts.read() != NO_LAUNCHES or \
            not np.isfinite([log.train_loss, out["test_loss"]]).all():
        raise AssertionError("LAPS ConvLSTM train CLI: steps, launches or losses")
    check_metrics("LAPS ConvLSTM train CLI", {"threshold_metrics": out["metrics"]})
    return trained


def check_native_decode() -> None:
    """The native decode-resize (``data/native.py``, built with g++ from
    ``csrc/radar_io.cpp``) of a random 25 x 565 x 784 uint8 clip (the h5's
    frame size) to 256^2 against the ``F.interpolate`` path within
    NATIVE_ATOL, with the host ms per clip of both (median of 5)."""
    from adnm_tpu_torch.data import native, shanghai

    t0 = time.perf_counter()
    native.get_lib()
    built = time.perf_counter() - t0
    clip = np.random.RandomState(3).randint(0, 71, (25, 565, 784)).astype(np.uint8)
    got = native.decode_resize_clip(clip, IMG)
    want = shanghai._resize_bilinear_antialias(clip.astype(np.float32) / 255.0, IMG)
    err = float(np.abs(got - want).max())
    ms = {}
    for name, fn in (("native", lambda: native.decode_resize_clip(clip, IMG)),
                     ("F.interpolate", lambda: shanghai._resize_bilinear_antialias(
                         clip.astype(np.float32) / 255.0, IMG))):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = statistics.median(times)
    print(f"native decode (g++ build or load {built:.2f} s): 25 x 565 x 784 uint8 -> {got.shape} "
          f"against F.interpolate max_abs_err {err:.3e} (tol {NATIVE_ATOL:g}); host ms per clip "
          f"native {ms['native']:.2f} (4 threads), F.interpolate {ms['F.interpolate']:.2f} "
          f"(torch {torch.get_num_threads()} threads)")
    if got.shape != (25, IMG, IMG) or not err <= NATIVE_ATOL:
        raise AssertionError("native decode disagrees with the F.interpolate path")


def laps_phase(predict, counts, card: str) -> dict:
    """6f: the LAPS task. Returns the launches of its paths."""
    t_phase = time.perf_counter()
    forward = check_laps_model(predict, "duality", {}, counts)
    scan_forward = check_laps_model(predict, "bimamba", BIMAMBA, counts)
    step = laps_bimamba_step(counts, card)
    with tempfile.TemporaryDirectory() as root:
        trained = laps_through_clis(predict, counts, root)
    check_native_decode()
    print(f"LAPS phase: {time.perf_counter() - t_phase:.1f} s")
    return {"forward": forward, "bimamba_forward": scan_forward, "bimamba_step": step,
            "cli_step": {k: v // TRAIN_STEPS for k, v in trained.items()}}


# -- the six baselines in bf16 compute -----------------------------------------

# bf16 against fp32 on the card from the same weights, set in PERF.md before
# the phase's first chip run: 4 times the port's distance on the CPU, the
# largest at 32^2, 64^2 and 128^2 (scripts/torch_bf16_distance.py; a forward
# of 2 clips, relative L2; a batch-1 step's loss and global gradient norm,
# relative), rounded up. JAX's bf16 is fp32 after a model's first few layers
# (the interpolation matrices, the zero states, the temperature, the position
# embeddings, the LayerNorms): ConvLSTM's and TrajGRU's bf16 touches the
# first convolution alone. SmaAt's and TransUnet's seeded train-mode steps
# are ill-conditioned (their BatchNorms and ResNetV2; PERF.md section 2):
# their gradient norms move by 6 and 25 % on the CPU.
BASELINE_BF16_REL = {
    "SmaATUnet": {"forward": 2e-4, "loss": 3e-2, "grad_norm": 0.3},
    "ConvLSTM": {"forward": 6e-6, "loss": 8e-7, "grad_norm": 1e-5},
    "TrajGRU": {"forward": 6e-5, "loss": 6e-6, "grad_norm": 3e-6},
    "LPTQPN": {"forward": 6e-3, "loss": 2e-3, "grad_norm": 4e-3},
    "TransUnet": {"forward": 3e-3, "loss": 2e-2, "grad_norm": 1.0},
    "SwinUnet": {"forward": 1e-2, "loss": 2e-4, "grad_norm": 2e-3},
}


def bf16_vs_fp32(name: str, counts) -> None:
    """The batch-1 bf16 forward against fp32, two bf16 forwards bit-equal, no
    hand kernel; two bf16 batch-1 steps bit-equal (rates 0), their loss and
    gradient norm against the fp32 step's."""
    from adnm_tpu_torch.cli import predict

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    x = np.random.RandomState(1).rand(1, 5, 1, IMG, IMG).astype(np.float32)
    model = predict.load_model(None, dev, model_name=name, img_size=IMG, compute_dtype=bf16)
    counts.reset()
    a, b = (predict.forecast(model, x, 1, dev, compute_dtype=bf16) for _ in range(2))
    launches = counts.read()
    y32 = predict.forecast(model, x, 1, dev)  # fp32 parameters: fp32 compute on fp32 frames
    del model
    fwd = float(np.linalg.norm(a - y32) / np.linalg.norm(y32))
    trainer = baseline_trainer(name, dev, rates0=True)
    runs = {}
    for dt in (torch.float32, bf16):
        trainer.compute_dtype = dt  # read by _split_batch alone
        runs[dt] = [grads_of(trainer, train_batch(1)) for _ in range(1 if dt == torch.float32
                                                                     else 2)]
    del trainer
    (l32, g32), = runs[torch.float32]
    (l16, g16), (l16b, g16b) = runs[bf16]
    twice = l16 == l16b and all(torch.equal(g16[k], g16b[k]) for k in g16)
    err = {"forward": fwd, "loss": abs(l16 - l32) / abs(l32),
           "grad_norm": abs(gnorm(g16) - gnorm(g32)) / gnorm(g32)}
    tol = BASELINE_BF16_REL[name]
    print(f"{name} bf16 vs fp32 on the card, {IMG}^2 batch 1: " + ", ".join(
        f"{k} rel {err[k]:.3e} (bound {tol[k]:g})" for k in err)
        + f"; two bf16 forwards bit-equal {np.array_equal(a, b)}, two bf16 steps bit-equal "
          f"{twice}; every gradient rel L2 {rel_all(g16, g32):.3e}; launches {launches}")
    if a.shape != (1, 20, 1, IMG, IMG) or a.dtype != np.float32 or not np.isfinite(a).all():
        raise AssertionError(f"{name} bf16: forward {a.shape} {a.dtype}")
    if not np.array_equal(a, b) or not twice or launches != NO_LAUNCHES:
        raise AssertionError(f"{name} bf16: forwards or steps differ, or hand kernels launched")
    if not all(err[k] <= tol[k] for k in tol):
        raise AssertionError(f"{name} bf16: too far from fp32")


def bf16_baselines_through_clis(predict, counts, root: str) -> None:
    """The train CLI with --bf16 for SmaAt (BatchNorm) and TransUnet (4 steps
    at batch 4, no hand kernel launched, fp32 parameters and running
    statistics), and ``predict --bf16 --ckpt`` on each epoch snapshot (fp32
    predictions, two forwards of the first clip bit-equal)."""
    from adnm_tpu_torch.cli import train as train_cli
    from adnm_tpu_torch.data.shanghai import ShanghaiDataset
    from adnm_tpu_torch.train.checkpoint import best_ckpt_dir

    test = ShanghaiDataset(None, IMG, "test", synthetic_len=SYNTHETIC_LEN)
    x_path = os.path.join(root, "x.npy")
    np.save(x_path, np.stack([test[i][:5] for i in range(len(test))])[:, :, None])
    for name in ("SmaATUnet", "TransUnet"):
        counts.reset()
        t0 = time.perf_counter()
        out = train_cli.main([*TRAIN_ARGS, "--model", name, "--img-size", str(IMG), "--root",
                              root, "--bf16"])
        trainer, (log,) = out["trainer"], out["logs"]
        fp32_state = all(t.dtype == torch.float32 for t in
                         (*trainer.model.parameters(), *trainer.model.buffers()))
        print(f"{name} train CLI --bf16: {trainer.step} steps in {time.perf_counter() - t0:.1f} "
              f"s, train loss {log.train_loss:.6f}, test loss {out['test_loss']:.6f}, "
              f"parameters and buffers fp32 {fp32_state}, launches {counts.read()}")
        if trainer.step != TRAIN_STEPS or counts.read() != NO_LAUNCHES or not fp32_state \
                or not np.isfinite([log.train_loss, out["test_loss"]]).all():
            raise AssertionError(f"{name} train CLI --bf16: steps, launches, dtypes or losses")
        check_metrics(f"{name} train CLI --bf16", out["metrics"])
        del out, trainer
        snapshot = best_ckpt_dir(root, "Shanghai", name) + "_epoch1"
        served = predict.main(["--model", name, "--bf16", "--input", x_path, "--output",
                               os.path.join(root, "y.npy"), "--img-size", str(IMG), "--ckpt",
                               snapshot, "--root", root])
        model = predict.load_model(None, "cuda", ckpt=snapshot, model_name=name, img_size=IMG,
                                   compute_dtype=torch.bfloat16)
        first = torch.from_numpy(np.load(x_path)[:1]).to("cuda", torch.bfloat16)
        with torch.inference_mode():
            twice = torch.equal(model(first), model(first))
        del model
        print(f"{name} predict --bf16 --ckpt on its epoch-1 snapshot: {served.shape} "
              f"{served.dtype}; two bf16 forwards of the first clip bit-equal {twice}")
        if served.shape != (len(test), 20, 1, IMG, IMG) or served.dtype != np.float32 \
                or not np.isfinite(served).all() or not twice:
            raise AssertionError(f"{name} predict --bf16 --ckpt")


def bf16_baseline_phase(predict, counts, card: str) -> None:
    """6g: the six baselines at published width, 256^2, in bf16 compute."""
    t_phase = time.perf_counter()
    for name in ALL_BASELINES:
        bf16_vs_fp32(name, counts)
    with tempfile.TemporaryDirectory() as root:
        bf16_baselines_through_clis(predict, counts, root)
    print(f"bf16 baseline phase: {time.perf_counter() - t_phase:.1f} s")


# -- data parallelism: DDP, ZeRO-1, cross-rank BatchNorm, the DP train CLI ------

# The global batch of the data-parallel checks: one row a rank at world size 2.
DP_ROWS = 2
DP_CASES = ("duality", "bimamba", "SmaATUnet", "SwinUnet")
DP_TIMEOUT_S = 900
# Two ranks against one process on one card, both fp32 without TF32: the
# same kernels on the same data, except that the ranks' batch sums (the
# convolutions' weight gradients, the loss's mean) run over one row each
# and are then added by the all-reduce. That is one source of difference of
# those that card against CPU has (other kernels, every sum in another
# order), so each case takes its card-against-CPU step bound: STEP_TOL for
# the ADNM-UNet, ``baseline_step_tol`` for a baseline. The parameters after
# one AdamW step: within 2 lr (the update is lr * m/(sqrt(v) + eps), at
# most lr in size; a gradient near 0 may flip its sign), with ``DP_ADAM``
# for the bound of m/sqrt(v) after two steps (1.0013 at beta 0.9, 0.999).
DP_ADAM = 1.002


def dp_tol(case: str) -> dict:
    if case in ("duality", "bimamba"):
        return {**STEP_TOL, "zero_gradient_of_global": STEP_TOL["tensor_of_global"]}
    return baseline_step_tol(case)


def dp_trainer(case: str, device, **trainer_kwargs):
    """The case's trainer as the train CLI builds it (seeded init; the
    reference init for the ADNM-UNet; SwinUnet at its published Dropout and
    DropPath rates)."""
    if case in ("duality", "bimamba"):
        return make_trainer(device, trainer_kwargs=trainer_kwargs,
                            **(BIMAMBA if case == "bimamba" else {}))
    return baseline_trainer(case, device, **trainer_kwargs)


def kernel_counts() -> Counts:
    from adnm_tpu_torch.ops import rms_norm as k1_module
    from adnm_tpu_torch.ops import ssd

    return Counts(rms_norm=k1_module.rms_norm, rms_norm_backward=k1_module.rms_norm_backward,
                  ssd_chunked_scan=ssd.ssd_chunked_scan,
                  ssd_chunked_scan_backward=ssd.ssd_chunked_scan_backward,
                  ssd_segment_backward=ssd.SegmentBackward,
                  gated_rms_norm=k1_module.gated_rms_norm,
                  gated_rms_norm_backward=k1_module.gated_rms_norm_backward)


def dp_launches(case: str) -> dict:
    if case in ("duality", "bimamba"):
        return step_launches(True, case == "bimamba")
    return dict(NO_LAUNCHES)


def state_digest(trainer) -> str:
    """SHA-256 of every parameter and buffer's bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in trainer.model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_step_record(trainer, batch: torch.Tensor, counts, steps: int = 1,
                   save: str = "") -> dict:
    """The gradients of ``batch`` (a ``grads`` call; under DDP its first
    call builds the DDP module), then ``steps`` optimizer steps, the first
    with its launches counted from 0 and, given ``save``, the checkpoint
    written there after it."""
    from adnm_tpu_torch.utils.profiling import optimizer_state_bytes

    loss, grads = trainer.grads(batch)
    rec = {"grad_loss": float(loss), "grads": {k: g.detach().cpu().clone()
                                               for k, g in grads.items()}}
    for i in range(steps):
        torch.cuda.synchronize()
        counts.reset()
        loss, gn = trainer.train_step(batch, LR, CLIP)
        torch.cuda.synchronize()
        if i == 0:
            rec.update(loss=float(loss), gnorm=float(gn), launches=counts.read(),
                       params={k: v.detach().cpu().clone()
                               for k, v in trainer.model.state_dict().items()})
            if save:
                trainer.save(save)
    rec["digest"] = state_digest(trainer)
    rec["optimizer_bytes"] = optimizer_state_bytes(trainer.optimizer)
    return rec


def dp_two_ranks(rank: int, world: int, device, out: str) -> None:
    """Rank ``rank`` of the two-rank run: each case on its row of the global
    batch (``DP_CASES``; the duality model two steps), then ZeRO-1 on the
    duality model (two steps, the consolidated checkpoint after the first;
    the replicated duality run writes its checkpoint after its first step
    too). Rank 0 writes every record, rank 1 its digests, launches and
    bytes."""
    from adnm_tpu_torch.utils.profiling import optimizer_state_bytes

    counts = kernel_counts()
    rows = torch.from_numpy(train_batch(DP_ROWS)[rank:rank + 1]).to(device)
    for case in (*DP_CASES, "zero1"):
        t0 = time.perf_counter()
        if case == "zero1":
            trainer = dp_trainer("duality", device, ddp=True, zero1=True)
            trainer.train_step(rows, LR, CLIP)
            trainer.save(os.path.join(out, "zero1_ckpt"))
            trainer.train_step(rows, LR, CLIP)
            rec = {"digest": state_digest(trainer),
                   "optimizer_bytes": optimizer_state_bytes(trainer.optimizer),
                   "params": {k: v.detach().cpu().clone()
                              for k, v in trainer.model.state_dict().items()}}
        else:
            trainer = dp_trainer(case, device, ddp=True)
            rec = dp_step_record(trainer, rows, counts, steps=2 if case == "duality" else 1,
                                 save=os.path.join(out, "replicated_ckpt")
                                 if case == "duality" else "")
            rec["unreached"] = len(trainer.unreached)
        rec["seconds"] = time.perf_counter() - t0
        if rank != 0:
            rec = {k: v for k, v in rec.items() if k not in ("grads", "params")}
        torch.save(rec, os.path.join(out, f"{case}_rank{rank}.pt"))
        del trainer
        torch.cuda.empty_cache()


def dp_world_one(rank: int, world: int, device, out: str) -> None:
    """Case 1, one rank over NCCL: the DDP Trainer's step against the plain
    Trainer's on a batch of DP_ROWS, from the same seeded weights: the same
    bits (loss, gradient norm, every parameter and buffer after AdamW), the
    second step's launches, two DDP gradient calls of one batch bit-equal;
    then each one's step time and peak memory."""
    counts, card = kernel_counts(), card_line()
    batch = torch.from_numpy(train_batch(DP_ROWS)).to(device)
    res = {}
    plain = dp_trainer("duality", device)
    ddp = dp_trainer("duality", device, ddp=True)
    for step in (1, 2):
        got = {}
        for label, t in (("plain", plain), ("ddp", ddp)):
            torch.cuda.synchronize()
            counts.reset()
            loss, gn = t.train_step(batch, LR, CLIP)
            torch.cuda.synchronize()
            got[label] = (float(loss), float(gn), counts.read(), state_digest(t))
        same = got["plain"][0] == got["ddp"][0] and got["plain"][1] == got["ddp"][1] \
            and got["plain"][3] == got["ddp"][3]
        print(f"[{card}] DDP over NCCL at world size 1, duality {IMG}^2 batch {DP_ROWS}, step "
              f"{step}: loss {got['ddp'][0]:.8f} vs plain {got['plain'][0]:.8f}, grad norm "
              f"{got['ddp'][1]:.6f} vs {got['plain'][1]:.6f}, parameters and buffers "
              f"{'bit-equal' if same else 'DIFFER'}; launches DDP {got['ddp'][2]}, plain "
              f"{got['plain'][2]}")
        if not same:
            raise AssertionError("DDP at world size 1 does not give the plain step's bits")
        if step == 2 and not got["ddp"][2] == got["plain"][2] == dp_launches("duality"):
            raise AssertionError(f"DDP step launches {got['ddp'][2]}, want "
                                 f"{dp_launches('duality')}")
        res[f"step{step}_launches"] = got["ddp"][2]
    (la, ga), (lb, gb) = ddp.grads(batch), ddp.grads(batch)
    if float(la) != float(lb) or any(not torch.equal(ga[k], gb[k]) for k in ga):
        raise AssertionError("two DDP gradient calls of one batch differ")
    print(f"DDP world size 1: two gradient calls of one batch bit-equal (loss {float(la):.8f})")
    synced = [p for n, p in ddp.forward_net.named_parameters() if n not in ddp.unreached]
    res["allreduce_bytes"] = sum(p.numel() * p.element_size() for p in synced)
    res["unreached"] = len(ddp.unreached)
    for label, t in (("plain", plain), ("ddp", ddp)):
        def run(t=t):
            t.train_step(batch, LR, CLIP)

        times = host_times(run, 4, warm=1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        res[label] = {"median_ms": statistics.median(times), "min_ms": min(times),
                      "peak_mib": peak}
        print(f"[{card}] train step duality {IMG}^2 batch {DP_ROWS}, {label}"
              f"{' (DDP, NCCL, world size 1)' if label == 'ddp' else ''}: median "
              f"{statistics.median(times):.2f} ms, min {min(times):.2f} ms, mean "
              f"{statistics.mean(times):.2f} ms (4 steps after 1); peak device memory of a "
              f"step {peak:.1f} MiB")
    print(f"DDP all-reduces {res['allreduce_bytes']:,} bytes of fp32 gradients a step "
          f"({res['unreached']} parameters the loss does not reach stay out of its buckets) "
          f"and the 4-byte loss")
    torch.save(res, os.path.join(out, "world1.pt"))


def optimizer_state_diff(got: dict, want: dict) -> list:
    """The (parameter index, entry) pairs where two optimizer state dicts
    differ (``torch.equal``), and the hyperparameters' if they do."""
    diff = [(i, k) for i, w in want["state"].items() for k, v in w.items()
            if i not in got["state"] or k not in got["state"][i]
            or not torch.equal(torch.as_tensor(got["state"][i][k]), torch.as_tensor(v))]
    diff += [(i, "?") for i in got["state"] if i not in want["state"]]
    groups = [{k: v for k, v in g.items() if k in w} == w
              for g, w in zip(got["param_groups"], want["param_groups"])]
    if len(got["param_groups"]) != len(want["param_groups"]) or not all(groups):
        diff.append(("param_groups", "?"))
    return diff


def check_dp_case(case: str, ranks: list, ref: dict, steps_label: str) -> dict:
    """Two ranks' records of ``case`` against each other (bit-equal losses,
    gradient norms, parameters and buffers; the same launches) and against
    the single process's (``dp_tol``); returns the errors."""
    a, b = ranks
    if (a["loss"], a["gnorm"], a["digest"]) != (b["loss"], b["gnorm"], b["digest"]):
        raise AssertionError(f"{case}: the two ranks disagree after the step")
    if not a["launches"] == b["launches"] == dp_launches(case):
        raise AssertionError(f"{case}: launches per rank {a['launches']}, {b['launches']}, "
                             f"want {dp_launches(case)}")
    tol = dp_tol(case)
    want, got = ref["grads"], a["grads"]
    total = float(torch.sqrt(sum(w.double().square().sum() for w in want.values())))
    gn = float(torch.sqrt(sum(g.double().square().sum() for g in got.values())))
    err = {"loss": abs(a["grad_loss"] - ref["grad_loss"]) / abs(ref["grad_loss"]),
           "grad_norm": abs(gn - total) / total}
    rows = []
    for k, w in want.items():
        w = w.double()
        floor = tol["zero_gradient_of_global" if exact_zero_gradient(k) else "tensor_of_global"]
        rows.append((float((got[k].double() - w).norm()) / (tol["tensor"] * float(w.norm())
                                                            + floor * total), k))
    rows.sort(reverse=True)
    param_err = max(float((a["params"][k].double() - v.double()).abs().max())
                    for k, v in ref["params"].items() if v.is_floating_point() and v.numel())
    moved = sum(int(((a["params"][k].double() - v.double()).abs() > 1e-6).sum())
                for k, v in ref["params"].items() if v.is_floating_point())
    stats = {k: rel(a["params"][k].double(), v.double()) for k, v in ref["params"].items()
             if k.endswith((".mean", ".var"))}
    print(f"{case} {steps_label}: ranks bit-equal (loss {a['loss']:.8f}, grad norm "
          f"{a['gnorm']:.6f}), launches per rank {a['launches']}; against one process on the "
          f"global batch: loss rel {err['loss']:.3e} (tol {tol['loss']:g}), grad norm rel "
          f"{err['grad_norm']:.3e} (tol {tol['grad_norm']:g}), worst gradient tensor "
          f"{rows[0][1]} at {rows[0][0]:.3e} of its bound; parameters after the step max abs "
          f"{param_err:.3e} (bound {2 * LR * DP_ADAM:g} for AdamW), {moved} entries beyond 1e-6"
          + (f"; running statistics rel L2 max {max(stats.values()):.3e} (tol 1e-4)"
             if stats else "") + f"; {a['seconds']:.1f} s a rank")
    adam = case in ("duality", "bimamba")
    if not (err["loss"] <= tol["loss"] and err["grad_norm"] <= tol["grad_norm"]) \
            or rows[0][0] > 1.0 or any(v > 1e-4 for v in stats.values()) \
            or (adam and param_err > 2 * LR * DP_ADAM):
        raise AssertionError(f"{case}: two ranks disagree with one process")
    return {"loss_rel": err["loss"], "grad_norm_rel": err["grad_norm"],
            "worst_tensor_of_bound": rows[0][0], "param_max_abs": param_err}


def parallel_phase(card: str) -> dict:
    """Data parallelism (phase 6h), full width, 256^2, fp32:
    (1) DDP over NCCL at world size 1 against the plain Trainer, bit for
    bit, with step time, busy time and peak memory; (2) two ranks on the
    one card over gloo (CUDA tensors), one row each, against one process
    on the same global batch, for the duality and bimamba ADNM-UNet (K1 and
    K2 and their backwards on each rank), SmaAt-UNet (cross-rank
    BatchNorm) and SwinUnet (the global batch's masks); (3) ZeRO-1 on the
    duality model against (2), and its checkpoint resumed in one process;
    (4) the train CLI with --data-parallel and validate on its snapshot;
    over NCCL across cards where there are two or more."""
    import tempfile

    from adnm_tpu_torch.cli import train as train_cli
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.parallel import spawn
    from adnm_tpu_torch.train.checkpoint import best_ckpt_dir

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    n_cards = torch.cuda.device_count()
    counts = kernel_counts()
    res = {}
    with tempfile.TemporaryDirectory(prefix="adnm-dp-") as out:
        # (1) NCCL, one rank
        t0 = time.perf_counter()
        spawn(dp_world_one, 1, args=(out,), device="cuda", timeout_s=DP_TIMEOUT_S)
        res["world1"] = torch.load(os.path.join(out, "world1.pt"), weights_only=False)
        print(f"parallel (1): NCCL at world size 1 in {time.perf_counter() - t0:.1f} s")
        # the single process's records on the global batch, on this card
        refs = {}
        batch = torch.from_numpy(train_batch(DP_ROWS)).to(device)
        for case in DP_CASES:
            trainer = dp_trainer(case, device)
            refs[case] = dp_step_record(trainer, batch, counts)
            del trainer
            torch.cuda.empty_cache()
        # (2) and (3): two ranks on the one card over gloo
        t0 = time.perf_counter()
        spawn(dp_two_ranks, 2, args=(out,), device="cuda", backend="gloo", shared_device=True,
              timeout_s=DP_TIMEOUT_S)
        ranks = {case: [torch.load(os.path.join(out, f"{case}_rank{r}.pt"), weights_only=False)
                        for r in range(2)] for case in (*DP_CASES, "zero1")}
        print(f"parallel (2): two ranks on one card over gloo, {len(DP_CASES)} models and "
              f"ZeRO-1, in {time.perf_counter() - t0:.1f} s")
        res["cases"] = {case: check_dp_case(case, ranks[case], refs[case],
                                            f"two ranks (gloo, one {card.split(',')[0]})")
                        for case in DP_CASES}
        res["launches_per_rank"] = {case: ranks[case][0]["launches"] for case in DP_CASES}
        rep, z1 = ranks["duality"], ranks["zero1"]
        same = z1[0]["digest"] == z1[1]["digest"] == rep[0]["digest"]
        print(f"ZeRO-1, duality, two ranks: parameters and buffers after two steps "
              f"{'bit-equal to' if same else 'DIFFER from'} the replicated run's (the same "
              f"AdamW arithmetic on the same gradients); optimizer state per rank "
              f"{z1[0]['optimizer_bytes']:,} and {z1[1]['optimizer_bytes']:,} bytes against "
              f"{rep[0]['optimizer_bytes']:,} replicated")
        if not same or max(r["optimizer_bytes"] for r in z1) >= rep[0]["optimizer_bytes"] \
                or sum(r["optimizer_bytes"] for r in z1) != rep[0]["optimizer_bytes"]:
            raise AssertionError("ZeRO-1 disagrees with replicated training")
        # the consolidated AdamW state: every rank's share, the replicated
        # run's after step 1, bit for bit
        opt = {label: torch.load(os.path.join(out, f"{label}_ckpt"), map_location="cpu",
                                 weights_only=True)["opt_state"]
               for label in ("zero1", "replicated")}
        state_diff = optimizer_state_diff(opt["zero1"], opt["replicated"])
        print(f"ZeRO-1 consolidated checkpoint after step 1: AdamW state of "
              f"{len(opt['zero1']['state'])} parameters (step, exp_avg, exp_avg_sq) against the "
              f"replicated run's checkpoint: "
              + ("bit-equal" if not state_diff else f"DIFFERS at {state_diff[:5]}"))
        single = dp_trainer("duality", device)
        if state_diff or len(opt["replicated"]["state"]) != len(single.params):
            raise AssertionError("the ZeRO-1 checkpoint's optimizer state is not the "
                                 "replicated run's")
        single.load(os.path.join(out, "zero1_ckpt"))
        loss, _ = single.train_step(batch, LR, CLIP)
        now = single.model.state_dict()
        resumed = max(float((now[k].cpu().double() - v.double()).abs().max())
                      for k, v in z1[0]["params"].items() if v.is_floating_point() and v.numel())
        print(f"ZeRO-1 checkpoint (after step 1) resumed in one process "
              f"({type(single.optimizer).__name__}, step {single.step}): its step 2 against the "
              f"two ranks' step 2, parameters max abs {resumed:.3e} (bound "
              f"{2 * LR * DP_ADAM:g})")
        if single.step != 2 or resumed > 2 * LR * DP_ADAM:
            raise AssertionError("the ZeRO-1 checkpoint does not resume in one process")
        res["zero1"] = {"optimizer_bytes": [r["optimizer_bytes"] for r in z1],
                        "replicated_bytes": rep[0]["optimizer_bytes"], "resumed_max_abs": resumed}
        del single
        torch.cuda.empty_cache()
        if n_cards >= 2:
            t0 = time.perf_counter()
            spawn(dp_two_ranks, 2, args=(out,), device="cuda", timeout_s=DP_TIMEOUT_S)
            for case in DP_CASES:
                check_dp_case(case, [torch.load(os.path.join(out, f"{case}_rank{r}.pt"),
                                                weights_only=False) for r in range(2)],
                              refs[case], "two ranks over NCCL, one card each")
            print(f"parallel: case (2) over NCCL on two cards in {time.perf_counter() - t0:.1f} s")
        else:
            print(f"parallel: {n_cards} card visible: case (2) over NCCL across cards not run")
    print(f"parallel (3): the references, the comparisons and ZeRO-1's resume in "
          f"{time.perf_counter() - t_phase:.1f} s from the phase's start")
    # (4) the train CLI, one rank per visible card, and validate on its snapshot
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        out = train_cli.main([*TRAIN_ARGS, "--img-size", str(IMG), "--root", root,
                              "--data-parallel"])
        secs = time.perf_counter() - t0
        snapshot = best_ckpt_dir(root, "Shanghai", "ADNMUnet") + "_epoch1"
        (log,) = out["logs"]
        got = validate_cli.main([*DATA_ARGS, "--img-size", str(IMG), "--root", root,
                                 "--ckpt", snapshot])
        print(f"train CLI --data-parallel ({n_cards} rank(s), NCCL): 1 epoch at global batch 4 "
              f"in {secs:.1f} s, train loss {log.train_loss:.6f}, grad norm "
              f"{log.grad_norm_avg:.4f}, final-protocol test loss {out['test_loss']:.6f}; "
              f"validate on its snapshot: test loss {got['test_loss']:.6f} (rel tol "
              f"{SERVE_ATOL:g})")
        # the same weights in another process: cuDNN may pick other forward
        # algorithms, so predict's bound against validate (SERVE_ATOL) applies
        if not (os.path.exists(snapshot) and np.isfinite(log.train_loss)
                and abs(got["test_loss"] - out["test_loss"]) <= SERVE_ATOL * abs(out["test_loss"])):
            raise AssertionError("the data-parallel train CLI's snapshot does not validate to "
                                 "its own test loss")
        check_metrics("train CLI --data-parallel", out["metrics"])
    print(f"[{card}] parallel phase: backends NCCL (world size 1{', 2' if n_cards >= 2 else ''})"
          f" and gloo (world size 2 on one card); {time.perf_counter() - t_phase:.1f} s")
    return res


# -- single dispatch: K training steps and the eval forward as CUDA graphs ------

# The hand kernels' names in a trace (K1 and K3: rms_norm*; K2: ssd_*).
HAND_KERNELS = ("rms_norm", "ssd_")
# (label, trainer kind, model options, batch, K, whole-forward remat, dtype):
# phase 6i (a)'s cases; the hand kernels a step launches are ``step_launches``'.
GRAPH_STEP_CASES = [
    ("duality", "ADNMUnet", {}, 4, 4, False, torch.float32),
    ("bimamba", "ADNMUnet", BIMAMBA, 1, 2, False, torch.float32),
    ("duality bf16", "ADNMUnet", {}, 4, 2, False, torch.bfloat16),
    ("SmaATUnet", "SmaATUnet", {}, 4, 2, False, torch.float32),
    ("SwinUnet --remat", "SwinUnet", {}, 4, 2, True, torch.float32),
    ("TrajGRU", "TrajGRU", {}, 4, 2, False, torch.float32),
]


def graph_case_trainer(kind: str, options: dict, k: int, remat: bool, dtype):
    """The CLI's trainer of ``kind`` at full width, ``scan_steps=k``: the
    ADNM-UNet with the reference init, a baseline at its published rates."""
    device = torch.device("cuda")
    kwargs = {"scan_steps": k, "remat_forward": remat}
    if kind == "ADNMUnet":
        return make_trainer(device, dtype, trainer_kwargs=kwargs, **options)
    return baseline_trainer(kind, device, compute_dtype=dtype, **kwargs)


def synthetic_batches(n: int, b: int, seed: int = 0) -> np.ndarray:
    """(n, b, 25, 1, IMG, IMG): n batches of b synthetic clips, each its own."""
    from adnm_tpu_torch.data.shanghai import _synthetic_clip

    rng = np.random.default_rng(seed)
    clips = np.stack([_synthetic_clip(rng, 25, IMG) for _ in range(n * b)])
    return clips[:, :, None].reshape(n, b, 25, 1, IMG, IMG)


def graph_groups(n: int, k: int, b: int, seed: int = 0) -> list:
    """``n`` (k, b, ...) groups on the card, each clip its own."""
    return [torch.from_numpy(g).cuda()
            for g in synthetic_batches(n * k, b, seed).reshape(n, k, b, 25, 1, IMG, IMG)]


def hand_kernel_names(run) -> dict:
    """{kernel name: launches} of the hand kernels that one call of ``run``
    runs on the card, from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and any(p in e.name
                                                                   for p in HAND_KERNELS):
            names[e.name] = names.get(e.name, 0) + 1
    return names


def trace_launches(names: dict) -> dict:
    """Each counted wrapper's launches in the hand kernels of a trace
    (``hand_kernel_names``): a K1 launch runs one rms_norm row or tile
    kernel, its backward one rms_norm_bwd kernel (and the dw reduction); a
    K2 launch ends in one ssd_scan_fused or ssd_scan_outputs kernel, its
    backward in one ssd_bwd_sums, and its carried backward runs one
    ssd_bwd_carry_segment before its sums."""
    def n(*parts, but=()):
        return sum(v for k, v in names.items()
                   if any(p in k for p in parts) and not any(b in k for b in but))

    carried = n("ssd_bwd_carry_segment")
    return {**NO_LAUNCHES, "rms_norm": n("rms_norm", but=("bwd", "dw_reduce")),
            "rms_norm_backward": n("rms_norm_bwd"),
            "ssd_chunked_scan": n("ssd_scan_fused", "ssd_scan_outputs"),
            "ssd_chunked_scan_backward": n("ssd_bwd_sums") - carried,
            "ssd_segment_backward": carried}


def assert_same_trainer_state(label: str, a, b) -> None:
    """Every parameter, buffer and optimizer state entry of two trainers,
    bit for bit, and the step."""
    bad = [n for (n, p), q in zip(a.model.state_dict().items(), b.model.state_dict().values())
           if not torch.equal(p, q)]
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    bad += [(i, k) for i, st in sa.items() for k, v in st.items()
            if not torch.equal(v, sb[i][k])]
    if bad or a.step != b.step or sa.keys() != sb.keys():
        raise AssertionError(f"{label}: graphed and eager trainers differ at {bad[:6]} "
                             f"(steps {a.step}, {b.step})")


def check_graph_steps(counts, label, kind, options, b, k, remat, dtype) -> dict:
    """(a): two groups of k steps through ``Trainer(scan_steps=k).train_steps``
    (the first eager and captured, the second one replay) against 2k eager
    steps from the same weights, every loss, gradient norm and state entry
    bit for bit; the launches of the replay as those of k eager steps, by
    the counters and by the hand kernels' names in a trace."""
    scan = options.get("linear_attn_duality") is False
    eager = graph_case_trainer(kind, options, 1, remat, dtype)
    graphed = graph_case_trainer(kind, options, k, remat, dtype)
    launches = []
    for g, group in enumerate(graph_groups(2, k, b)):
        counts.reset()
        want = [eager.train_step(batch, LR, CLIP) for batch in group]
        torch.cuda.synchronize()
        eager_counts = counts.read()
        counts.reset()
        losses, norms = graphed.train_steps(group, LR, CLIP)
        torch.cuda.synchronize()
        launches.append(counts.read())
        if not (torch.equal(losses, torch.stack([w[0] for w in want]))
                and torch.equal(norms, torch.stack([w[1] for w in want]))):
            eager_values = [[float(v) for v in w] for w in want]
            raise AssertionError(f"graph {label}: group {g} losses {losses.tolist()} norms "
                                 f"{norms.tolist()}, eager {eager_values}")
        if launches[-1] != eager_counts:
            raise AssertionError(f"graph {label}: group {g} launched {launches[-1]}, eager "
                                 f"{eager_counts}")
    assert_same_trainer_state(f"graph {label}", graphed, eager)
    captured = next(iter(graphed.graphs.graphs.values()))
    want = (step_launches(True, scan) if kind == "ADNMUnet" else dict(NO_LAUNCHES))
    want = {n: k * v for n, v in want.items()}
    if launches[-1] != want:
        raise AssertionError(f"graph {label}: a replay launched {launches[-1]}, want {want}")
    names = {}
    if kind == "ADNMUnet":
        group = graph_groups(1, k, b, seed=1)[0]
        replay = hand_kernel_names(lambda: graphed.train_steps(group, LR, CLIP))
        steps = hand_kernel_names(lambda: [eager.train_step(x, LR, CLIP) for x in group])
        if replay != steps or not replay:
            raise AssertionError(f"graph {label}: hand kernels of a replay {replay}, of {k} "
                                 f"eager steps {steps}")
        if trace_launches(replay) != want:
            raise AssertionError(f"graph {label}: launches in the trace of a replay "
                                 f"{trace_launches(replay)}, want {want}")
        names = replay
    print(f"graph {label} batch {b}, K={k}{' remat' if remat else ''} "
          f"{str(dtype)[6:]}: 2 groups bit-equal to {2 * k} eager steps (losses, norms, "
          f"parameters, buffers, optimizer state); a replay launched {launches[-1]}; "
          f"capture {captured.capture_s:.3f} s, pool {captured.pool_bytes / 2**20:.1f} MiB"
          f"{'; trace of a replay: ' + str(names) if names else ''}")
    return {"launches_per_replay": trace_launches(names) if names else launches[-1], "k": k,
            "pool_mib": captured.pool_bytes / 2**20, "capture_s": captured.capture_s}


def check_graph_epoch(counts) -> None:
    """(a): an epoch of 5 batches at K=2 (two replays, one eager tail)
    against five eager steps, after a first group that captured the graph;
    then an LR and clip change between two replays."""
    eager = graph_case_trainer("ADNMUnet", {}, 1, False, torch.float32)
    graphed = graph_case_trainer("ADNMUnet", {}, 2, False, torch.float32)
    first, five = synthetic_batches(2, 1, seed=3), synthetic_batches(5, 1, seed=5)
    logs = []
    for t in (eager, graphed):
        t.train_epoch(list(first), LR, CLIP)
        counts.reset()
        logs.append(t.train_epoch(list(five), LR, CLIP))
        torch.cuda.synchronize()
        logs.append(counts.read())
    if logs[0] != logs[2] or logs[1] != logs[3] or logs[0]["steps"] != 5:
        raise AssertionError(f"graph epoch: eager {logs[0]} {logs[1]}, graphed {logs[2]} "
                             f"{logs[3]}")
    assert_same_trainer_state("graph epoch", graphed, eager)
    group = graph_groups(1, 2, 1, seed=2)[0]
    for lr, clip in ((LR / 2, 1e9), (LR / 4, CLIP / 2)):
        want = [eager.train_step(x, lr, clip) for x in group]
        losses, norms = graphed.train_steps(group, lr, clip)
        if not torch.equal(norms, torch.stack([w[1] for w in want])):
            raise AssertionError(f"graph LR {lr} clip {clip}: norms {norms.tolist()}")
    assert_same_trainer_state("graph LR and clip change", graphed, eager)
    print(f"graph epoch of 5 batches at K=2 (2 replays, 1 eager tail) = 5 eager steps: "
          f"{logs[2]}, launches {logs[3]}; two replays at new LRs and clip thresholds "
          f"({LR / 2:g}, no clip; {LR / 4:g}, {CLIP / 2:g}) bit-equal to eager steps")


def epoch_record(root: str) -> dict:
    """The train CLI's epoch record under ``root``, without its clock."""
    with open(os.path.join(root, "results", "Shanghai", "ADNMUnet_train.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    return {k: v for k, v in rec.items() if k not in ("seconds", "ts")}


def check_scan_cli(root: str, snapshot: str) -> None:
    """(b): ``cli.train --scan-steps 4`` (one group, run eagerly and captured)
    and ``--scan-steps 2`` (a capture and a replay) give the eager CLI's
    epoch under ``root``: its epoch record and its epoch snapshot, bit for
    bit."""
    from adnm_tpu_torch.cli import train as train_cli

    want = torch.load(snapshot, map_location="cpu", weights_only=True)
    for k in (4, 2):
        sub = os.path.join(root, f"scan{k}")
        out = train_cli.main([*TRAIN_ARGS, "--img-size", str(IMG), "--root", sub,
                              "--scan-steps", str(k)])
        got = torch.load(os.path.join(sub, os.path.relpath(snapshot, root)), map_location="cpu",
                         weights_only=True)
        same = epoch_record(sub) == epoch_record(root) and got["step"] == want["step"]
        same = same and all(torch.equal(v, got["params"][n]) for n, v in want["params"].items())
        same = same and all(torch.equal(v, got["opt_state"]["state"][i][e])
                            for i, st in want["opt_state"]["state"].items()
                            for e, v in st.items())
        if not same or out["trainer"].scan_steps != k:
            raise AssertionError(f"train CLI --scan-steps {k}: its epoch {epoch_record(sub)} "
                                 f"differs from the eager CLI's {epoch_record(root)}")
        shutil.rmtree(sub)
        print(f"train CLI --scan-steps {k}: {epoch_record(root)}; its epoch record and "
              f"snapshot bit-equal to the eager CLI's")


# the hand kernels' launches a forward, checked in a trace of a replay
FORWARD_LAUNCHES = {"duality": {"rms_norm": K1_PER_FORWARD},
                    "bimamba": {"rms_norm": K1_PER_FORWARD, "ssd_chunked_scan": K2_PER_FORWARD}}
# (label, predict.load_model options) of (c)'s graphed forwards
GRAPH_FORWARD_CASES = [("duality", {}), ("bimamba", BIMAMBA), ("MLA", MLA),
                       ("LAPS duality", {"dataset": "LAPS"}),
                       ("SmaATUnet", {"model_name": "SmaATUnet"}),
                       ("TrajGRU", {"model_name": "TrajGRU"}),
                       ("SwinUnet", {"model_name": "SwinUnet"})]


def check_graph_forwards(predict, counts) -> dict:
    """(c): ``forecast`` with the caller's ``GraphSet`` (the first call of a
    shape eager and captured, the second replayed) and with the default (a
    set for the call) against without graphs, at batch 1 and 4, bit for
    bit, with the same launches. For the models with hand kernels, a trace
    of a batch-4 replay runs the hand kernels of an eager forward, as many
    as the counters say (``FORWARD_LAUNCHES``). Returns each model's
    launches a graphed forward, from that trace where there is one."""
    from adnm_tpu_torch.utils.graphs import GraphSet

    rng = np.random.RandomState(5)
    dev = torch.device("cuda")
    per_forward = {}
    for label, kwargs in GRAPH_FORWARD_CASES:
        model = predict.load_model(None, dev, img_size=IMG, **kwargs)
        graphs = GraphSet(dev)
        for b in (1, 4):
            x = rng.rand(b, 5, 1, IMG, IMG).astype(np.float32)
            counts.reset()
            want = predict.forecast(model, x, b, dev, graphs=False)
            eager_counts = counts.read()
            for i, owned in enumerate((graphs, graphs, None)):
                counts.reset()
                got = predict.forecast(model, x, b, dev, graphs=owned)
                if not np.array_equal(got, want) or counts.read() != eager_counts:
                    raise AssertionError(f"graphed forward {label} batch {b} call {i}: max "
                                         f"diff {np.abs(got - want).max()}, launches "
                                         f"{counts.read()} against {eager_counts}")
        per_forward[label] = counts.read()
        traced = ""
        if label in FORWARD_LAUNCHES:
            replay = hand_kernel_names(lambda: predict.forecast(model, x, 4, dev, graphs=graphs))
            eager = hand_kernel_names(lambda: predict.forecast(model, x, 4, dev, graphs=False))
            want = {**NO_LAUNCHES, **FORWARD_LAUNCHES[label]}
            if replay != eager or trace_launches(replay) != want or per_forward[label] != want:
                raise AssertionError(f"graphed forward {label}: hand kernels of a replay "
                                     f"{replay}, of an eager forward {eager}; counted "
                                     f"{per_forward[label]}, want {want}")
            per_forward[label] = trace_launches(replay)
            traced = f"; trace of a batch-4 replay: {replay}"
        print(f"graphed forward {label}: batch 1 and 4, capture, replay and a call's own set "
              f"bit-equal to the eager forward; launches a forward {per_forward[label]}{traced}")
        del model, graphs
    return per_forward


def check_graph_clis(predict, root: str, snapshot: str) -> None:
    """(c): ``predict --ckpt --horizon 40`` (its second forward a replay)
    against the eager chain of the same weights, and ``validate`` at batch
    1 (three test clips: a capture, two replays) against the eager
    ``eval_epoch`` of its trainer."""
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.data.loader import BatchLoader
    from adnm_tpu_torch.data.shanghai import make_datasets

    x = os.path.join(root, "graph_x.npy")
    np.save(x, train_batch(1)[0, :5, 0])
    got = predict.main(["--input", x, "--img-size", str(IMG), "--ckpt", snapshot, "--horizon",
                        "40", "--output", os.path.join(root, "graph_y.npy")])
    model = predict.load_model(None, torch.device("cuda"), ckpt=snapshot)
    want = predict.forecast(model, np.load(x)[None, :, None], 4, torch.device("cuda"), 40,
                            graphs=False)
    if not np.array_equal(got, want):
        raise AssertionError(f"predict --horizon 40: graphed chain differs from the eager one "
                             f"by {np.abs(got - want).max()}")
    args = list(DATA_ARGS)
    args[args.index("--batch-size") + 1] = "1"
    val = validate_cli.main([*args, "--img-size", str(IMG), "--root", root, "--ckpt", snapshot])
    test = make_datasets(None, IMG, synthetic_len=SYNTHETIC_LEN)[2]
    loss, preds, _ = val["trainer"].eval_epoch(BatchLoader(test, 1, drop_last=False),
                                               collect=True, graphs=False)
    if not (np.array_equal(val["preds"], preds) and val["test_loss"] == loss):
        raise AssertionError("validate: graphed predictions differ from the eager ones")
    print(f"predict --ckpt --horizon 40 (a capture, a replay) and validate at batch 1 "
          f"({preds.shape[0]} clips: a capture, {preds.shape[0] - 1} replays): bit-equal to "
          f"their eager forwards")


def time_graph_forward(card: str, predict, label: str, kwargs: dict, inputs) -> None:
    """(d): batch-1 latency and batch-4 frames/s of the eager forward and of
    its graph replay (``GraphSet.run``: the input copied in, the output
    copied out), from one run; their busy share and kernels per forward, the
    peak memory and the capture's seconds."""
    from adnm_tpu_torch.utils.graphs import GraphSet

    device = torch.device("cuda")
    model = predict.load_model(None, device, img_size=IMG, **kwargs)
    graphs = GraphSet(device)
    with torch.inference_mode():
        for b in (1, 4):
            x = torch.from_numpy(inputs[f"batch{b}"]).to(device)
            key = ("forward", b)
            graphs.run(key, model, (x,))
            modes = {"eager": lambda: model(x), "graphed": lambda: graphs.run(key, model, (x,))}
            for mode, run in modes.items():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                times = host_times(run, 5 if b == 1 else 3, warm=0)  # warm: the capture's
                med = statistics.median(times)
                what = (f"latency median {med:.2f} ms, min {min(times):.2f} ms" if b == 1
                        else f"median {med:.2f} ms -> {4 * 20 / (med / 1e3):.1f} frames/s")
                print(f"[{card}] {label} {mode} forward batch {b}: {what}; peak allocated "
                      f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
                      f"{' besides the graph pool' if mode == 'graphed' else ''}")
                profile_device(run, card, f"{label} {mode} forward profile batch {b}",
                               "forward", 2, warm=0)
            print(f"[{card}] {label} forward batch {b}: capture "
                  f"{graphs.graphs[key].capture_s:.3f} s, graph pool "
                  f"{graphs.graphs[key].pool_bytes / 2**20:.1f} MiB")


def time_graph_steps(card: str, label: str, make, b: int, k: int = 2) -> None:
    """(d): the step median of eager ``train_step`` and of a graph replay of
    k steps (per step), from one run; busy share, kernels a step, the peak
    memory and the capture's seconds."""
    trainer = make(k)
    group = graph_groups(1, k, b, seed=4)[0]
    trainer.train_steps(group, LR, CLIP)  # eager, captured
    modes = {"eager": lambda: [trainer.train_step(x, LR, CLIP) for x in group],
             "graphed": lambda: trainer.train_steps(group, LR, CLIP)}
    for mode, run in modes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = [t / k for t in host_times(run, 3, warm=0)]  # warm: the capture's
        med = statistics.median(times)
        print(f"[{card}] train {label} {mode} batch {b}: step median {med:.2f} ms, min "
              f"{min(times):.2f} ms (3 groups of {k} steps) -> "
              f"{b * 20 / (med / 1e3):.1f} frames/s; peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
              f"{' besides the graph pool' if mode == 'graphed' else ''}")
        if mode == "graphed":  # the eager steps' trace is phase 6's and 6d's
            profile_device(run, card, f"train {label} {mode} profile batch {b}, a group of "
                           f"{k} steps", "group", 1, warm=0)
    captured = next(iter(trainer.graphs.graphs.values()))
    print(f"[{card}] train {label} batch {b}: capture of {k} steps {captured.capture_s:.3f} s, "
          f"graph pool {captured.pool_bytes / 2**20:.1f} MiB")


def single_dispatch_phase(predict, counts, card: str, inputs) -> dict:
    """Phase 6i: (a) graphed training steps, (c) graphed forwards, (d)
    times; (b) and the CLIs' part of (c) run in phase 5's directory
    (``check_scan_cli``, ``check_graph_clis``). Returns the hand kernels'
    launches per graphed step and forward."""
    t_phase = time.perf_counter()
    print(f"single dispatch phase on {card}")
    steps = {}
    for label, kind, options, b, k, remat, dtype in GRAPH_STEP_CASES:
        steps[label] = check_graph_steps(counts, label, kind, options, b, k, remat, dtype)
        torch.cuda.empty_cache()
    check_graph_epoch(counts)
    per_forward = check_graph_forwards(predict, counts)
    torch.cuda.empty_cache()
    for label, kwargs in (("duality", {}), ("bimamba", BIMAMBA),
                          ("TransUnet", {"model_name": "TransUnet"}),
                          ("SwinUnet", {"model_name": "SwinUnet"})):
        time_graph_forward(card, predict, label, kwargs, inputs)
        torch.cuda.empty_cache()
    duality = lambda k: graph_case_trainer("ADNMUnet", {}, k, False, torch.float32)  # noqa: E731
    for b in (1, 4):
        time_graph_steps(card, "duality", duality, b)
    for name in ("TrajGRU", "SwinUnet"):
        time_graph_steps(card, name, lambda k: graph_case_trainer(name, {}, k, False,
                                                                  torch.float32), 4)
        torch.cuda.empty_cache()
    print(f"single dispatch phase: {time.perf_counter() - t_phase:.1f} s")
    per_step = {n: v // steps["duality"]["k"]
                for n, v in steps["duality"]["launches_per_replay"].items()}
    per_step_scan = {n: v // steps["bimamba"]["k"]
                     for n, v in steps["bimamba"]["launches_per_replay"].items()}
    return {"step": per_step, "bimamba_step": per_step_scan, "forward": per_forward}


# -- multi-rank inference: validate, visualize and predict on a mesh ------------

# 64 synthetic clips: a test split of int(64 * 0.15) = 9 clips, batches of
# 4, 4 and a one-row tail, which leaves rank 0 of data=2 no rows.
MESH_ARGS = ["--synthetic", "--synthetic-len", "64", "--batch-size", "4", "--img-size", str(IMG)]
MESH_TEST_CLIPS = 9
MESH_TIMEOUT_S = 900
MESH_CASES = {"duality": {}, "bimamba": BIMAMBA}
# A rank's launches per forward on model=2: every Block norm (K1, on the
# replicated channels) and, on bimamba, both paths' scans over the rank's
# half of the heads (K2) run on every rank.
MESH_FORWARD_LAUNCHES = {"duality": {**NO_LAUNCHES, "rms_norm": K1_PER_FORWARD},
                         "bimamba": {**NO_LAUNCHES, "rms_norm": K1_PER_FORWARD,
                                     "ssd_chunked_scan": K2_PER_FORWARD}}
# model=2 against one process at batch 4, on one card: the heads' and
# hidden channels' partial products summed by the all-reduce instead of
# inside one GEMM, a change of summation order, which the seeded duality
# model amplifies about a hundredfold (its card-against-CPU bound,
# FORWARD_ATOL); nothing amplifies on bimamba.
MESH_ATOL = FORWARD_ATOL
# data=2 against one process: the same kernels on rows 2 at a time, against
# 4 (cuDNN and cuBLAS may choose other algorithms by batch, so the sums may
# run in other orders). The largest gaps read on an H100 were 8.3e-6
# (validate) and 2.4e-4 (predict); a row out of place moves the predictions
# by about 0.8 (one process's clips against their neighbours', printed).
MESH_DATA_ATOL = {"validate": 1e-4, "predict": 1e-3}


def mesh_batch(seed: int = 11) -> np.ndarray:
    return np.random.RandomState(seed).rand(4, 5, 1, IMG, IMG).astype(np.float32)


def mesh_ranks(rank: int, world: int, device, out: str, model_axis_only: bool) -> None:
    """A rank of phase 6j: (a) ``validate`` on data=2 and (c) ``predict`` on
    data=2, each through the CLI's per-rank ``run``; (b) ``forecast`` on
    model=2 of the duality and bimamba models at batch 4, with its launches
    counted and traced, its wall and the bytes its collectives sent. With
    ``model_axis_only``, (b) alone. Each part's wall and peak memory; every
    rank writes its results (rank 0 alone its evaluation)."""
    from adnm_tpu_torch.cli import predict as predict_cli
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.parallel import make_mesh
    from adnm_tpu_torch.parallel.tensor import TRAFFIC

    counts = kernel_counts()
    rec = {}

    def measured(label, run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        rec[f"{label}_wall_s"] = time.perf_counter() - t0
        rec[f"{label}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        return result

    if not model_axis_only:
        args = validate_cli.make_parser().parse_args(
            [*MESH_ARGS, "--root", os.path.join(out, "none")])
        res = measured("validate", lambda: validate_cli.run(
            args, mesh=make_mesh(2, device=device), device=device))
        rec["validate"] = {k: res[k] for k in ("metrics", "test_loss", "preds", "gts")}
        args = predict_cli.make_parser().parse_args(
            ["--input", os.path.join(out, "x.npy"), "--output", os.path.join(out, "mesh.npy"),
             "--img-size", str(IMG), "--root", os.path.join(out, "none")])
        measured("predict", lambda: predict_cli.run(args, mesh=make_mesh(2, device=device),
                                                    device=device))
    x = mesh_batch()
    mesh = make_mesh(1, model=2, device=device)
    for label, kwargs in MESH_CASES.items():
        model = predict_cli.load_model(None, device, **kwargs)
        counts.reset()
        TRAFFIC.update(model=0, data=0, seq=0)
        got = measured(label, lambda: predict_cli.forecast(model, x, 4, device, mesh=mesh))
        rec[label] = {"preds": got, "launches": counts.read(), "traffic": dict(TRAFFIC)}
        names = hand_kernel_names(lambda: predict_cli.forecast(model, x, 4, device, mesh=mesh))
        rec[label].update(names=names, traced=trace_launches(names),
                          wall_ms=host_times(lambda: predict_cli.forecast(model, x, 4, device,
                                                                          mesh=mesh), 3, warm=0))
        del model
        torch.cuda.empty_cache()
    if rank:  # rank 0's evaluation is the one compared
        rec.pop("validate", None)
    torch.save(rec, os.path.join(out, f"mesh_rank{rank}.pt"))


def row_shift_gap(preds: np.ndarray) -> float:
    """How far the predictions move when each clip takes its neighbour's
    place: what a misassembled gather of rows would show."""
    return float(np.abs(preds - np.roll(preds, 1, axis=0)).max())


def check_mesh_model_axis(card: str, ranks: list, refs: dict, one: dict, backend: str) -> dict:
    """(b): each rank's predictions on model=2 against one process's
    (``refs``; ``one``: its eager wall and peak), the same on both ranks,
    and each rank's launches, counted and traced."""
    res = {}
    for label in MESH_CASES:
        a, b = ranks[0][label], ranks[1][label]
        err = float(np.abs(a["preds"] - refs[label]).max())
        want = MESH_FORWARD_LAUNCHES[label]
        launches = [(r[label]["launches"], r[label]["traced"]) for r in ranks]
        print(f"[{card}] forecast {label} {IMG}^2 batch 4 on model=2 ({backend}): against one "
              f"process max_abs_err {err:.3e} (tol {MESH_ATOL[label]:g}); launches per rank "
              f"(counted, traced) {launches}, want {want}; bytes sent per rank and forward "
              f"{[r[label]['traffic'] for r in ranks]}; wall per forward, rank 0 "
              f"{statistics.median(a['wall_ms']):.1f} ms, rank 1 "
              f"{statistics.median(ranks[1][label]['wall_ms']):.1f} ms (median of 3) against "
              f"{one[label]['wall_ms']:.1f} ms eager in one process; first call "
              f"{ranks[0][label + '_wall_s']:.2f} s; peak memory per rank "
              f"{[round(r[label + '_peak_mib'], 1) for r in ranks]} MiB against "
              f"{one[label]['peak_mib']:.1f} MiB in one process")
        if not (err <= MESH_ATOL[label] and np.isfinite(a["preds"]).all()
                and np.array_equal(a["preds"], b["preds"])):
            raise AssertionError(f"mesh {label}: model=2 disagrees with one process")
        if any(c != want or t != want for c, t in launches):
            raise AssertionError(f"mesh {label}: a rank did not run the hand kernels, "
                                 f"{launches}")
        res[label] = {"max_abs_err": err, "launches_per_rank": [c for c, _ in launches],
                      "bytes_per_rank": ranks[0][label]["traffic"]["model"],
                      "wall_ms": statistics.median(a["wall_ms"]),
                      "peak_mib": [r[label + "_peak_mib"] for r in ranks], "one": one[label]}
    return res


def mesh_inference_phase(card: str) -> dict:
    """Multi-rank inference (phase 6j), full width, 256^2, seeded weights,
    fp32, two gloo ranks sharing the card (``parallel.spawn``): (a)
    ``validate`` on data=2 against one process (predictions, test loss, the
    printed table; the test split's tail leaves rank 0 no rows), (b)
    ``forecast`` on model=2 of the duality and bimamba models at batch 4
    against one process, with each rank's K1 and K2 launches counted and
    traced, (c) ``predict`` on data=2 against one process; with two or more
    cards, (b) again over NCCL, a card a rank."""
    from adnm_tpu_torch.cli import predict as predict_cli
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.data.shanghai import ShanghaiDataset
    from adnm_tpu_torch.metrics import metrics_table
    from adnm_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    device = torch.device("cuda")
    res = {}
    with tempfile.TemporaryDirectory(prefix="adnm-mesh-") as out:
        none = os.path.join(out, "none")  # no checkpoint: the seeded init
        t0 = time.perf_counter()
        single = validate_cli.main([*MESH_ARGS, "--root", none])
        single_wall = time.perf_counter() - t0
        test = ShanghaiDataset(None, IMG, "test", synthetic_len=64)
        x = np.stack([test[i][:5] for i in range(len(test))])[:, :, None]  # 9 clips' inputs
        np.save(os.path.join(out, "x.npy"), x)
        predict_cli.main(["--input", os.path.join(out, "x.npy"), "--output",
                          os.path.join(out, "one.npy"), "--img-size", str(IMG), "--root", none])
        refs, one = {}, {}  # one process's eager predictions, and its wall and peak
        for label, kwargs in MESH_CASES.items():
            model = predict_cli.load_model(None, device, **kwargs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            refs[label] = predict_cli.forecast(model, mesh_batch(), 4, device, graphs=False)
            torch.cuda.synchronize()
            one[label] = {"peak_mib": torch.cuda.max_memory_allocated() / 2**20, "wall_ms": (
                statistics.median(host_times(lambda: predict_cli.forecast(
                    model, mesh_batch(), 4, device, graphs=False), 3, warm=0)))}
            del model
        del single["trainer"]
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        spawn(mesh_all_ranks, 2, args=(out,), device="cuda", backend="gloo",
              shared_device=True, timeout_s=MESH_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(out, f"mesh_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        # phases 6k's and 6l's records, checked by their phases
        for part in ("seq", "train", "walls"):
            res[f"{part}_ranks"] = [torch.load(os.path.join(out, f"{part}_rank{r}.pt"),
                                               weights_only=False) for r in range(2)]
        got = ranks[0]["validate"]
        err = float(np.abs(got["preds"] - single["preds"]).max())
        same = np.array_equal(got["preds"], single["preds"])
        tables = (metrics_table(got["metrics"], pod=True),
                  metrics_table(single["metrics"], pod=True))
        shift = row_shift_gap(single["preds"])
        print(f"[{card}] validate --mesh data=2 (two gloo ranks on one card) against one "
              f"process: {got['preds'].shape[0]} clips, predictions max_abs_err {err:.3e} "
              f"(tol {MESH_DATA_ATOL['validate']:g}; a row out of place: {shift:.3e})"
              f"{', bit-equal' if same else ''}; test loss "
              f"{got['test_loss']:.8f} vs {single['test_loss']:.8f}; tables "
              f"{'identical' if tables[0] == tables[1] else 'DIFFER'}; wall per rank "
              f"{[round(r['validate_wall_s'], 2) for r in ranks]} s against {single_wall:.2f} s "
              f"(one process, graphed); peak memory per rank "
              f"{[round(r['validate_peak_mib'], 1) for r in ranks]} MiB")
        print(tables[0])
        if (got["preds"].shape != (MESH_TEST_CLIPS, 20, IMG, IMG)
                or not err <= MESH_DATA_ATOL["validate"] < shift
                or not np.array_equal(got["gts"], single["gts"])):
            raise AssertionError("validate on data=2 disagrees with one process")
        if abs(got["test_loss"] - single["test_loss"]) > 1e-4 * abs(single["test_loss"]):
            raise AssertionError("validate on data=2: the test loss disagrees")
        check_metrics("validate --mesh data=2", got["metrics"])
        if same and tables[0] != tables[1]:
            raise AssertionError("validate on data=2: bit-equal predictions, other table")
        mesh_pred, one_pred = (np.load(os.path.join(out, f"{n}.npy")) for n in ("mesh", "one"))
        perr = float(np.abs(mesh_pred - one_pred).max())
        pshift = row_shift_gap(one_pred)
        print(f"[{card}] predict --mesh data=2 against one process on the {len(x)} test clips: "
              f"max_abs_err {perr:.3e} (tol {MESH_DATA_ATOL['predict']:g}; a row out of place: "
              f"{pshift:.3e}); wall per rank "
              f"{[round(r['predict_wall_s'], 2) for r in ranks]} s, peak memory per rank "
              f"{[round(r['predict_peak_mib'], 1) for r in ranks]} MiB")
        if mesh_pred.shape != one_pred.shape or not perr <= MESH_DATA_ATOL["predict"] < pshift:
            raise AssertionError("predict on data=2 disagrees with one process")
        res["gloo"] = check_mesh_model_axis(card, ranks, refs, one, "gloo, one card")
        res["validate"] = {"max_abs_err": err, "bit_equal": same,
                           "wall_s": [r["validate_wall_s"] for r in ranks],
                           "single_wall_s": single_wall}
        # one process's forwards and validate, which phase 6k compares with too
        res["one_process"] = {"refs": refs, "one": one, "validate": single,
                              "validate_wall_s": single_wall}
        print(f"multi-rank inference: two gloo ranks on one card in {spawn_s:.1f} s, "
              f"6j's, 6k's and 6l's rank work in one spawn (rank 0's walls "
              f"{ {k: round(v, 1) for k, v in res['walls_ranks'][0].items()} } s)")
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            spawn(mesh_ranks, 2, args=(out, True), device="cuda", timeout_s=MESH_TIMEOUT_S)
            ranks = [torch.load(os.path.join(out, f"mesh_rank{r}.pt"), weights_only=False)
                     for r in range(2)]
            res["nccl"] = check_mesh_model_axis(card, ranks, refs, one, "NCCL, a card a rank")
        else:
            print(f"multi-rank inference: {n_cards} card visible: (b) over NCCL across cards "
                  f"not run")
    print(f"[{card}] multi-rank inference phase: {time.perf_counter() - t_phase:.1f} s")
    return res


# -- the mesh's 'seq' axis: validate and forecast with a band of rows a rank ------

# seq=2 against one process at batch 4 on one card: the InstanceNorm and
# GroupNorm statistics, the duality's K^T V and K2's state summed over two
# bands instead of inside one kernel, a change of summation order that the
# seeded duality model amplifies (FORWARD_ATOL is its card-against-CPU
# bound). Set before the phase's first chip run from
# ``scripts/torch_seq_distance.py`` on the CPU at 64^2, batch 2: 2.1e-5
# (duality) and 6.0e-7 (bimamba); the bounds are about 240 and 170 times
# those.
SEQ_ATOL = FORWARD_ATOL
# validate on data=1,seq=2 against one process (the duality model's
# predictions over the synthetic test split): 7.5e-6 on an H100, and the
# 'data' axis's bound (MESH_DATA_ATOL) holds it; a halo not exchanged or a
# K2 state not carried moves a forward by far more (PERF.md §6)
SEQ_VALIDATE_ATOL = 1e-4
# K2's carried form at the refiner's half on seq=2: (batch, heads, L),
# timed at batch 1 and held against its plain version at the main path's
# batch 4
K2_SEGMENT = (1, 8, 32768)
K2_RANK_SEGMENT = (4, 8, 32768)


def seq_ranks(rank: int, world: int, device, out: str) -> None:
    """A rank of phase 6k on ('data', 'seq') = (1, 2), holding its band of
    rows: (1) ``forecast`` of the duality and bimamba models at batch 4,
    its launches counted and traced, the bytes it sent over 'seq', its
    wall and peak memory; (2) ``validate`` through the CLI's per-rank
    ``run``. Every rank writes its results (rank 0 alone its evaluation)."""
    from adnm_tpu_torch.cli import predict as predict_cli
    from adnm_tpu_torch.cli import validate as validate_cli
    from adnm_tpu_torch.parallel import make_mesh
    from adnm_tpu_torch.parallel.tensor import TRAFFIC

    counts = kernel_counts()
    mesh = make_mesh(1, 2, device=device)
    rec = {}

    def measured(label, run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        rec[f"{label}_wall_s"] = time.perf_counter() - t0
        rec[f"{label}_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        return result

    x = mesh_batch()
    for label, kwargs in MESH_CASES.items():
        model = predict_cli.load_model(None, device, **kwargs)
        counts.reset()
        TRAFFIC.update(model=0, data=0, seq=0)
        got = measured(label, lambda: predict_cli.forecast(model, x, 4, device, mesh=mesh))
        rec[label] = {"preds": got, "launches": counts.read(), "traffic": dict(TRAFFIC)}
        names = hand_kernel_names(lambda: predict_cli.forecast(model, x, 4, device, mesh=mesh))
        rec[label].update(names=names, traced=trace_launches(names),
                          wall_ms=host_times(lambda: predict_cli.forecast(model, x, 4, device,
                                                                          mesh=mesh), 3, warm=0))
        del model
        torch.cuda.empty_cache()
    args = validate_cli.make_parser().parse_args(
        [*MESH_ARGS, "--root", os.path.join(out, "none")])
    res = measured("validate", lambda: validate_cli.run(args, mesh=mesh, device=device))
    if rank == 0:
        rec["validate"] = {k: res[k] for k in ("metrics", "test_loss", "preds", "gts")}
    torch.save(rec, os.path.join(out, f"seq_rank{rank}.pt"))


def k2_carried_against_plain(ssd, args, s0, reverse: bool, label: str) -> float:
    """A ``ScanSegment`` on the card (K2's states, carry and outputs
    launches) against the plain version on the same inputs: its outputs
    from the incoming state ``s0`` (within K2_TOL, bf16 within one more
    bf16 step), its end state and decay from zero, and that state plus
    ``s0`` decayed across the segment against the plain end state from
    ``s0`` (fp32 states, within K2_TOL). The outputs' max_abs_err."""
    rtol, atol = K2_TOL
    flip = (lambda t: t.flip(-1)) if reverse else (lambda t: t)
    x, dt, A, B, C, D = args
    step = BF16_STEP if x.dtype == torch.bfloat16 else 0.0
    seg = ssd.ScanSegment(*args, K2_CHUNK, reverse=reverse)
    got = seg.outputs(s0).float()
    scan_order = (flip(x), flip(dt), A, flip(B), flip(C), D)
    want, state, decay = ssd.ssd_chunked_scan_reference(*scan_order, K2_CHUNK, initial_state=s0,
                                                        return_final_state=True)
    _, zero_state, zero_decay = ssd.ssd_chunked_scan_reference(*scan_order, K2_CHUNK,
                                                               return_final_state=True)
    want = flip(want).float()
    err = (got - want).abs()

    def close(a, b, rt, at):
        return bool(((a - b).abs() <= at + rt * b.abs()).all())

    carried = seg.state + s0 * seg.decay[..., None, None]
    if not close(got, want, rtol + step, atol):
        raise AssertionError(f"{label}: the outputs from an incoming state disagree with the "
                             f"plain version, max_abs_err {err.max().item():.3e}")
    if not (close(seg.state, zero_state, rtol, atol) and close(seg.decay, zero_decay, rtol, 1e-30)
            and close(carried, state, rtol, atol)):
        raise AssertionError(f"{label}: the end state or decay disagrees with the plain "
                             f"version, state {(seg.state - zero_state).abs().max().item():.3e}, "
                             f"decay {(seg.decay - zero_decay).abs().max().item():.3e}")
    print(f"{label}: from an incoming state against the plain version max_abs_err "
          f"{err.max().item():.3e} (tol {atol:g} + {rtol:g}{' + 2^-7' if step else ''})*|want|; "
          f"end state {(carried - state).abs().max().item():.3e}, decay "
          f"{(seg.decay - zero_decay).abs().max().item():.3e} (tol {atol:g} + {rtol:g}*|want|)")
    return err.max().item()


def check_k2_carried(ssd, card: str) -> dict:
    """K2's carried form on the card: against its plain version from a
    random incoming state (``k2_carried_against_plain``) at the shape the
    main path gives a rank at batch 4 on seq=2, (4, 8, 32,768), at the
    model's decays and at |dA| ~ 3e-4, fp32 and bf16, forward and
    reversed; against the whole scan: the sequence cut into 2 and 4
    segments, each from the state its predecessors hand it in the scan's
    direction, forward and reversed, at the model's decays and at
    |dA| ~ 3e-4 over many chunks (where the carried state moves the later
    segments far beyond the bound), fp32 and bf16 (bf16 within one more
    bf16 step); without a state two calls bit-equal and, at the refiner's
    many tiles, the carried form from a zero state bit-equal to them; the
    carried form timed with and without an incoming state at
    ``K2_SEGMENT`` beside its bound, its output held against the plain
    version. The bits of the call without a state against the parent
    commit's kernel: ``scripts/torch_parent_bits.py``."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    rtol, atol = K2_TOL
    worst = 0.0
    b, h, l = K2_RANK_SEGMENT
    for carry in (False, True):
        args32 = scan_inputs(b, h, l, gen, carry)
        s0 = torch.randn(b, h, K2_N, K2_P, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            for reverse in (False, True):
                err = k2_carried_against_plain(
                    ssd, [t.to(dtype) for t in args32], s0, reverse,
                    f"K2 carried {K2_RANK_SEGMENT} {'small|dA| ' if carry else ''}{dtype}"
                    f"{' reverse' if reverse else ''}")
                worst = max(worst, err) if dtype == torch.float32 else worst
    for b, h, l, carry in ((1, 8, 65536, True), (1, 8, 65536, False), (2, 8, 4096, True)):
        args32 = scan_inputs(b, h, l, gen, carry)
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in args32]
            step = BF16_STEP if dtype == torch.bfloat16 else 0.0
            for reverse in (False, True):
                whole = ssd.ssd_chunked_scan(*args, K2_CHUNK, reverse=reverse).float()
                for parts in (2, 4):
                    cut = l // parts
                    segs = [ssd.ScanSegment(*(t[..., i * cut:(i + 1) * cut].contiguous()
                                              if t.dim() > 1 else t for t in args),
                                            K2_CHUNK, reverse=reverse) for i in range(parts)]
                    states = [(g.state, g.decay) for g in segs]
                    got = torch.cat([g.outputs(ssd.compose_states(states, reverse, i))
                                     for i, g in enumerate(segs)], dim=-1).float()
                    err = (got - whole).abs()
                    alone = torch.cat([g.outputs(torch.zeros_like(g.state)) for g in segs],
                                      dim=-1).float()
                    moved = float((alone - whole).abs().max())
                    label = (f"K2 carried b={b} heads={h} L={l} in {parts} segments "
                             f"{'small|dA| ' if carry else ''}{dtype}"
                             f"{' reverse' if reverse else ''}")
                    if not bool((err <= atol + (rtol + step) * whole.abs()).all()):
                        raise AssertionError(f"{label}: the chained segments disagree with "
                                             f"the whole scan, max_abs_err "
                                             f"{err.max().item():.3e}")
                    if carry and not moved > 100 * atol:
                        raise AssertionError(f"{label}: the carried state moves nothing "
                                             f"({moved:.3e})")
                    worst = max(worst, err.max().item()) if dtype == torch.float32 else worst
                    if parts == 2:
                        print(f"{label}: against the whole scan max_abs_err "
                              f"{err.max().item():.3e} (tol {atol:g} + {rtol:g}"
                              f"{' + 2^-7' if step else ''})*|whole|; without the carried "
                              f"state {moved:.3e}")
    # without a state: the unchanged entry, one launch; a zero state's bits
    for dtype in (torch.float32, torch.bfloat16):
        args = [t.to(dtype) for t in scan_inputs(1, 8, 65536, gen)]
        for reverse in (False, True):
            before = ssd.ssd_chunked_scan.launches
            plain = ssd.ssd_chunked_scan(*args, K2_CHUNK, reverse=reverse)
            again = ssd.ssd_chunked_scan(*args, K2_CHUNK, reverse=reverse)
            zero = ssd.ScanSegment(*args, K2_CHUNK, reverse=reverse).outputs(
                torch.zeros(1, 8, K2_N, K2_P, device="cuda"))
            torch.cuda.synchronize()
            if ssd.ssd_chunked_scan.launches != before + 3 or not (
                    torch.equal(plain, again) and torch.equal(plain, zero)):
                raise AssertionError(f"K2 {dtype} reverse={reverse}: the call without a state "
                                     f"is not one launch bit-equal to itself and to the "
                                     f"carried form from a zero state")
    print("K2 without a state at (1, 8, 65536): one launch, bit-equal across calls and to the "
          "carried form from a zero state, fp32 and bf16, forward and reversed")
    b, h, l = K2_SEGMENT
    x, dt, A, B, C, D = scan_inputs(b, h, l, gen)
    s0 = torch.randn(b, h, K2_N, K2_P, generator=gen, device="cuda")
    worst = max(worst, k2_carried_against_plain(ssd, (x, dt, A, B, C, D), s0, False,
                                                f"K2 carried {K2_SEGMENT} timed, fp32"))
    with_ms, plain_ms, _ = in_turns(
        lambda: ssd.ScanSegment(x, dt, A, B, C, D, K2_CHUNK).outputs(s0),
        lambda: ssd.ssd_chunked_scan(x, dt, A, B, C, D, K2_CHUNK), iters=20, plain_iters=20)
    bnd, by = bound_ms(k2_bytes(b, h, K2_P, K2_N, l), k2_flops(b, h, K2_P, K2_N, l))
    print(f"[{card}] K2 at {K2_SEGMENT} (the refiner's half on seq=2), fp32: with an incoming "
          f"state (states, carry, outputs) {with_ms * 1e3:.2f} us, without one "
          f"{plain_ms * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by}; with / bound "
          f"{with_ms / bnd:.1f}, without / bound {plain_ms / bnd:.1f})")
    return {"max_abs_err": worst, "ms": with_ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "shape": list(K2_SEGMENT)}


# K2's whole-scan backward at (1, 8, 65,536), fp32, as PERF.md section 6
# records it (NVIDIA H100 80GB HBM3, 700.00 W): printed beside the carried
# backward's time at the refiner's half.
K2_BWD_WHOLE_US = 85.66


def k2_carried_backward_against_plain(ssd, args, dy, s0, lam, reverse: bool, label: str,
                                      chunk: int = K2_CHUNK) -> float:
    """K2's carried backward on the card (``SegmentBackward``: its first
    phase, the adjoint leaving the segment from dy alone, then the
    gradients from the entering state ``s0`` and adjoint ``lam``) against
    the plain versions on the same inputs: the six gradients within
    K2's backward bounds (bf16 within one more bf16 step), dS0 and the
    first phase's adjoint within K2B_TOL (fp32 both). The six gradients'
    fp32 max_abs_err (for bf16 inputs, that of the fp32 values)."""
    rtol, atol = K2B_TOL
    x = args[0]
    step = BF16_STEP if x.dtype == torch.bfloat16 else 0.0
    bwd = ssd.SegmentBackward(*args, dy, chunk, reverse=reverse)
    got = bwd.grads(s0, lam)
    torch.cuda.synchronize()
    want = ssd.ssd_chunked_scan_backward_reference(*args, dy, chunk, reverse,
                                                   initial_state=s0, final_state_grad=lam)
    adjoint = ssd.ssd_segment_adjoint_reference(*args, dy, chunk, reverse)
    terms = k2_grad_terms(*args, dy, want)
    worst, errs = 0.0, []
    for name, g, w in zip((*K2B_NAMES, "dS0", "adjoint"), (*got, bwd.adjoint),
                          (*want, adjoint)):
        g, w = g.float(), w.float()
        e = (g - w).abs()
        if name in terms:
            ok = bool((e <= K2B_SUM_RTOL * terms[name] + step * w.abs() + 1e-6).all())
        elif name in K2B_NAMES:
            ok = bool((e <= (rtol + step) * w.abs() + atol * w.abs().max()).all())
        else:  # fp32 records
            ok = bool((e <= rtol * w.abs() + atol * w.abs().max()).all())
        if not ok:
            raise AssertionError(f"{label}: {name} disagrees with the plain version, "
                                 f"max_abs_err {e.max().item():.3e}")
        errs.append(f"{name} {e.max().item():.2e}")
        if name in K2B_NAMES:
            worst = max(worst, e.max().item())
    print(f"{label}: against the plain version max_abs_err " + ", ".join(errs))
    return worst


def chained_backward(ssd, args, dy, parts: int, reverse: bool):
    """The backward of a sequence cut into ``parts`` segments, each by K2's
    carried backward from the state its predecessors hand it and the
    adjoint its successors hand it in the scan's direction: (dx, ddt, dA,
    dB, dC, dD) of the whole, dA and dD summed over the segments, and the
    same with no state or adjoint carried."""
    l = args[0].shape[-1]
    cut = l // parts
    pieces = [[t[..., i * cut:(i + 1) * cut].contiguous() if t.dim() > 1 else t
               for t in (*args, dy)] for i in range(parts)]
    segs = [ssd.ScanSegment(*p[:6], K2_CHUNK, reverse=reverse) for p in pieces]
    bwds = [ssd.SegmentBackward(*p, K2_CHUNK, reverse=reverse) for p in pieces]
    states = [(s.state, s.decay) for s in segs]
    adjoints = [(b.adjoint, s.decay) for b, s in zip(bwds, segs)]
    out = []
    for carried in (True, False):
        grads = []
        for i, b in enumerate(bwds):
            s0 = ssd.compose_states(states, reverse, i)
            lam = ssd.compose_states(adjoints, not reverse, i)
            grads.append(b.grads(s0 if carried else torch.zeros_like(s0),
                                 lam if carried else torch.zeros_like(lam)))
        out.append([torch.cat([g[j] for g in grads], dim=-1) if j not in (2, 5)
                    else sum(g[j].float() for g in grads) for j in range(6)])
    return out


def check_k2_carried_backward(ssd, card: str) -> dict:
    """K2's carried backward on the card: against its plain version from a
    random entering state S0 and adjoint lambda
    (``k2_carried_backward_against_plain``) at the shapes the main path
    gives a rank on seq=2, (4, 8, 32,768) and (1, 8, 32,768), at the
    model's decays and at |dA| ~ 3e-4, fp32 and bf16, forward and
    reversed; chained over 2 and 4 segments against the whole scan's
    backward kernel, at |dA| ~ 3e-4 over many chunks (where the carried
    state and adjoint move the gradients far beyond the bound) and at the
    model's decays, fp32; from S0 = lambda = 0 bit-equal to K2's backward
    kernel, fp32 and bf16, both directions; timed at (1, 8, 32,768) and
    (4, 8, 32,768) with and without the boundary terms beside its bound and
    the plain version, and the whole scan's backward at 65,536 tokens."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    rtol, atol = K2B_TOL
    worst = 0.0
    for b, h, l in (K2_RANK_SEGMENT, K2_SEGMENT):
        for carry in (False, True):
            x, dt, A, B, C, D = scan_inputs(b, h, l, gen, carry)
            dy = torch.randn(b, h, K2_P, l, generator=gen, device="cuda")
            s0, lam = (torch.randn(b, h, K2_N, K2_P, generator=gen, device="cuda")
                       for _ in range(2))
            for dtype in (torch.float32, torch.bfloat16):
                for reverse in (False, True):
                    err = k2_carried_backward_against_plain(
                        ssd, [t.to(dtype) for t in (x, dt, A, B, C, D)], dy.to(dtype), s0, lam,
                        reverse, f"K2 carried backward {(b, h, l)} "
                        f"{'small|dA| ' if carry else ''}{dtype}{' reverse' if reverse else ''}")
                    worst = max(worst, err) if dtype == torch.float32 else worst
    for b, h, l, carry in ((2, 8, 4096, True), (1, 8, 65536, True), (1, 8, 65536, False)):
        args = scan_inputs(b, h, l, gen, carry)
        dy = torch.randn(b, h, K2_P, l, generator=gen, device="cuda")
        for reverse in (False, True):
            whole = ssd.ssd_chunked_scan_backward(*args, dy, K2_CHUNK, reverse)
            terms = k2_grad_terms(*args, dy, whole)
            for parts in (2, 4):
                got, alone = chained_backward(ssd, args, dy, parts, reverse)
                label = (f"K2 carried backward b={b} heads={h} L={l} in {parts} segments "
                         f"{'small|dA| ' if carry else ''}{' reverse' if reverse else ''}")
                errs, moved = [], 0.0
                for name, g, a, w in zip(K2B_NAMES, got, alone, whole):
                    e = (g.float() - w.float()).abs()
                    if name in terms:
                        ok = bool((e <= K2B_SUM_RTOL * terms[name] + 1e-6).all())
                    else:
                        ok = bool((e <= rtol * w.abs() + atol * w.abs().max()).all())
                        moved = max(moved, float((a - w).abs().max() / w.abs().max()))
                    if not ok:
                        raise AssertionError(f"{label}: {name} of the chained segments "
                                             f"disagrees with the whole scan's backward, "
                                             f"max_abs_err {e.max().item():.3e}")
                    errs.append(f"{name} {e.max().item():.2e}")
                    worst = max(worst, e.max().item())
                if carry and not moved > 100 * atol:
                    raise AssertionError(f"{label}: the carried state and adjoint move "
                                         f"nothing ({moved:.3e})")
                print(f"{label}: against the whole scan's backward kernel max_abs_err "
                      + ", ".join(errs) + f"; without the carried state and adjoint "
                      f"{moved:.3e} of max |whole|")
    for b, h, l in ((1, 8, 65536), K2_SEGMENT, (2, 8, 1024)):
        for dtype in (torch.float32, torch.bfloat16):
            args = [t.to(dtype) for t in scan_inputs(b, h, l, gen)]
            dy = torch.randn(b, h, K2_P, l, generator=gen, device="cuda").to(dtype)
            zero = torch.zeros(b, h, K2_N, K2_P, device="cuda")
            for reverse in (False, True):
                plain = ssd.ssd_chunked_scan_backward(*args, dy, K2_CHUNK, reverse)
                before = ssd.SegmentBackward.launches
                carried = ssd.SegmentBackward(*args, dy, K2_CHUNK, reverse=reverse).grads(
                    zero, zero)
                torch.cuda.synchronize()
                if ssd.SegmentBackward.launches != before + 1 or not all(
                        torch.equal(p, c) for p, c in zip(plain, carried[:6])):
                    raise AssertionError(f"K2 carried backward {(b, h, l)} {dtype} reverse="
                                         f"{reverse}: from a zero state and adjoint, not the "
                                         f"backward kernel's bits")
    print("K2 carried backward from S0 = lambda = 0 at (1, 8, 65536), (1, 8, 32768) and "
          "(2, 8, 1024): bit-equal to K2's backward kernel, fp32 and bf16, forward and "
          "reversed")
    timing = {}
    for b, h, l in (K2_SEGMENT, K2_RANK_SEGMENT):
        args = scan_inputs(b, h, l, gen)
        dy = torch.randn(b, h, K2_P, l, generator=gen, device="cuda")
        s0, lam = (torch.randn(b, h, K2_N, K2_P, generator=gen, device="cuda")
                   for _ in range(2))
        zero = torch.zeros_like(s0)
        ms, plain_ms, _ = in_turns(
            lambda: ssd.SegmentBackward(*args, dy, K2_CHUNK).grads(s0, lam),
            lambda: ssd.ssd_chunked_scan_backward_reference(
                *args, dy, K2_CHUNK, initial_state=s0, final_state_grad=lam),
            iters=20, plain_iters=3)
        zero_ms = device_ms(lambda: ssd.SegmentBackward(*args, dy, K2_CHUNK).grads(zero, zero),
                            iters=20)
        whole_ms = device_ms(lambda: ssd.ssd_chunked_scan_backward(*args, dy, K2_CHUNK),
                             iters=20)
        bnd, by = bound_ms(k2_bwd_bytes(b, h, K2_P, K2_N, l), k2_bwd_flops(b, h, K2_P, K2_N, l))
        print(f"[{card}] K2 carried backward at {(b, h, l)}, fp32: with S0 and lambda "
              f"{ms * 1e3:.2f} us, from zero {zero_ms * 1e3:.2f} us (both phases), K2's backward "
              f"kernel on the segment {whole_ms * 1e3:.2f} us, plain version "
              f"{plain_ms * 1e3:.2f} us, bound {bnd * 1e3:.2f} us ({by}; kernel / bound "
              f"{ms / bnd:.1f}); the whole scan's backward at (1, 8, 65536) "
              f"{K2_BWD_WHOLE_US:.2f} us (PERF.md)")
        timing[(b, h, l)] = {"ms": ms, "zero_ms": zero_ms, "plain_ms": plain_ms,
                             "backward_ms": whole_ms, "bound_ms": bnd, "bound_by": by}
    return {"max_abs_err": worst, "timing": timing}


def mesh_seq_phase(card: str, one_process: dict, ranks: list) -> dict:
    """The mesh's 'seq' axis (phase 6k), full width, 256^2, seeded weights,
    fp32, two gloo ranks sharing the card (``parallel.spawn``), each
    holding its band of rows: (1) ``forecast`` of the duality and bimamba
    models at batch 4 on seq=2 against one process's (``one_process``:
    phase 6j's forwards, walls and peaks), the two ranks bit-equal, each
    rank's K1 and K2 launches counted and traced, its bytes sent over
    'seq', its wall and peak memory against one process's; (2)
    ``validate`` on data=1,seq=2 against phase 6j's one process: the same
    table, the loss within 1e-4 relative; (3) K2's carried form
    (``check_k2_carried``). ``ranks``: the two ranks' records of (1) and (2)
    (``seq_ranks``, run in phase 6j's spawn)."""
    from adnm_tpu_torch.metrics import metrics_table
    from adnm_tpu_torch.ops import ssd

    t_phase = time.perf_counter()
    refs, one, single = one_process["refs"], one_process["one"], one_process["validate"]
    res = {"k2_carried": check_k2_carried(ssd, card)}
    for label in MESH_CASES:
        a, b = ranks[0][label], ranks[1][label]
        err = float(np.abs(a["preds"] - refs[label]).max())
        want = MESH_FORWARD_LAUNCHES[label]
        launches = [(r[label]["launches"], r[label]["traced"]) for r in ranks]
        print(f"[{card}] forecast {label} {IMG}^2 batch 4 on seq=2 (gloo, one card; a band of "
              f"{IMG // 2} rows a rank): against one process max_abs_err {err:.3e} (tol "
              f"{SEQ_ATOL[label]:g}); launches per rank (counted, traced) {launches}, want "
              f"{want}; bytes sent per rank and forward over 'seq' "
              f"{[r[label]['traffic']['seq'] for r in ranks]}; wall per forward, rank 0 "
              f"{statistics.median(a['wall_ms']):.1f} ms, rank 1 "
              f"{statistics.median(b['wall_ms']):.1f} ms (median of 3) against "
              f"{one[label]['wall_ms']:.1f} ms eager in one process; first call "
              f"{ranks[0][label + '_wall_s']:.2f} s; peak memory per rank "
              f"{[round(r[label + '_peak_mib'], 1) for r in ranks]} MiB against "
              f"{one[label]['peak_mib']:.1f} MiB in one process")
        if not (err <= SEQ_ATOL[label] and np.isfinite(a["preds"]).all()
                and np.array_equal(a["preds"], b["preds"])):
            raise AssertionError(f"seq {label}: seq=2 disagrees with one process")
        if any(c != want or t != want for c, t in launches):
            raise AssertionError(f"seq {label}: a rank did not run the hand kernels, "
                                 f"{launches}")
        if any(r[label]["traffic"]["model"] or r[label]["traffic"]["data"]
               or not r[label]["traffic"]["seq"] for r in ranks):
            raise AssertionError(f"seq {label}: bytes went over another axis than 'seq'")
        res[label] = {"max_abs_err": err, "launches_per_rank": [c for c, _ in launches],
                      "bytes_per_rank": [r[label]["traffic"]["seq"] for r in ranks],
                      "wall_ms": statistics.median(a["wall_ms"]),
                      "peak_mib": [r[label + "_peak_mib"] for r in ranks], "one": one[label]}
    got = ranks[0]["validate"]
    verr = float(np.abs(got["preds"] - single["preds"]).max())
    tables = (metrics_table(got["metrics"], pod=True), metrics_table(single["metrics"], pod=True))
    shift = row_shift_gap(single["preds"])
    print(f"[{card}] validate --mesh data=1,seq=2 (two gloo ranks on one card) against one "
          f"process: {got['preds'].shape[0]} clips, predictions max_abs_err {verr:.3e} (tol "
          f"{SEQ_VALIDATE_ATOL:g}; a row out of place: {shift:.3e}); test loss "
          f"{got['test_loss']:.8f} vs {single['test_loss']:.8f}; tables "
          f"{'identical' if tables[0] == tables[1] else 'DIFFER'}; wall per rank "
          f"{[round(r['validate_wall_s'], 2) for r in ranks]} s against "
          f"{one_process['validate_wall_s']:.2f} s (one process, graphed); peak memory per "
          f"rank {[round(r['validate_peak_mib'], 1) for r in ranks]} MiB")
    if (got["preds"].shape != (MESH_TEST_CLIPS, 20, IMG, IMG)
            or not verr <= SEQ_VALIDATE_ATOL < shift
            or not np.array_equal(got["gts"], single["gts"])):
        raise AssertionError("validate on data=1,seq=2 disagrees with one process")
    if abs(got["test_loss"] - single["test_loss"]) > 1e-4 * abs(single["test_loss"]):
        raise AssertionError("validate on data=1,seq=2: the test loss disagrees")
    if tables[0] != tables[1]:
        raise AssertionError("validate on data=1,seq=2: the table differs from one process's")
    check_metrics("validate --mesh data=1,seq=2", got["metrics"])
    res["validate"] = {"max_abs_err": verr, "wall_s": [r["validate_wall_s"] for r in ranks],
                       "peak_mib": [r["validate_peak_mib"] for r in ranks]}
    print(f"[{card}] 'seq' axis phase: {time.perf_counter() - t_phase:.1f} s (its ranks ran in "
          f"phase 6j's spawn)")
    return res


# -- training on the mesh's 'seq' and 'model' axes ------------------------------------

# Phase 6l's meshes, ('data', 'seq', 'model'), each two gloo ranks sharing the
# card, and the rows of its training batch (every rank the same rows).
MESH_TRAIN_AXES = {"seq2": (1, 2, 1), "model2": (1, 1, 2)}
MESH_TRAIN_ROWS = 2
MESH_TRAIN_STEPS = 2
# cli.train --mesh data=1,seq=2: 12 synthetic clips, 8 of them training
# clips in batches of 4, an epoch of 2 steps; no checkpoint (the ADNM-UNet's
# is gated to epochs past 34) and no final protocol.
MESH_TRAIN_CLI = ["--synthetic", "--synthetic-len", "12", "--batch-size", "4", "--img-size",
                  str(IMG), "--epochs", "1", "--no-final-eval", "--mesh", "data=1,seq=2"]
# the refiner's scans: on 'seq' K2's carried backward takes their gradient
REFINER_K2B = 8


def mesh_step_launches(axes: tuple, scan: bool) -> dict:
    """Each kernel's launches a rank and training step on the ('data',
    'seq', 'model') = ``axes`` mesh: a step's (``step_launches``, every
    Block norm and scan on every rank); on a 'seq' axis the refiner's 8
    scans take K2's carried backward."""
    want = step_launches(True, scan)
    if axes[1] > 1 and scan:
        want["ssd_chunked_scan_backward"] -= REFINER_K2B
        want["ssd_segment_backward"] = REFINER_K2B
    return want


def recorded_steps(trainer, batch, counts, steps: int) -> tuple:
    """``steps`` training steps of ``trainer`` on ``batch``, then one more:
    (a record of each step's loss, gradient norm and state digest, and of
    the step after them, unrecorded, its launches counted from 0, the bytes
    its collectives sent by axis (forward and backward), its wall and peak
    memory; each recorded step's gradients in fp64 on the host, before the
    clip; each recorded step's state on the host)."""
    from adnm_tpu_torch.parallel.tensor import TRAFFIC

    rec = {k: [] for k in ("losses", "gnorms", "digests")}
    grads, states = [], []
    backward = trainer._backward

    def recording(b, seeds):
        loss = backward(b, seeds)
        grads.append({k: p.grad.detach().to("cpu", torch.float64)
                      for k, p in trainer.model.named_parameters()})
        return loss

    trainer._backward = recording
    for _ in range(steps):
        loss, gn = trainer.train_step(batch, LR, CLIP)
        rec["losses"].append(float(loss))
        rec["gnorms"].append(float(gn))
        rec["digests"].append(state_digest(trainer))
        states.append({k: v.detach().to("cpu", copy=True)
                       for k, v in trainer.model.state_dict().items()})
    trainer._backward = backward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    for k in TRAFFIC:
        TRAFFIC[k] = 0
    t0 = time.perf_counter()
    trainer.train_step(batch, LR, CLIP)
    torch.cuda.synchronize()
    rec.update(wall_s=time.perf_counter() - t0,
               peak_mib=torch.cuda.max_memory_allocated() / 2**20, launches=counts.read(),
               traffic=dict(TRAFFIC))
    return rec, grads, states


def step_against_one(label: str, rec: dict, grads: list, states: list, one: tuple,
                     reference) -> dict:
    """A rank's steps (``recorded_steps``) against one process's on the same
    batch: each step's loss, gradient norm and every gradient tensor
    against one process's from the same parameters (STEP_TOL): the first
    step's from the same init (``one``, one process's ``recorded_steps``),
    a later step's from the rank's own parameters before it
    (``reference(state)``: one process's (loss, fp64 gradients) there),
    since AdamW moves a parameter whose gradient is near 0 by about lr in
    the direction of its sign, which rounding may flip; the parameters after
    each step against one process's independent steps within 2 lr a step
    (``DP_ADAM``). The worst readings, and what failed."""
    one_rec, one_grads, one_states = one
    out = {"loss_rel": [], "gnorm_rel": [], "tensor_rel_max": [], "tensor_ratio_max": [],
           "param_max": [], "failed": []}
    for step in range(len(grads)):
        if step == 0:
            loss1, want = one_rec["losses"][0], one_grads[0]
        else:
            loss1, want = reference(states[step - 1])
        got, total = grads[step], gnorm(want)
        lr_ = abs(rec["losses"][step] - loss1) / abs(loss1)
        gr_ = abs(rec["gnorms"][step] - total) / total
        worst, ratio, bad = 0.0, 0.0, []
        for k, w in want.items():
            norm = float(w.norm())
            e = float((got[k] - w).norm())
            tol = STEP_TOL["tensor"] * norm + STEP_TOL["tensor_of_global"] * total
            worst = max(worst, e / norm if norm else 0.0)
            ratio = max(ratio, e / tol)
            if e > tol:
                bad.append(k)
        pmax = max(float((states[step][k].double() - v.double()).abs().max())
                   for k, v in one_states[step].items() if v.numel())
        out["loss_rel"].append(lr_)
        out["gnorm_rel"].append(gr_)
        out["tensor_rel_max"].append(worst)
        out["tensor_ratio_max"].append(ratio)
        out["param_max"].append(pmax)
        if lr_ > STEP_TOL["loss"] or gr_ > STEP_TOL["grad_norm"] or bad or \
                pmax > 2 * LR * DP_ADAM * (step + 1):
            out["failed"].append(f"{label} step {step + 1}: loss {lr_:.3e}, grad norm "
                                 f"{gr_:.3e}, tensors {bad[:4]}, parameters {pmax:.3e}")
    return out


def mesh_training_records(rank: int, device, meshes: dict, batch: torch.Tensor, counts,
                          zero1: bool = False, steps: int = MESH_TRAIN_STEPS) -> dict:
    """For each model of MESH_CASES and each mesh of ``meshes`` ({label:
    ('data', 'seq', 'model') sizes}) of the process group: ``steps``
    training steps of the full-width model at 256^2
    (``Trainer(ddp=True, mesh=..., zero1=...)``), this rank on its 'data'
    position's rows of the global ``batch`` (``recorded_steps``), and the
    bimamba model's next step traced (it runs K1, its backward, K2 and its
    backward or carried backward); rank 0 first runs one process's steps on
    the whole ``batch``, and holds its own against one process's
    (``step_against_one``; one process's model waits on the host while a
    mesh trainer steps)."""
    from adnm_tpu_torch.parallel import make_mesh
    from adnm_tpu_torch.parallel.tensor import data_rows

    rec = {}
    for label, kwargs in MESH_CASES.items():
        one = ref = None
        if rank == 0:  # one process's steps on the same batch, which the ranks are held to
            ref = make_trainer(device, **kwargs)
            one = recorded_steps(ref, batch, counts, steps)
            rec[f"one {label}"] = one[0]
            del ref.optimizer  # its state is not read again
            ref.model.cpu()
            torch.cuda.empty_cache()

        def reference(state):
            ref.model.to(device)
            ref.model.load_state_dict(state)
            loss, g = ref.grads(batch)
            out = float(loss), {k: v.detach().to("cpu", torch.float64) for k, v in g.items()}
            ref.model.cpu()
            torch.cuda.empty_cache()
            return out

        for name, axes in meshes.items():
            mesh = make_mesh(*axes, device=device)
            t = make_trainer(device, trainer_kwargs={"ddp": True, "mesh": mesh, "zero1": zero1},
                             **kwargs)
            rows = batch[data_rows(mesh, batch.shape[0])]
            r, grads, states = recorded_steps(t, rows, counts, steps)
            if label == "bimamba":  # its step runs all four hand kernels of a step
                names = hand_kernel_names(lambda: t.train_step(rows, LR, CLIP))
                r.update(names=names, traced=trace_launches(names))
            del t
            torch.cuda.empty_cache()
            if rank == 0:
                r["against_one"] = step_against_one(f"{name} {label}", r, grads, states, one,
                                                    reference)
            rec[f"{name} {label}"] = r
            del grads, states
        del one, ref
    return rec


def train_ranks(rank: int, world: int, device, out: str) -> None:
    """A rank of phase 6l: (a) ``mesh_training_records`` on each mesh of
    MESH_TRAIN_AXES, every rank the same rows of a batch of
    MESH_TRAIN_ROWS (no 'data' axis); (b) ``cli.train`` on data=1,seq=2
    through the CLI's per-rank ``run`` (``MESH_TRAIN_CLI``). Every rank
    writes its records."""
    from adnm_tpu_torch.cli import train as train_cli
    from adnm_tpu_torch.cli.common import Launch

    batch = torch.from_numpy(train_batch(MESH_TRAIN_ROWS)).to(device)
    rec = mesh_training_records(rank, device, MESH_TRAIN_AXES, batch, kernel_counts())
    args = train_cli.make_parser().parse_args([*MESH_TRAIN_CLI, "--root",
                                               os.path.join(out, f"train-cli{rank}")])
    t0 = time.perf_counter()
    res = train_cli.run(args, Launch(2, 4, False, 1, 2), device)
    rec["cli"] = {"logs": [dataclasses.asdict(log) for log in res["logs"]],
                  "step": res["trainer"].step, "wall_s": time.perf_counter() - t0}
    torch.save(rec, os.path.join(out, f"train_rank{rank}.pt"))


def mesh_all_ranks(rank: int, world: int, device, out: str) -> None:
    """A rank of phases 6j, 6k and 6l in one spawn of two gloo ranks
    sharing the card (a rank's start is paid once): 6j's
    (``mesh_ranks``), 6k's (``seq_ranks``), then 6l's (``train_ranks``)."""
    t0 = time.perf_counter()
    mesh_ranks(rank, world, device, out, False)
    t1 = time.perf_counter()
    seq_ranks(rank, world, device, out)
    t2 = time.perf_counter()
    train_ranks(rank, world, device, out)
    torch.save({"6j": t1 - t0, "6k": t2 - t1, "6l": time.perf_counter() - t2},
               os.path.join(out, f"walls_rank{rank}.pt"))


def check_mesh_training(card: str, ranks: list, meshes: dict, transport: str) -> dict:
    """The checks of ``mesh_training_records`` (every rank's, ``ranks``) on
    each mesh of ``meshes``: rank 0 against one process (STEP_TOL, the
    parameters within 2 lr a step), the ranks bit-equal (losses, gradient
    norms, state digests), each rank's launches a step counted, and traced
    where a step was (``mesh_step_launches``), bytes over each axis larger than 1, forward
    and backward; prints each with the step walls and peak memories.
    Returns the figures by "mesh model"."""
    res = {}
    for label in MESH_CASES:
        one = ranks[0][f"one {label}"]
        for name, axes in meshes.items():
            key = f"{name} {label}"
            cmp = ranks[0][key]["against_one"]
            want = mesh_step_launches(axes, label == "bimamba")
            launches = [(r[key]["launches"], r[key].get("traced", r[key]["launches"]))
                         for r in ranks]
            dims = [d for d, n in zip(("seq", "model"), axes[1:]) if n > 1]
            sent = [{d: (r[key]["traffic"][d], r[key]["traffic"][f"{d}_backward"])
                     for d in dims} for r in ranks]
            print(f"[{card}] train {label} {IMG}^2 on {name} ({transport}), "
                  f"{len(cmp['loss_rel'])} steps against one process: loss rel "
                  f"{[f'{v:.3e}' for v in cmp['loss_rel']]} (tol {STEP_TOL['loss']:g}), grad "
                  f"norm rel {[f'{v:.3e}' for v in cmp['gnorm_rel']]} (tol "
                  f"{STEP_TOL['grad_norm']:g}), gradient tensors rel max "
                  f"{[f'{v:.3e}' for v in cmp['tensor_rel_max']]} (worst against its tol "
                  f"{[f'{v:.3f}' for v in cmp['tensor_ratio_max']]}), parameters "
                  f"{[f'{v:.3e}' for v in cmp['param_max']]} (tol 2 lr a step); launches a "
                  f"rank and step (counted, traced) {launches}, want "
                  f"{want}; bytes sent a rank and step (forward, backward) {sent}; step wall "
                  f"{[round(r[key]['wall_s'] * 1e3, 1) for r in ranks]} ms against "
                  f"{one['wall_s'] * 1e3:.1f} ms in one process; peak memory "
                  f"{[round(r[key]['peak_mib'], 1) for r in ranks]} MiB against "
                  f"{one['peak_mib']:.1f} MiB")
            if cmp["failed"]:
                raise AssertionError(f"train on {name}: {cmp['failed']}")
            if any(r[key]["losses"] != ranks[0][key]["losses"]
                   or r[key]["gnorms"] != ranks[0][key]["gnorms"]
                   or r[key]["digests"] != ranks[0][key]["digests"] for r in ranks):
                raise AssertionError(f"train {label} on {name}: the ranks differ")
            if any(c != want or t != want for c, t in launches):
                raise AssertionError(f"train {label} on {name}: a rank did not run the hand "
                                     f"kernels, {launches}")
            if any(not (f and b) for r in sent for f, b in r.values()):
                raise AssertionError(f"train {label} on {name}: no bytes over {dims}")
            res[key] = {"against_one": {k: v for k, v in cmp.items() if k != "failed"},
                        "launches_per_rank_step": [c for c, _ in launches],
                        "bytes_per_rank_step": sent,
                        "wall_ms": [r[key]["wall_s"] * 1e3 for r in ranks],
                        "one_wall_ms": one["wall_s"] * 1e3,
                        "peak_mib": [r[key]["peak_mib"] for r in ranks],
                        "one_peak_mib": one["peak_mib"]}
    return res


def mesh_train_phase(card: str, ranks: list) -> dict:
    """Training on the mesh (phase 6l), full width, 256^2, fp32, from the
    records of two gloo ranks sharing the card (``train_ranks``): (1) K2's
    carried backward (``check_k2_carried_backward``); (2) two training
    steps of the duality and bimamba models on seq=2 and on model=2 against
    one process's on the same batch (STEP_TOL, the parameters within 2 lr
    a step), the ranks bit-equal (losses, gradient norms, state digests),
    each rank's launches counted (and traced on bimamba) against
    ``mesh_step_launches``
    and its bytes over the axis, forward and backward, its step wall and
    peak memory against one process's; (3) ``cli.train --mesh
    data=1,seq=2``'s 2-step epoch on both ranks, finite and equal."""
    from adnm_tpu_torch.ops import ssd

    t_phase = time.perf_counter()
    res = {"k2_carried_backward": check_k2_carried_backward(ssd, card)}
    res.update(check_mesh_training(card, ranks, MESH_TRAIN_AXES, "two gloo ranks on one card"))
    logs = [r["cli"]["logs"] for r in ranks]
    print(f"[{card}] cli.train --mesh data=1,seq=2 (two gloo ranks on one card): "
          f"{ranks[0]['cli']['step']} steps, train loss {logs[0][0]['train_loss']:.6f}, val loss "
          f"{logs[0][0]['val_loss']:.6f}, grad norm {logs[0][0]['grad_norm_avg']:.6f}; "
          f"{[round(r['cli']['wall_s'], 1) for r in ranks]} s a rank")
    if ranks[0]["cli"]["step"] != 2 or not np.isfinite(logs[0][0]["train_loss"]) or \
            any({k: v for k, v in log[0].items() if k != "seconds"}
                != {k: v for k, v in logs[0][0].items() if k != "seconds"} for log in logs):
        raise AssertionError("cli.train --mesh data=1,seq=2: not a 2-step epoch equal on the "
                             "ranks")
    print(f"[{card}] training on the mesh phase: {time.perf_counter() - t_phase:.1f} s")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    t_start = time.perf_counter()
    from adnm_tpu_torch.cli import predict
    from adnm_tpu_torch.device import resolve_device
    from adnm_tpu_torch.ops import _build, ssd
    from adnm_tpu_torch.ops import rms_norm as k1_module
    from adnm_tpu_torch.ops.rms_norm import rms_norm, rms_norm_reference

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    resolve_device("cuda")  # fp32 without TF32 for the kernels' checks

    def phase_done(name: str, since: float) -> float:
        now = time.perf_counter()
        print(f"{name}: {now - since:.1f} s")
        return now

    # -- build ---------------------------------------------------------
    build_all(_build, {"rms_norm": k1_module.SOURCES, "ssd_scan": ssd.SOURCES})
    t = phase_done("phases 1-2 (set-up, build)", t_start)

    # -- kernels against their plain versions ---------------------------
    k1 = check_k1(rms_norm, rms_norm_reference)
    k1b = check_k1_backward(k1_module)
    k3 = check_k3(k1_module)
    k2 = check_k2(ssd)
    k2b = check_k2_backward(ssd)
    t = phase_done("phase 3 (kernels against their plain versions)", t)

    # -- the main paths -------------------------------------------------
    counts = kernel_counts()
    rng = np.random.RandomState(0)
    inputs = {"batch1": rng.rand(1, 5, 1, IMG, IMG).astype(np.float32),
              "batch4": rng.rand(4, 5, 1, IMG, IMG).astype(np.float32)}
    inputs["horizon40"] = inputs["batch1"]
    # TF32 allowed again, as cuDNN starts: the entry points must turn it off
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    _, duality_outs = serve_duality(predict, inputs, counts)
    print("TF32 after the first predict CLI call: off")
    bimamba, bimamba_outs = serve_model(predict, "bimamba", BIMAMBA, inputs, counts,
                                        FORWARDS_PER_REQUEST)
    serve_model(predict, "vssd-bimamba", VSSD_BIMAMBA, inputs, counts, ["batch1"])
    t = phase_done("phase 4 (serving)", t)
    with tempfile.TemporaryDirectory() as root:
        trained, snapshot, trained_metrics = train_through_cli(counts, root)
        evaluate_through_clis(counts, root, snapshot, trained_metrics, card)
        t = phase_done("phases 5 and 5b (train, validate, visualise, serve)", t)
        # phase 6i (b) and the CLIs of (c), on this epoch
        check_scan_cli(root, snapshot)
        check_graph_clis(predict, root, snapshot)
        t = phase_done("single dispatch phase, its CLIs", t)

    # -- timing (the fp32 forwards and duality's profiles: phase 6i (d)) ----
    # (batch, refiner remat, profile) of each training measurement
    time_train(card, "duality", {}, counts,
               [(1, True, False), (4, True, False), (4, False, False)])
    scan_steps = time_train(card, "bimamba", BIMAMBA, counts,
                            [(1, True, True), (4, True, False), (4, False, False)])
    time_train(card, "vssd-bimamba", VSSD_BIMAMBA, counts, [(1, True, False)])
    t = phase_done("phase 6 (timing)", t)

    # -- bf16 compute: serving, training, timing -------------------------
    t_bf16 = time.perf_counter()
    bf16 = torch.bfloat16
    _, outs = serve_duality(predict, inputs, counts, bf16=True)
    compare_bf16_with_fp32("duality", {k: outs[k] for k in ("batch1", "batch4")}, duality_outs)
    _, outs = serve_model(predict, "bimamba bf16", BIMAMBA, inputs, counts,
                          FORWARDS_PER_REQUEST, bf16)
    compare_bf16_with_fp32("bimamba", {k: outs[k] for k in ("batch1", "batch4")}, bimamba_outs)
    with tempfile.TemporaryDirectory() as root:
        train_through_cli(counts, root, "--bf16")
    time_forward(predict, "duality bf16", {}, inputs, card, bf16, profile_batches=(4,))
    time_forward(predict, "bimamba bf16", BIMAMBA, inputs, card, bf16, profile_batches=())
    time_train(card, "duality", {}, counts, [(1, True, False), (4, True, False), (4, False, False)],
               bf16)
    time_train(card, "bimamba", BIMAMBA, counts, [(1, True, False), (4, True, False)], bf16)
    print(f"bf16 phase: {time.perf_counter() - t_bf16:.1f} s")

    # -- one training step: twice on the card, card against CPU, bf16 ------
    t = time.perf_counter()
    duality_bf16_grad_err = compare_step_with_cpu("duality", {})
    compare_step_with_cpu("bimamba", BIMAMBA)
    phase_done("phase 6c (a step card against CPU)", t)

    # -- the baselines: SmaAt-UNet, ConvLSTM, TrajGRU, LPTQPN ---------------
    baseline_phase(counts, card)

    # -- MLA, the dead features, TransUnet, SwinUnet ------------------------------
    mla = new_models_phase(predict, inputs, counts, card, duality_bf16_grad_err)

    # -- the LAPS task; the six baselines in bf16 -----------------------------
    laps = laps_phase(predict, counts, card)
    bf16_baseline_phase(predict, counts, card)

    # -- data parallelism: DDP over NCCL and gloo, ZeRO-1, the DP train CLI ----
    par = parallel_phase(card)

    # -- single dispatch: K steps and the eval forward as CUDA graphs ---------
    graphed = single_dispatch_phase(predict, counts, card, inputs)
    per_rank = par["launches_per_rank"]

    # -- multi-rank inference: data=2 and model=2 over gloo on one card -------
    mesh_phase = mesh_inference_phase(card)
    mesh = mesh_phase["gloo"]
    mesh_k1 = {"launches_per_rank_forward": {label: [c["rms_norm"] for c in m[
        "launches_per_rank"]] for label, m in mesh.items()}}
    mesh_k2 = {"launches_per_rank_forward": [c["ssd_chunked_scan"]
                                             for c in mesh["bimamba"]["launches_per_rank"]]}

    # -- the 'seq' axis: a band of rows a rank, K2 carried from rank to rank ----
    seq = mesh_seq_phase(card, mesh_phase["one_process"], mesh_phase["seq_ranks"])
    seq_k1 = {"launches_per_rank_forward": {label: [c["rms_norm"] for c in seq[label][
        "launches_per_rank"]] for label in MESH_CASES}}
    seq_k2 = {"launches_per_rank_forward": [c["ssd_chunked_scan"]
                                            for c in seq["bimamba"]["launches_per_rank"]],
              "carried": seq["k2_carried"]}

    # -- training on the mesh: seq=2 and model=2, K2's carried backward ------
    train = mesh_train_phase(card, mesh_phase["train_ranks"])

    def train_launches(kernel: str) -> dict:
        return {label: {axis: [c[kernel] for c in train[f"{axis} {label}"][
            "launches_per_rank_step"]] for axis in MESH_TRAIN_AXES} for label in MESH_CASES}

    k2cb = train["k2_carried_backward"]
    k2cb_timing = {str(k): v for k, v in k2cb["timing"].items()}

    # Launches: serving kernels from the bimamba requests, K1's backward
    # from the train CLI's run, K2's from the bimamba training steps; K3
    # is on no path.
    launches = {k: sum(r[k] for r in bimamba.values()) for k in counts.wrappers}
    launches["rms_norm_backward"] = trained["rms_norm_backward"]
    launches["ssd_chunked_scan_backward"] = sum(c["ssd_chunked_scan_backward"]
                                                for c in scan_steps)
    k1_ms, k1_plain, k1_lib, k1_bound, k1_by = k1["timing"][("float32", (1, 32, 256, 256))]
    k1b_ms, k1b_plain, k1b_lib, k1b_bound, k1b_by = k1b["timing"][("float32", (4, 32, 256, 256))]
    k3_ms, k3_plain, k3_bound, k3_by = k3["timing"][("float32", (262144, 64))]
    k3b_ms, k3b_plain, k3b_bound, k3b_by = k3["backward_timing"][("float32", (262144, 64))]
    k2_ms, k2_plain, k2_bound, k2_by = k2["timing"][(1, 8, 65536)]
    k2b_ms, k2b_plain, k2b_bound, k2b_by = k2b["timing"][(1, 8, 65536)]
    k2_bf16, k2b_bf16 = ({"bf16_ms": t["bf16_timing"][(1, 8, 65536)][0],
                          "bf16_bound_ms": t["bf16_timing"][(1, 8, 65536)][2],
                          "bf16_max_abs_err": t["bf16_max_abs_err"]} for t in (k2, k2b))
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "rms_norm", "route": "cuda", "source": "adnm_tpu_torch/csrc/rms_norm.cu",
        "replaces": "adnm_tpu/ops/pallas/fused_norm.py:57", "launches": launches["rms_norm"],
        "max_abs_err": k1["max_abs_err"], "ms": k1_ms, "plain_ms": k1_plain,
        "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": k1_lib,
        "worst_vs_library": worst_vs_library(k1["timing"]),
        "mla": {"launches_per_forward": mla["forward"], "launches_per_step": mla["step"],
                "rows": mla_rows(k1["timing"])},
        "laps": {"launches_per_forward": laps["forward"]["rms_norm"],
                 "launches_per_step": laps["cli_step"]["rms_norm"],
                 "rows": mla_rows(k1["timing"], K1_LAPS)},
        "parallel": {"launches_per_rank_step": per_rank["duality"]["rms_norm"]},
        "graphed": {"launches_per_forward": graphed["forward"]["duality"]["rms_norm"],
                    "launches_per_step": graphed["step"]["rms_norm"]},
        "mesh_model2": mesh_k1,
        "mesh_seq2": seq_k1,
        "mesh_train": {"launches_per_rank_step": train_launches("rms_norm")},
    }, {
        "name": "rms_norm_backward", "route": "cuda", "source": "adnm_tpu_torch/csrc/rms_norm.cu",
        "replaces": "adnm_tpu/ops/pallas/fused_norm.py:57",
        "launches": launches["rms_norm_backward"], "max_abs_err": k1b["max_abs_err"],
        "ms": k1b_ms, "plain_ms": k1b_plain, "bound_ms": k1b_bound, "bound_by": k1b_by,
        "library_ms": k1b_lib, "worst_vs_library": worst_vs_library(k1b["timing"]),
        "mla": {"launches_per_step": mla["backward_step"], "rows": mla_rows(k1b["timing"])},
        "laps": {"launches_per_step": laps["cli_step"]["rms_norm_backward"],
                 "rows": mla_rows(k1b["timing"], K1_LAPS)},
        "parallel": {"launches_per_rank_step": per_rank["duality"]["rms_norm_backward"]},
        "graphed": {"launches_per_step": graphed["step"]["rms_norm_backward"]},
        "mesh_train": {"launches_per_rank_step": train_launches("rms_norm_backward")},
    }, {
        "name": "ssd_chunked_scan", "route": "cuda", "source": "adnm_tpu_torch/csrc/ssd_scan.cu",
        "replaces": "adnm_tpu/ops/pallas/ssd_scan.py:132",
        "launches": launches["ssd_chunked_scan"], "max_abs_err": k2["max_abs_err"],
        "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
        "library_ms": None, "worst_vs_bound": worst_vs_bound(k2["timing"]), **k2_bf16,
        "sub_chunk": {str(l): ssd.sub_chunk(l) for l in sorted({l for _, l in K2_SHAPES})},
        "laps": {"launches_per_forward": laps["bimamba_forward"]["ssd_chunked_scan"],
                 "launches_per_step": laps["bimamba_step"]["ssd_chunked_scan"],
                 "rows": k2_rows(k2["timing"], [(b, *K2_LAPS) for b in (1, 4)])},
        "parallel": {"launches_per_rank_step": per_rank["bimamba"]["ssd_chunked_scan"]},
        "graphed": {"launches_per_forward": graphed["forward"]["bimamba"]["ssd_chunked_scan"],
                    "launches_per_step": graphed["bimamba_step"]["ssd_chunked_scan"]},
        "mesh_model2": mesh_k2,
        "mesh_seq2": seq_k2,
        "mesh_train": {"launches_per_rank_step": train_launches("ssd_chunked_scan")},
    }, {
        "name": "ssd_chunked_scan_backward", "route": "cuda",
        "source": "adnm_tpu_torch/csrc/ssd_scan.cu",
        "replaces": "adnm_tpu/ops/pallas/ssd_scan.py:142",
        "launches": launches["ssd_chunked_scan_backward"], "max_abs_err": k2b["max_abs_err"],
        "ms": k2b_ms, "plain_ms": k2b_plain, "bound_ms": k2b_bound, "bound_by": k2b_by,
        "library_ms": None, "worst_vs_bound": worst_vs_bound(k2b["timing"]), **k2b_bf16,
        "laps": {"launches_per_step": laps["bimamba_step"]["ssd_chunked_scan_backward"],
                 "rows": k2_rows(k2b["timing"], [(b, *K2_LAPS) for b in (1, 4)])},
        "parallel": {"launches_per_rank_step":
                     per_rank["bimamba"]["ssd_chunked_scan_backward"]},
        "graphed": {"launches_per_step": graphed["bimamba_step"]["ssd_chunked_scan_backward"]},
        "mesh_model2_train": {"launches_per_rank_step": [
            c["ssd_chunked_scan_backward"]
            for c in train["model2 bimamba"]["launches_per_rank_step"]]},
        "mesh_seq2_train": {"launches_per_rank_step": {
            "backward": [c["ssd_chunked_scan_backward"]
                         for c in train["seq2 bimamba"]["launches_per_rank_step"]],
            "carried_backward": [c["ssd_segment_backward"]
                                 for c in train["seq2 bimamba"]["launches_per_rank_step"]]}},
        "carried": {"max_abs_err": k2cb["max_abs_err"], "timing": k2cb_timing,
                    "source": "adnm_tpu_torch/csrc/ssd_scan.cu (adnm_ssd_segment_adjoint, "
                              "adnm_ssd_segment_backward)"},
    }, {
        "name": "gated_rms_norm", "route": "cuda", "source": "adnm_tpu_torch/csrc/rms_norm.cu",
        "replaces": "adnm_tpu/ops/pallas/fused_norm.py:63",
        "launches": launches["gated_rms_norm"], "max_abs_err": k3["max_abs_err"],
        "ms": k3_ms, "plain_ms": k3_plain, "bound_ms": k3_bound, "bound_by": k3_by,
        "library_ms": None,
    }, {
        "name": "gated_rms_norm_backward", "route": "cuda",
        "source": "adnm_tpu_torch/csrc/rms_norm.cu",
        "replaces": "adnm_tpu/ops/pallas/fused_norm.py:63",
        "launches": launches["gated_rms_norm_backward"],
        "max_abs_err": k3["backward_max_abs_err"], "ms": k3b_ms, "plain_ms": k3b_plain,
        "bound_ms": k3b_bound, "bound_by": k3b_by, "library_ms": None,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
