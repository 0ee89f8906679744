// Causal SSD scan (kernel K2), written by hand for Hopper (sm_90a), as a
// chunk-recurrent state scan.
//
// Replaces the Pallas TPU kernel adnm_tpu/ops/pallas/ssd_scan.py
// ssd_chunked_scan_pallas (_forward with the body _kernel), the function of
// adnm_tpu/ops/ssd.py::ssd_chunked_scan, and its custom_vjp backward (_bwd,
// jax.vjp of that function; see "Backward" below). fp32 throughout (no
// TF32, no tensor cores). In the port's sequence-minor layout, per
// batch b and head h, with dA_t = dt_t * A (A < 0, not negated), the scan
// is the recurrence
//
//     S_t = exp(dA_t) S_{t-1} + B_t (x_t dt_t)      (S: N x P = 16 x 4)
//     y_t = C_t . S_t + D x_t
//
// which equals the chunked form y_t = sum_{s<=t} exp(sum_{r=s+1..t} dA_r)
// (C_t . B_s) x_s dt_s + D x_t up to rounding; the result does not depend
// on the chunk. x (B, H, P, L), dt (B, H, L), A and D (H,), B and C
// (B, N, L) shared by the heads, y (B, H, P, L), with every model's P = 4
// and N = 16. Each sample of x, dt, B and C is contiguous; the samples lie
// at a batch stride of their own, so channel slices of the mixer's NCHW
// tensors are read in place. With reverse != 0 the scan runs from the last
// token to the first: token i of the scan is position L - 1 - i, which is
// flip(scan(flip(x, dt, B, C))) without the copies.
//
// Why not the TPU's quadratic form. The Pallas kernel computes each chunk
// of Q = 256 tokens as a masked Q x Q product, which suits a matrix unit.
// On CUDA cores in fp32 every chunk then visits Q(Q+1)/2 causal pairs, each
// N multiply-adds for C_t . B_s and per head an exp, a subtract and P
// multiply-adds: about 1.2 GFLOP and 67 M exps per refiner call (L =
// 65,536, 8 heads, batch 1), where the recurrence needs 0.17 GFLOP
// (chip_smoke.py::k2_flops). The pairs alone cost 20-35 us there, and the
// tuned quadratic kernel took 17 times its 8.1 us byte bound (PERF.md).
// Here no pair is visited: a token costs 3 multiply-adds per state value
// (decay, rank-1 update, C_t . S_t) and one exp per head.
//
// Walkers. The sequence is cut into sub-chunks of T tokens (T = 32 up to
// L = 256, else 64). A walker is one (sub-chunk, head, p) that walks its T
// tokens in order, keeping the N state values in registers; kNQ = 2
// threads share a walker, thread nq keeping the states n = nq, nq + 2, ...,
// and the two partial sums of y_t meet by a shuffle. Splitting N halves
// each thread's serial walk, which bounds the small grids of the 8^2..32^2
// Blocks. The threads of a warp belong to one sub-chunk (4 heads), so they
// read the same tokens: B_t and C_t are shared-memory broadcasts, and a
// thread reads 4 tokens per 16-byte load. A block is a tile: 256 threads,
// 8 heads, 4 sub-chunks, for one batch sample. It stages x, dt, B and C of
// its tile in shared memory with 16-byte cp.async copies, coalesced in
// device memory (a walker reading its own row would not coalesce with the
// rest of its warp); rows are padded by 4 floats, so the 16-byte reads of 8
// rows fall in distinct banks. Tokens past L are staged as zeros (dt = 0
// leaves the state as it is), and where L or a batch stride is not a
// multiple of 4 or a pointer is not 16-byte aligned the copies are 4-byte
// ones.
//
// Carry. Each walker first walks its sub-chunk from zero, to its end state
// and decay. The block combines its sub-chunks in order through shared
// memory: the state entering sub-chunk w from the tile's start,
// P_w = P_{w-1} exp(dA across w-1) + E_{w-1}, and its decay G_w. Then
//
//   * at most 8 tiles (L <= 8 * 4 T: every 8^2..32^2 Block):
//     ssd_scan_fused, one launch, a thread cluster of one block per tile.
//     Each block pushes its tile's end state into the shared memory of
//     every later block of the cluster, one cluster barrier, then composes
//     the state entering its tile from its own memory, and the walkers walk
//     again from S_in G_w + P_w writing y. Nothing goes through device
//     memory but the inputs and y.
//   * more tiles (the refiner: 256): three launches. ssd_scan_states writes
//     the P_w and G_w of every sub-chunk and each tile's end state and
//     decay; ssd_carry, a block per (batch, head), stages the tiles' end
//     states in shared memory and walks them in 4 segments, writing the
//     state entering each tile; ssd_scan_outputs restages the tile, walks
//     from S_in G_w + P_w and writes y.
//
// y_t is written over x_t in shared memory, then stored coalesced. L <= T
// is one sub-chunk, which walks once from zero.
//
// What bounds it. The function's bytes: x, dt, B, C read and y written
// once, 26 MiB at the refiner (8.1 us at 3.35 TB/s). The three-launch form
// moves about 1.6 times that (x, dt and B are read twice; the states pass
// through the L2), and each of its tile kernels stages its tile, then
// walks, then stores, with no overlap inside a block: at the refiner it
// takes about 3.6 times the bound, of which the carry launch is a fixed
// few us (PERF.md). The operations, about 0.1 G multiply-adds at the
// refiner, are a few us at the fp32 rate. At the 8^2..32^2 Blocks (L =
// 64..1,024) a call is one launch of 16-128 blocks: its latency (staging,
// two serial walks of T tokens, the store) bounds it.
//
// Left for later: a single-pass form of the many-tile case that fuses
// phases 1 and 3 with a decoupled look-back across tiles, so that x, dt and
// B are read once, no carry launch is needed, and a tile's loads overlap
// the previous tile's walk.
//
// Backward. With G_t the adjoint of S_t, G_t = C_t dy_t^T + a_{t+1} G_{t+1}
// (a_t = exp(dA_t)), u_t = G_t^T B_t and g_t = a_t <G_t, S_{t-1}>:
//
//     dx_t = dt_t u_t + D dy_t        ddt_t = x_t . u_t + A g_t
//     dA = sum_{b,t} dt_t g_t         dD = sum_{b,t} x_t . dy_t
//     dB_t = sum_h G_t x_t dt_t       dC_t = sum_h S_t dy_t
//
// in scan order (with reverse, token i is position L - 1 - i as above).
// A block is one sub-chunk of kBT = 32 tokens of one batch sample and 8
// heads, a warp per head: lane (p, nq) keeps the states and adjoints n = nq
// and nq + 8 of column p. u_t is a sum over the 8 nq lanes, g_t and ddt_t
// over the warp, dB_t and dC_t over p in the warp, then over the block's
// heads in shared memory in head order. Phases:
//
//   1. ssd_bwd_chunks: each sub-chunk walked from zero forward to its end
//      state and backward to the adjoint it hands to the token before it,
//      with the decay across it (the adjoint's records in reversed
//      sub-chunk order). Skipped where L is one sub-chunk.
//   2. ssd_bwd_carry, the forward's carry (ssd_carry's body), one block
//      per (batch, head) and direction: the state entering each sub-chunk
//      from the left and the adjoint entering it from the right.
//   3. ssd_bwd_grads: a walk forward from the entering state keeps every
//      S_{t-1} of the sub-chunk in registers (32 tokens x 2 values) and
//      gives dC; a walk back from the entering adjoint gives G_t, and with
//      the kept states dx, ddt, dB and the block's sums of dA and dD.
//   4. ssd_bwd_sum_groups (more than 8 heads: decoder2 has 256) sums dB and
//      dC over the head groups, ssd_bwd_sum_heads sums dA and dD over the
//      blocks, each in a fixed order.
//
// No atomics: every sum runs in a fixed order, so two launches are
// bit-equal. S_{t-1} is never rebuilt from S_t by dividing by a_t: at the
// model's decays dA reaches -0.3 a token, so dividing back across a
// sub-chunk would scale the rounding by up to e^10 (e^19 over 64 tokens);
// the kept states cost registers and nothing else. What bounds it: the
// function's bytes are x, dt, B, C, dy read and dx, ddt, dB, dC written
// (46 MB at the refiner, batch 1: 13.8 us at 3.35 TB/s). The backward
// also reads x, dt, B, C and dy twice, moves the carried records (two of
// 64 floats per 32 tokens and head, through device memory, and twice
// through the carry kernel) and reduces across lanes with shuffles every
// token. It is a first,
// simple form, not tuned (PERF.md has its times).
//
// Built by adnm_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes: adnm_ssd_chunked_scan and
// adnm_ssd_chunked_scan_backward return cudaGetLastError() after the
// launches, and the wrappers (adnm_tpu_torch/ops/ssd.py) raise if it is
// not 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

constexpr int kN = 16;           // state size N
constexpr int kP = 4;            // head width P (headdim of every model)
constexpr int kHeads = 8;        // heads per block
constexpr int kWarp = 32;
constexpr int kThreads = 256;    // 8 warps
constexpr int kPad = 4;          // floats of padding after each staged row
constexpr int kMaxCluster = 8;   // the portable cluster size: tiles of the one-launch form
constexpr float kLog2e = 1.4426950408889634f;

// A thread walks one (sub-chunk, head, p) for the states n = m * kNQ + nq,
// m < kS: kNQ threads share a walker's N values. A warp holds 32 / (4 kNQ)
// heads of one sub-chunk, so its threads read the same tokens.
constexpr int kNQ = 2;                      // threads that share a walker
constexpr int kS = kN / kNQ;                // state values a thread keeps
constexpr int kCols = kHeads * kP * kNQ;    // threads per sub-chunk
constexpr int kSubs = kThreads / kCols;     // sub-chunks per tile
static_assert(kCols % kWarp == 0 && kThreads % kCols == 0, "whole warps per sub-chunk");

struct Args {
    const float* x;
    const float* dt;
    const float* A;
    const float* B;
    const float* C;
    const float* D;
    float* y;
    float* sub_state;   // (batch, H, nsub, P, N): state entering a sub-chunk from its tile's start
    float* sub_decay;   // (batch, H, nsub): decay from the tile's start to the sub-chunk
    float* tile_state;  // (batch, H, ntile, P, N): each tile's end state, then the entering one
    float* tile_decay;  // (batch, H, ntile): decay across each tile
    int64_t sx, sdt, sb, sc;  // batch strides in elements
    int H, L, nsub, ntile;
    int tl;   // tokens per tile: kSubs * T, or nsub * T when there is one tile
    int vec;  // 16-byte copies
};

// The positions [lo, hi) of tile k, held at shared index l - base.
struct Range {
    int base, lo, hi;
};

template <bool REV>
__device__ __forceinline__ Range tile_range(const Args& a, int k) {
    const int base = REV ? a.L - (k + 1) * a.tl : k * a.tl;
    return {base, max(base, 0), min(base + a.tl, a.L)};
}

template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// f(r, i) for every r < rows and i < cols, spread over the block's
// threads, with no division in the loop.
template <typename F>
__device__ __forceinline__ void for_each(int rows, int cols, F f) {
    if (cols <= 0) return;
    const int dr = blockDim.x / cols, di = blockDim.x % cols;
    int r = threadIdx.x / cols, i = threadIdx.x % cols;
    while (r < rows) {
        f(r, i);
        r += dr;
        i += di;
        if (i >= cols) i -= cols, ++r;
    }
}

// Stage `rows` rows of the tile (row r at g + r * L) into s (row stride
// tl + kPad); shared indices outside the tile's range are zero.
__device__ void stage(float* s, const float* g, int rows, const Args& a, Range t) {
    const int rs = a.tl + kPad, z0 = t.lo - t.base, z1 = t.hi - t.base, L = a.L, lo = t.lo;
    for_each(rows, a.tl - (z1 - z0),
             [&](int r, int i) { s[r * rs + (i < z0 ? i : i - z0 + z1)] = 0.f; });
    if (a.vec)
        for_each(rows, (z1 - z0) / 4, [&](int r, int i) {
            copy_async<16>(s + r * rs + z0 + 4 * i, g + int64_t(r) * L + lo + 4 * i);
        });
    else
        for_each(rows, z1 - z0, [&](int r, int i) {
            copy_async<4>(s + r * rs + z0 + i, g + int64_t(r) * L + lo + i);
        });
}

// 4 floats from 16-byte aligned shared memory, in scan order.
template <bool REV>
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = REV ? q.w : q.x;
    v[1] = REV ? q.z : q.y;
    v[2] = REV ? q.y : q.z;
    v[3] = REV ? q.x : q.w;
}

// A thread's T tokens of sub-chunk w: S (its kS states) advances over
// them and ld gains their sum of dt A log2(e). With OUT, y_t is written
// over x_t in xrow, token j of each 4 by the thread with nq == j % kNQ.
// xrow, dtrow: the walker's rows of x and dt; Bs, Cs: rows n of B and C.
template <int T, bool REV, bool OUT>
__device__ __forceinline__ void walk(float* xrow, const float* dtrow, const float* Bs,
                                     const float* Cs, int rs, int tl, int w, int nq, float A2,
                                     float d, float (&S)[kS], float& ld) {
    const int start = REV ? tl - (w + 1) * T : w * T;
#pragma unroll 2
    for (int g = 0; g < T / 4; ++g) {
        const int i = start + 4 * (REV ? T / 4 - 1 - g : g);
        float xv[4], dv[4], a[4], u[4];
        load4<REV>(xrow + i, xv);
        load4<REV>(dtrow + i, dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float e = dv[j] * A2;
            a[j] = exp2f(e);
            u[j] = xv[j] * dv[j];
            ld += e;
        }
        float y0[4] = {0.f, 0.f, 0.f, 0.f}, y1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int m = 0; m < kS; ++m) {
            const int n = m * kNQ + nq;
            float bv[4], cv[4];
            load4<REV>(Bs + n * rs + i, bv);
            if constexpr (OUT) load4<REV>(Cs + n * rs + i, cv);
            float s = S[m];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s = fmaf(s, a[j], bv[j] * u[j]);
                if constexpr (OUT) {
                    if (m % 2 == 0) y0[j] = fmaf(cv[j], s, y0[j]);
                    else y1[j] = fmaf(cv[j], s, y1[j]);
                }
            }
            S[m] = s;
        }
        if constexpr (OUT) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float v = y0[j] + y1[j];
#pragma unroll
                for (int off = 1; off < kNQ; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
                if (j % kNQ == nq) xrow[i + (REV ? 3 - j : j)] = v + d * xv[j];
            }
        }
    }
}

// Shared memory of a tile: x [heads * P][tl + kPad] (then y), dt
// [heads][..], B [N][..], C [N][..] (not in STATES), the sub-chunks' end
// states and log2 decays for the combine (not in OUTPUTS), and in FUSED the
// tile end states that earlier blocks of the cluster push
// [rank][heads * P * N + heads].
enum Mode { STATES, OUTPUTS, FUSED };
constexpr int kAgg = kHeads * kP * kN + kHeads;

constexpr int kCombine = kThreads * (kS + 1);  // floats of the combine

template <Mode MODE>
__host__ __device__ constexpr int staged_rows() {
    return kHeads * kP + kHeads + (MODE == STATES ? 1 : 2) * kN;
}

template <Mode MODE>
size_t smem_bytes(int tl) {
    return sizeof(float) * (size_t(staged_rows<MODE>()) * (tl + kPad) +
                            (MODE == OUTPUTS ? 0 : kCombine) +
                            (MODE == FUSED ? kMaxCluster * kAgg : 0));
}

// One tile (block) for one batch sample and kHeads heads.
//   STATES: walk from zero; write each sub-chunk's entering state from the
//     tile's start and decay, and the tile's end state and decay.
//   OUTPUTS: walk from the state phase 2 carried in, writing y.
//   FUSED (at most kMaxCluster tiles, one a block of a cluster): walk from
//     zero, combine, take the earlier tiles' end states from the cluster,
//     walk again writing y. No scratch in device memory.
template <int T, bool REV, Mode MODE>
__device__ __forceinline__ void scan_tile(const Args& a) {
    const int k = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
    const int c = threadIdx.x % kCols, w = threadIdx.x / kCols;
    const int hn = min(kHeads, a.H - h0), hh = c / (kP * kNQ), p = c / kNQ % kP, nq = c % kNQ;
    const bool active = hh < hn;
    const int h = h0 + min(hh, hn - 1), rs = a.tl + kPad, sub = k * kSubs + w;
    const int subs = blockDim.x / kCols;  // sub-chunks of this tile's block
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);
    float* dts = xs + kHeads * kP * rs;
    float* Bs = dts + kHeads * rs;
    float* Cs = Bs + kN * rs;
    float* comb = xs + staged_rows<MODE>() * rs;
    float* agg = comb + kCombine;
    const bool cluster = MODE == FUSED && a.ntile > 1;
    if (cluster) cluster_arrive_relaxed();  // no block pushes into one that has not started

    const Range t = tile_range<REV>(a, k);
    stage(xs, a.x + b * a.sx + int64_t(h0) * kP * a.L, hn * kP, a, t);
    stage(dts, a.dt + b * a.sdt + int64_t(h0) * a.L, hn, a, t);
    stage(Bs, a.B + b * a.sb, kN, a, t);
    if constexpr (MODE != STATES) stage(Cs, a.C + b * a.sc, kN, a, t);

    float S[kS], ld = 0.f;
#pragma unroll
    for (int m = 0; m < kS; ++m) S[m] = 0.f;
    const int so = p * kN + nq;  // offset of the thread's first state in a (P, N) record
    if (MODE == OUTPUTS && a.nsub > 1 && sub < a.nsub) {
        // the state entering the sub-chunk, loaded under the copies
        const int64_t o = (int64_t(b) * a.H + h) * a.nsub + sub;
        const float G = a.sub_decay[o];
        const float* Pw = a.sub_state + o * (kP * kN) + so;
        const float* Sin = a.tile_state + ((int64_t(b) * a.H + h) * a.ntile + k) * (kP * kN) + so;
#pragma unroll
        for (int m = 0; m < kS; ++m)
            S[m] = a.ntile > 1 ? fmaf(Sin[m * kNQ], G, Pw[m * kNQ]) : Pw[m * kNQ];
    }
    const float A2 = a.A[h] * kLog2e, d = a.D[h];
    copy_wait();
    __syncthreads();

    float* xrow = xs + (hh * kP + p) * rs;
    const float* dtrow = dts + hh * rs;
    if constexpr (MODE != OUTPUTS) {
        if (a.nsub > 1) {
            walk<T, REV, false>(xrow, dtrow, Bs, nullptr, rs, a.tl, w, nq, A2, d, S, ld);
            // P: the state entering sub-chunk w from the tile's start, G its
            // log2 decay; the last sub-chunk's threads go on to the tile's end.
            float* Es = comb;
            float* lds = comb + kThreads * kS;
#pragma unroll
            for (int m = 0; m < kS; ++m) Es[(w * kS + m) * kCols + c] = S[m];
            lds[w * kCols + c] = ld;
            __syncthreads();
            float P[kS], G = 0.f;
#pragma unroll
            for (int m = 0; m < kS; ++m) P[m] = 0.f;
            auto cross = [&](int v) {  // P and G across sub-chunk v
                const float e2 = lds[v * kCols + c], dv = exp2f(e2);
#pragma unroll
                for (int m = 0; m < kS; ++m) P[m] = fmaf(P[m], dv, Es[(v * kS + m) * kCols + c]);
                G += e2;
            };
            for (int v = 0; v < w; ++v) cross(v);
            if constexpr (MODE == STATES) {
                if (active && sub < a.nsub) {
                    const int64_t o = (int64_t(b) * a.H + h) * a.nsub + sub;
#pragma unroll
                    for (int m = 0; m < kS; ++m) a.sub_state[o * (kP * kN) + so + m * kNQ] = P[m];
                    if (p == 0 && nq == 0) a.sub_decay[o] = exp2f(G);
                }
                if (active && w == subs - 1 && a.ntile > 1) {
                    cross(w);
                    const int64_t o = (int64_t(b) * a.H + h) * a.ntile + k;
#pragma unroll
                    for (int m = 0; m < kS; ++m) a.tile_state[o * (kP * kN) + so + m * kNQ] = P[m];
                    if (p == 0 && nq == 0) a.tile_decay[o] = exp2f(G);
                }
                return;
            } else {
                const float Gw = exp2f(G);
                float Pw[kS];
#pragma unroll
                for (int m = 0; m < kS; ++m) Pw[m] = P[m];
                if (cluster) {
                    // Push the tile's end state into every later block of the
                    // cluster, then take the earlier tiles' from this block.
                    auto grp = cg::this_cluster();
                    cluster_wait();
                    if (w == subs - 1) {
                        cross(w);
                        if (active) {
                            const float eG = exp2f(G);
                            for (int q = k + 1; q < a.ntile; ++q) {
                                float* dst = grp.map_shared_rank(agg + k * kAgg, q);
#pragma unroll
                                for (int m = 0; m < kS; ++m)
                                    dst[hh * kP * kN + so + m * kNQ] = P[m];
                                if (p == 0 && nq == 0) dst[kHeads * kP * kN + hh] = eG;
                            }
                        }
                    }
                    grp.sync();
                    float Sin[kS];
#pragma unroll
                    for (int m = 0; m < kS; ++m) Sin[m] = 0.f;
                    for (int q = 0; q < k; ++q) {
                        const float* src = agg + q * kAgg;
                        const float eG = src[kHeads * kP * kN + hh];
#pragma unroll
                        for (int m = 0; m < kS; ++m)
                            Sin[m] = fmaf(Sin[m], eG, src[hh * kP * kN + so + m * kNQ]);
                    }
#pragma unroll
                    for (int m = 0; m < kS; ++m) Pw[m] = fmaf(Sin[m], Gw, Pw[m]);
                }
#pragma unroll
                for (int m = 0; m < kS; ++m) S[m] = Pw[m];
            }
        }
    }

    if constexpr (MODE != STATES) {
        walk<T, REV, true>(xrow, dtrow, Bs, Cs, rs, a.tl, w, nq, A2, d, S, ld);
        __syncthreads();

        // y of the tile's range, rows (head, p) of the block's heads.
        const int z0 = t.lo - t.base, n = t.hi - t.lo, rows = hn * kP;
        float* y = a.y + (int64_t(b) * a.H + h0) * kP * a.L;
        if (a.vec)
            for_each(rows, n / 4, [&](int r, int i) {
                *reinterpret_cast<float4*>(y + int64_t(r) * a.L + t.lo + 4 * i) =
                    *reinterpret_cast<const float4*>(xs + r * rs + z0 + 4 * i);
            });
        else
            for_each(rows, n, [&](int r, int i) {
                y[int64_t(r) * a.L + t.lo + i] = xs[r * rs + z0 + i];
            });
    }
}

template <int T, bool REV>
__global__ void __launch_bounds__(kThreads) ssd_scan_states(Args a) {
    scan_tile<T, REV, STATES>(a);
}

template <int T, bool REV>
__global__ void __launch_bounds__(kThreads) ssd_scan_outputs(Args a) {
    scan_tile<T, REV, OUTPUTS>(a);
}

template <int T, bool REV>
__global__ void __launch_bounds__(kThreads) ssd_scan_fused(Args a) {
    scan_tile<T, REV, FUSED>(a);
}

// Phase 2: a block per (batch, head) carries the state across its tiles.
// The tiles' end states E (nc, P * N) and decays G (nc) are staged in
// shared memory kWindow tiles at a time with coalesced 16-byte copies. The
// window is cut into kSeg segments, a thread per (segment, value): each
// composes its segment from zero, the segments' compositions meet in
// shared memory, and each thread walks its segment again from the state
// entering it, S_in(k+1) = S_in(k) G(k) + E(k), writing the state entering
// each tile over the tile's end state. The window goes back to device
// memory coalesced.
constexpr int kCarryThreads = 256;
constexpr int kSeg = kCarryThreads / (kN * kP);  // segments of a window
constexpr int kWindow = 256;                      // tiles staged at a time
constexpr int kBatch = 16;                        // loads issued ahead of their use
constexpr size_t kCarrySmem = sizeof(float) * (kWindow * (kN * kP + 1) + kSeg * (kN * kP + 1));

// f(c, e, g) for the tiles c of [c0, c1) in order, with the tile's end
// state e and decay g, kBatch tiles' shared loads at a time ahead of f.
template <typename F>
__device__ __forceinline__ void walk_tiles(const float* ss, const float* sd, int v, int c0, int c1,
                                           F f) {
    constexpr int np = kN * kP;
    for (int b0 = c0; b0 < c1; b0 += kBatch) {
        float e[kBatch], g[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            e[i] = ss[min(b0 + i, kWindow - 1) * np + v];
            g[i] = sd[min(b0 + i, kWindow - 1)];
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
            if (b0 + i < c1) f(b0 + i, e[i], g[i]);
    }
}

__device__ __forceinline__ void carry(float* states, const float* decay, int nc) {
    constexpr int np = kN * kP;
    extern __shared__ float4 smem4[];
    float* ss = reinterpret_cast<float*>(smem4);
    float* sd = ss + kWindow * np;
    float* segE = sd + kWindow;  // [kSeg][np]
    float* segD = segE + kSeg * np;
    float* st = states + int64_t(blockIdx.x) * nc * np;  // blockIdx.x: a (batch, head)
    const float* dec = decay + int64_t(blockIdx.x) * nc;
    const int tid = threadIdx.x, v = tid % np, seg = tid / np;
    float carry = 0.f;  // the state entering the window
    for (int w0 = 0; w0 < nc; w0 += kWindow) {
        const int n = min(kWindow, nc - w0);
        for (int e = tid; e < n * np / 4; e += kCarryThreads)
            copy_async<16>(ss + 4 * e, st + int64_t(w0) * np + 4 * e);
        for (int e = tid; e < n; e += kCarryThreads) copy_async<4>(sd + e, dec + w0 + e);
        copy_wait();
        __syncthreads();
        const int len = (n + kSeg - 1) / kSeg, c0 = min(n, seg * len), c1 = min(n, c0 + len);
        float E = 0.f, D = 1.f;
        walk_tiles(ss, sd, v, c0, c1, [&](int, float e, float g) {
            E = fmaf(E, g, e);
            D *= g;
        });
        segE[seg * np + v] = E;
        if (v == 0) segD[seg] = D;
        __syncthreads();
        float S = carry;
        for (int q = 0; q < seg; ++q) S = fmaf(S, segD[q], segE[q * np + v]);
        walk_tiles(ss, sd, v, c0, c1, [&](int c, float e, float g) {
            ss[c * np + v] = S;
            S = fmaf(S, g, e);
        });
        for (int q = 0; q < kSeg; ++q) carry = fmaf(carry, segD[q], segE[q * np + v]);
        __syncthreads();
        for (int e = tid; e < n * np / 4; e += kCarryThreads)
            reinterpret_cast<float4*>(st + int64_t(w0) * np)[e] = smem4[e];
        __syncthreads();  // stored, and the segments read, before the next window
    }
}

__global__ void __launch_bounds__(kCarryThreads) ssd_carry(float* states, const float* decay,
                                                           int nc) {
    carry(states, decay, nc);
}

// ---- K2's backward ---------------------------------------------------------
//
// A block is one sub-chunk of kBT tokens for one batch sample and kHeads
// heads: a warp per head, lane = p * kBNQ + nq, the thread keeping the
// states and adjoints n = nq and nq + kBNQ of column p. Shared rows are
// staged in scan order (token j of sub-chunk w is scan index w * kBT + j,
// position L - 1 - that with REV), zero past L and for heads past H.
constexpr int kBT = 32;                 // tokens per sub-chunk
constexpr int kBNQ = 8;                 // threads that share a (head, p)
constexpr int kBS = kN / kBNQ;          // states a thread keeps
constexpr int kRS = kBT + 1;            // shared row stride: p rows in distinct banks
constexpr int kBRows = 2 * kHeads * kP + kHeads + 2 * kN;  // x, dy, dt, B, C
static_assert(kP * kBNQ == kWarp && kHeads * kWarp == kThreads, "a warp per head");

struct BArgs {
    const float* x;
    const float* dt;
    const float* A;
    const float* B;
    const float* C;
    const float* D;
    const float* dy;  // (batch, H, P, L), contiguous
    float* dx;        // (batch, H, P, L)
    float* ddt;       // (batch, H, L)
    float* dB;        // (batch, N, L), or per head group (batch, ngrp, N, L) when ngrp > 1
    float* dC;
    float* carry;      // (2, batch * H, nsub, P * N): states from the left, then adjoints
                       // from the right in reversed sub-chunk order; entering ones after the carry
    float* carry_dec;  // (2, batch * H, nsub): the decays across each sub-chunk, in the same order
    float* part_dA;    // (H, batch * nsub): per-block sums, reduced in a fixed order
    float* part_dD;
    int64_t sx, sdt, sb, sc;
    int batch, H, L, nsub, ngrp;
};

// rows of g (row r at g + r * L) for the block's sub-chunk, in scan order;
// rows from `valid` on and tokens past L are zero
template <bool REV>
__device__ __forceinline__ void stage_bwd(float* s, const float* g, int rows, int valid,
                                          const BArgs& a) {
    const int i0 = blockIdx.x * kBT, L = a.L;
    for_each(rows, kBT, [&](int r, int j) {
        const int i = i0 + j;
        s[r * kRS + j] = (r < valid && i < L) ? g[int64_t(r) * L + (REV ? L - 1 - i : i)] : 0.f;
    });
}

struct BTile {
    float *xs, *dys, *dts, *Bs, *Cs;
    int b, h0, hn, w, hh, p, nq, h;
};

template <bool REV>
__device__ __forceinline__ BTile stage_tile(float* smem, const BArgs& a) {
    BTile t;
    t.w = blockIdx.x;
    t.h0 = blockIdx.y * kHeads;
    t.b = blockIdx.z;
    t.hn = min(kHeads, a.H - t.h0);
    t.hh = threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    t.p = lane / kBNQ;
    t.nq = lane % kBNQ;
    t.h = t.h0 + min(t.hh, t.hn - 1);
    t.xs = smem;
    t.dys = t.xs + kHeads * kP * kRS;
    t.dts = t.dys + kHeads * kP * kRS;
    t.Bs = t.dts + kHeads * kRS;
    t.Cs = t.Bs + kN * kRS;
    const int64_t hl = int64_t(t.h0) * a.L;
    stage_bwd<REV>(t.xs, a.x + t.b * a.sx + hl * kP, kHeads * kP, t.hn * kP, a);
    stage_bwd<REV>(t.dys, a.dy + (int64_t(t.b) * a.H * kP) * a.L + hl * kP, kHeads * kP,
                   t.hn * kP, a);
    stage_bwd<REV>(t.dts, a.dt + t.b * a.sdt + hl, kHeads, t.hn, a);
    stage_bwd<REV>(t.Bs, a.B + t.b * a.sb, kN, kN, a);
    stage_bwd<REV>(t.Cs, a.C + t.b * a.sc, kN, kN, a);
    __syncthreads();
    return t;
}

// Phase 1: each sub-chunk walked from zero, forward to its end state E_w
// and backward to the adjoint F_w it passes to the token before it, with
// the decay across it; written as the carry's (state, decay) records.
template <bool REV>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunks(BArgs a) {
    extern __shared__ float4 smem4[];
    const BTile t = stage_tile<REV>(reinterpret_cast<float*>(smem4), a);
    const float A2 = a.A[t.h] * kLog2e;
    const float* xrow = t.xs + (t.hh * kP + t.p) * kRS;
    const float* dyrow = t.dys + (t.hh * kP + t.p) * kRS;
    const float* dtrow = t.dts + t.hh * kRS;
    float S[kBS], F[kBS], ld = 0.f;
#pragma unroll
    for (int m = 0; m < kBS; ++m) S[m] = F[m] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kBT; ++j) {
        const float e = dtrow[j] * A2, a_ = exp2f(e), u = xrow[j] * dtrow[j];
        ld += e;
#pragma unroll
        for (int m = 0; m < kBS; ++m) S[m] = fmaf(S[m], a_, t.Bs[(m * kBNQ + t.nq) * kRS + j] * u);
    }
#pragma unroll 4
    for (int j = kBT - 1; j >= 0; --j) {
        const float a_ = exp2f(dtrow[j] * A2), g = dyrow[j];
#pragma unroll
        for (int m = 0; m < kBS; ++m) F[m] = a_ * fmaf(t.Cs[(m * kBNQ + t.nq) * kRS + j], g, F[m]);
    }
    if (t.hh >= t.hn) return;
    const int64_t bh = int64_t(t.b) * a.H + t.h, nbh = int64_t(a.batch) * a.H;
    const int64_t left = bh * a.nsub + t.w, right = (nbh + bh) * a.nsub + (a.nsub - 1 - t.w);
#pragma unroll
    for (int m = 0; m < kBS; ++m) {
        const int v = t.p * kN + m * kBNQ + t.nq;
        a.carry[left * (kP * kN) + v] = S[m];
        a.carry[right * (kP * kN) + v] = F[m];
    }
    if (t.p == 0 && t.nq == 0) a.carry_dec[left] = a.carry_dec[right] = exp2f(ld);
}

__device__ __forceinline__ float warp_sum(float v, int from, int to) {
#pragma unroll
    for (int off = from; off < to; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// The backward's phase 2: the forward's carry, a block per sequence of records.
__global__ void __launch_bounds__(kCarryThreads) ssd_bwd_carry(float* states, const float* decay,
                                                               int nc) {
    carry(states, decay, nc);
}

// Phase 3: a sub-chunk's gradients. The walk forward from the state
// entering the sub-chunk keeps every S_{t-1} in registers (kBT x kBS) and
// gives dC; the walk back from the adjoint entering from the right gives
// G_t, and with the kept S_{t-1} dx, ddt, dB and the sums of dA and dD.
// dB and dC of the block's heads meet in shared memory and are summed in
// head order.
template <bool REV>
__global__ void __launch_bounds__(kThreads) ssd_bwd_grads(BArgs a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const BTile t = stage_tile<REV>(smem, a);
    float* dxs = smem + kBRows * kRS;               // [heads * P][kRS]
    float* ddts = dxs + kHeads * kP * kRS;          // [heads][kRS]
    float* dBs = ddts + kHeads * kRS;               // [heads][kBT][N]
    float* dCs = dBs + kHeads * kBT * kN;           // [heads][kBT][N]
    const float Ah = a.A[t.h], A2 = Ah * kLog2e, Dh = a.D[t.h];
    const float* xrow = t.xs + (t.hh * kP + t.p) * kRS;
    const float* dyrow = t.dys + (t.hh * kP + t.p) * kRS;
    const float* dtrow = t.dts + t.hh * kRS;
    const int64_t bh = int64_t(t.b) * a.H + t.h, nbh = int64_t(a.batch) * a.H;
    float S[kBS], H[kBS];
#pragma unroll
    for (int m = 0; m < kBS; ++m) S[m] = H[m] = 0.f;
    if (a.nsub > 1) {
        const float* left = a.carry + (bh * a.nsub + t.w) * (kP * kN) + t.p * kN + t.nq;
        const float* right =
            a.carry + ((nbh + bh) * a.nsub + (a.nsub - 1 - t.w)) * (kP * kN) + t.p * kN + t.nq;
#pragma unroll
        for (int m = 0; m < kBS; ++m) {
            S[m] = left[m * kBNQ];
            H[m] = right[m * kBNQ];
        }
    }
    const bool lead = t.p == 0;  // lanes 0..kBNQ-1 hold the sums over p
    float Sp[kBT][kBS];  // S_{t-1} of each token
#pragma unroll
    for (int j = 0; j < kBT; ++j) {
        const float a_ = exp2f(dtrow[j] * A2), u = xrow[j] * dtrow[j], g = dyrow[j];
#pragma unroll
        for (int m = 0; m < kBS; ++m) {
            Sp[j][m] = S[m];
            S[m] = fmaf(S[m], a_, t.Bs[(m * kBNQ + t.nq) * kRS + j] * u);
            const float c = warp_sum(S[m] * g, kBNQ, kWarp);  // sum over p of S_t dy_t
            if (lead) dCs[(t.hh * kBT + j) * kN + m * kBNQ + t.nq] = c;
        }
    }
    float dA = 0.f, dD = 0.f;
#pragma unroll
    for (int j = kBT - 1; j >= 0; --j) {
        const float dtj = dtrow[j], a_ = exp2f(dtj * A2), xj = xrow[j], g = dyrow[j];
        float G[kBS], up = 0.f, gs = 0.f;
#pragma unroll
        for (int m = 0; m < kBS; ++m) {
            const int n = m * kBNQ + t.nq;
            G[m] = fmaf(t.Cs[n * kRS + j], g, H[m]);
            up = fmaf(G[m], t.Bs[n * kRS + j], up);
            gs = fmaf(G[m], Sp[j][m], gs);
        }
        const float u = warp_sum(up, 1, kBNQ);  // G_t^T B_t, column p
        const float ag = a_ * gs;               // a_t <G_t, S_{t-1}>, this thread's part
        const float ddt = warp_sum((t.nq == 0 ? xj * u : 0.f) + Ah * ag, 1, kWarp);
        dA = fmaf(dtj, ag, dA);
        if (t.nq == 0) {
            dD = fmaf(xj, g, dD);
            dxs[(t.hh * kP + t.p) * kRS + j] = fmaf(dtj, u, Dh * g);
        }
        if (threadIdx.x % kWarp == 0) ddts[t.hh * kRS + j] = ddt;
        const float xd = xj * dtj;
#pragma unroll
        for (int m = 0; m < kBS; ++m) {
            const float v = warp_sum(G[m] * xd, kBNQ, kWarp);  // sum over p of G_t x_t dt_t
            if (lead) dBs[(t.hh * kBT + j) * kN + m * kBNQ + t.nq] = v;
            H[m] = a_ * G[m];
        }
    }
    dA = warp_sum(dA, 1, kWarp);
    dD = warp_sum(dD, 1, kWarp);
    if (t.hh < t.hn && threadIdx.x % kWarp == 0) {
        const int64_t o = int64_t(t.h) * a.batch * a.nsub + int64_t(t.b) * a.nsub + t.w;
        a.part_dA[o] = dA;
        a.part_dD[o] = dD;
    }
    __syncthreads();

    const int i0 = t.w * kBT, nt = min(kBT, a.L - i0), L = a.L;
    auto pos = [&](int j) { return REV ? L - 1 - (i0 + j) : i0 + j; };
    float* dx = a.dx + (int64_t(t.b) * a.H + t.h0) * kP * L;
    float* ddt = a.ddt + (int64_t(t.b) * a.H + t.h0) * L;
    for_each(t.hn * kP, nt, [&](int r, int j) { dx[int64_t(r) * L + pos(j)] = dxs[r * kRS + j]; });
    for_each(t.hn, nt, [&](int r, int j) { ddt[int64_t(r) * L + pos(j)] = ddts[r * kRS + j]; });
    const int64_t g0 = (int64_t(t.b) * a.ngrp + blockIdx.y) * kN * L;
    for_each(kN, nt, [&](int n, int j) {
        float vb = 0.f, vc = 0.f;
        for (int k = 0; k < t.hn; ++k) {
            vb += dBs[(k * kBT + j) * kN + n];
            vc += dCs[(k * kBT + j) * kN + n];
        }
        a.dB[g0 + int64_t(n) * L + pos(j)] = vb;
        a.dC[g0 + int64_t(n) * L + pos(j)] = vc;
    });
}

// Phase 4: dB and dC summed over the head groups in order (ngrp > 1), from
// the partials (batch, ngrp, N, L) into (batch, N, L).
__global__ void __launch_bounds__(kThreads) ssd_bwd_sum_groups(const float* pb, const float* pc,
                                                              float* dB, float* dC, int batch,
                                                              int ngrp, int64_t nl) {
    const int64_t total = int64_t(batch) * nl;
    for (int64_t e = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; e < total;
         e += int64_t(gridDim.x) * blockDim.x) {
        const int64_t b = e / nl, i = e % nl;
        const float* qb = pb + b * ngrp * nl + i;
        const float* qc = pc + b * ngrp * nl + i;
        float vb = 0.f, vc = 0.f;
        for (int g = 0; g < ngrp; ++g) {
            vb += qb[g * nl];
            vc += qc[g * nl];
        }
        dB[e] = vb;
        dC[e] = vc;
    }
}

// dA and dD of head blockIdx.x: its m per-block sums, each thread a strided
// share in order, then a tree over the threads.
__global__ void __launch_bounds__(kThreads) ssd_bwd_sum_heads(const float* part_dA,
                                                             const float* part_dD, float* dA,
                                                             float* dD, int64_t m) {
    __shared__ float sa[kThreads], sd[kThreads];
    const float* pa = part_dA + blockIdx.x * m;
    const float* pd = part_dD + blockIdx.x * m;
    float va = 0.f, vd = 0.f;
    for (int64_t i = threadIdx.x; i < m; i += kThreads) {
        va += pa[i];
        vd += pd[i];
    }
    const int tid = threadIdx.x;
    sa[tid] = va;
    sd[tid] = vd;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s /= 2) {
        if (tid < s) {
            sa[tid] += sa[tid + s];
            sd[tid] += sd[tid + s];
        }
        __syncthreads();
    }
    if (tid == 0) {
        dA[blockIdx.x] = sa[0];
        dD[blockIdx.x] = sd[0];
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    return bytes > 48 * 1024
               ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(bytes))
               : cudaSuccess;
}

template <typename Kernel>
cudaError_t launch_tiles(Kernel kernel, const Args& a, int batch, int threads, size_t smem,
                         int cluster, cudaStream_t stream) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.ntile, (a.H + kHeads - 1) / kHeads, batch);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    return cudaLaunchKernelEx(&cfg, kernel, a);
}

struct Layout {
    int nsub, ntile, tl, threads;
};

Layout layout(int L, int T) {
    const int nsub = (L + T - 1) / T, ntile = (nsub + kSubs - 1) / kSubs;
    const int per_tile = std::min(kSubs, nsub);
    return {nsub, ntile, per_tile * T, per_tile * kCols};
}

template <int T, bool REV>
cudaError_t launch(const Args& a, int batch, int threads, cudaStream_t stream) {
    if (a.ntile <= kMaxCluster)
        return launch_tiles(ssd_scan_fused<T, REV>, a, batch, threads,
                            smem_bytes<FUSED>(a.tl), a.ntile, stream);
    cudaError_t err = launch_tiles(ssd_scan_states<T, REV>, a, batch, threads,
                                   smem_bytes<STATES>(a.tl), 1, stream);
    if (err != cudaSuccess) return err;
    err = allow_smem(ssd_carry, kCarrySmem);
    if (err != cudaSuccess) return err;
    ssd_carry<<<static_cast<unsigned>(int64_t(batch) * a.H), kCarryThreads, kCarrySmem, stream>>>(
        a.tile_state, a.tile_decay, a.ntile);
    err = launch_tiles(ssd_scan_outputs<T, REV>, a, batch, threads,
                       smem_bytes<OUTPUTS>(a.tl), 1, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

struct BLayout {
    int nsub, ngrp;
    int64_t carry, carry_dec, part, groups;  // floats of each scratch region
};

BLayout bwd_layout(int batch, int H, int L) {
    BLayout s;
    s.nsub = (L + kBT - 1) / kBT;
    s.ngrp = (H + kHeads - 1) / kHeads;
    const int64_t nbh = int64_t(batch) * H;
    s.carry = s.nsub > 1 ? 2 * nbh * s.nsub * kP * kN : 0;
    s.carry_dec = s.nsub > 1 ? 2 * nbh * s.nsub : 0;
    s.part = nbh * s.nsub;
    s.groups = s.ngrp > 1 ? int64_t(batch) * s.ngrp * kN * L : 0;
    return s;
}

constexpr size_t kBwdChunksSmem = sizeof(float) * kBRows * kRS;
constexpr size_t kBwdGradsSmem =
    sizeof(float) * ((kBRows + kHeads * kP + kHeads) * kRS + 2 * kHeads * kBT * kN);

template <bool REV>
cudaError_t launch_bwd(const BArgs& a, const BLayout& s, float* dB, float* dC, float* dA,
                       float* dD, cudaStream_t stream) {
    const dim3 grid(s.nsub, s.ngrp, a.batch);
    cudaError_t err;
    if (s.nsub > 1) {
        ssd_bwd_chunks<REV><<<grid, kThreads, kBwdChunksSmem, stream>>>(a);
        if ((err = allow_smem(ssd_bwd_carry, kCarrySmem)) != cudaSuccess) return err;
        ssd_bwd_carry<<<static_cast<unsigned>(2 * int64_t(a.batch) * a.H), kCarryThreads,
                        kCarrySmem, stream>>>(a.carry, a.carry_dec, s.nsub);
    }
    if ((err = allow_smem(ssd_bwd_grads<REV>, kBwdGradsSmem)) != cudaSuccess) return err;
    ssd_bwd_grads<REV><<<grid, kThreads, kBwdGradsSmem, stream>>>(a);
    if (s.ngrp > 1) {
        const int64_t nl = int64_t(kN) * a.L, total = a.batch * nl;
        const int blocks = static_cast<int>(std::min<int64_t>((total + kThreads - 1) / kThreads, 1056));
        ssd_bwd_sum_groups<<<blocks, kThreads, 0, stream>>>(a.dB, a.dC, dB, dC, a.batch, s.ngrp, nl);
    }
    ssd_bwd_sum_heads<<<a.H, kThreads, 0, stream>>>(a.part_dA, a.part_dD, dA, dD,
                                                    int64_t(a.batch) * s.nsub);
    return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The walkers' sub-chunk: 32 tokens up to L = 256 (the 8^2 and 16^2
// Blocks: more walkers, shorter walks), else 64 (fewer tiles to carry).
int sub_chunk(int L) { return L <= 256 ? 32 : 64; }

}  // namespace

extern "C" {

// The sub-chunk T of a scan over L tokens.
int adnm_ssd_sub_chunk(int L) { return sub_chunk(L); }

// Floats of scratch a call needs: states (batch, H, nsub + ntile, P, N)
// and decays (batch, H, nsub + ntile); none where the tiles fit one
// cluster.
int adnm_ssd_scratch_floats(int batch, int H, int L, int64_t* states, int64_t* decay) {
    if (batch <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
    const Layout s = layout(L, sub_chunk(L));
    const int64_t n = s.ntile > kMaxCluster ? int64_t(batch) * H * (s.nsub + s.ntile) : 0;
    *states = n * kN * kP;
    *decay = n;
    return cudaSuccess;
}

// All tensors float32 on the current device; y and the scratch (sizes from
// adnm_ssd_scratch_floats) contiguous. Q is the caller's chunk: the
// result does not depend on it, but L must be a multiple of it. Returns
// cudaGetLastError() after the launches.
int adnm_ssd_chunked_scan(const void* x, const void* dt, const void* A, const void* B,
                          const void* C, const void* D, void* y, void* states, void* decay,
                          int64_t sx, int64_t sdt, int64_t sb, int64_t sc, int batch, int H,
                          int P, int N, int L, int Q, int reverse, void* stream) {
    if (P != kP || N != kN || batch <= 0 || H <= 0 || Q <= 0 || L % Q != 0 || batch > 65535 ||
        (H + kHeads - 1) / kHeads > 65535)
        return cudaErrorInvalidValue;
    const int T = sub_chunk(L);
    const Layout s = layout(L, T);
    const int64_t n = int64_t(batch) * H;
    const bool scratch = s.ntile > kMaxCluster;
    float* st = static_cast<float*>(states);
    float* dec = static_cast<float*>(decay);
    const bool vec = L % 4 == 0 && sx % 4 == 0 && sdt % 4 == 0 && sb % 4 == 0 && sc % 4 == 0 &&
                     aligned16(x) && aligned16(dt) && aligned16(B) && aligned16(C) &&
                     aligned16(y);
    const Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
                 static_cast<const float*>(A), static_cast<const float*>(B),
                 static_cast<const float*>(C), static_cast<const float*>(D),
                 static_cast<float*>(y),
                 scratch ? st : nullptr,
                 scratch ? dec : nullptr,
                 scratch ? st + n * s.nsub * kN * kP : nullptr,
                 scratch ? dec + n * s.nsub : nullptr,
                 sx, sdt, sb, sc, H, L, s.nsub, s.ntile, s.tl, vec};
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (T == 32)
        err = reverse ? launch<32, true>(a, batch, s.threads, strm)
                      : launch<32, false>(a, batch, s.threads, strm);
    else
        err = reverse ? launch<64, true>(a, batch, s.threads, strm)
                      : launch<64, false>(a, batch, s.threads, strm);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Floats of scratch K2's backward needs: the carried states and adjoints
// with their decays (none where L is one sub-chunk), the per-block sums of
// dA and dD, and per head group dB and dC (none up to kHeads heads).
int adnm_ssd_backward_scratch_floats(int batch, int H, int L, int64_t* floats) {
    if (batch <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
    const BLayout s = bwd_layout(batch, H, L);
    *floats = s.carry + s.carry_dec + 2 * s.part + 2 * s.groups;
    return cudaSuccess;
}

// K2's backward: dx, ddt (contiguous, x's and dt's shapes), dA, dD (H),
// dB, dC (contiguous (batch, N, L)) of the scan for dy (contiguous, x's
// shape); x, dt, B, C at the batch strides given, as in the forward; the
// scratch sized by adnm_ssd_backward_scratch_floats. Every output is
// written, none accumulated into; no atomics, so two launches are
// bit-equal. Returns cudaGetLastError() after the launches.
int adnm_ssd_chunked_scan_backward(const void* x, const void* dt, const void* A, const void* B,
                                   const void* C, const void* D, const void* dy, void* dx,
                                   void* ddt, void* dA, void* dB, void* dC, void* dD,
                                   void* scratch, int64_t sx, int64_t sdt, int64_t sb, int64_t sc,
                                   int batch, int H, int P, int N, int L, int Q, int reverse,
                                   void* stream) {
    if (P != kP || N != kN || batch <= 0 || H <= 0 || L <= 0 || Q <= 0 || L % Q != 0 ||
        batch > 65535 || (H + kHeads - 1) / kHeads > 65535)
        return cudaErrorInvalidValue;
    const BLayout s = bwd_layout(batch, H, L);
    float* f = static_cast<float*>(scratch);
    float* carry = f;
    float* carry_dec = carry + s.carry;
    float* part_dA = carry_dec + s.carry_dec;
    float* part_dD = part_dA + s.part;
    float* group_dB = part_dD + s.part;
    float* group_dC = group_dB + s.groups;
    const bool grouped = s.ngrp > 1;
    const BArgs a{static_cast<const float*>(x), static_cast<const float*>(dt),
                  static_cast<const float*>(A), static_cast<const float*>(B),
                  static_cast<const float*>(C), static_cast<const float*>(D),
                  static_cast<const float*>(dy), static_cast<float*>(dx),
                  static_cast<float*>(ddt),
                  grouped ? group_dB : static_cast<float*>(dB),
                  grouped ? group_dC : static_cast<float*>(dC),
                  carry, carry_dec, part_dA, part_dD, sx, sdt, sb, sc, batch, H, L, s.nsub,
                  s.ngrp};
    float *oB = static_cast<float*>(dB), *oC = static_cast<float*>(dC);
    float *oA = static_cast<float*>(dA), *oD = static_cast<float*>(dD);
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    const cudaError_t err = reverse ? launch_bwd<true>(a, s, oB, oC, oA, oD, strm)
                                    : launch_bwd<false>(a, s, oB, oC, oA, oD, strm);
    return static_cast<int>(err);
}

const char* adnm_ssd_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
