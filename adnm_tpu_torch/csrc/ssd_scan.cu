// Causal SSD scan (kernel K2), written by hand for Hopper (sm_90a), as a
// chunk-recurrent state scan.
//
// Replaces the Pallas TPU kernel adnm_tpu/ops/pallas/ssd_scan.py
// ssd_chunked_scan_pallas (_forward with the body _kernel), the function of
// adnm_tpu/ops/ssd.py::ssd_chunked_scan, and its custom_vjp backward (_bwd,
// jax.vjp of that function; see "Backward" below). The tensors of a call
// are all float32 or all bfloat16 (the port's bf16 compute); as in the
// Pallas kernel, which reads any dtype and writes y in x's, every value is
// widened to fp32 as it is staged, all arithmetic, carried state and sum is
// fp32 (no TF32, no tensor cores), and each output is rounded once, as it
// is stored. bf16 rows are staged by 8-byte loads widened in registers
// (cp.async cannot convert), fp32 rows by cp.async. In the port's
// sequence-minor layout, per
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
// once, 26 MiB at the refiner in fp32 (8.1 us at 3.35 TB/s; half in bf16). The three-launch form
// moves about 1.6 times that (x, dt and B are read twice; the states pass
// through the L2), and each of its tile kernels stages its tile, then
// walks, then stores, with no overlap inside a block: at the refiner it
// takes about 3.6 times the bound, of which the carry launch is a fixed
// few us (PERF.md). The operations, about 0.1 G multiply-adds at the
// refiner, are a few us at the fp32 rate. At the 8^2..32^2 Blocks (L =
// 64..1,024) a call is one launch of 16-128 blocks: its latency (staging,
// two serial walks of T tokens, the store) bounds it.
//
// Carried form. A sequence cut into segments, one a rank (the mesh's 'seq'
// axis), is scanned segment by segment with the state carried between them,
// in two phases around the caller's exchange of segment states:
//
//   * adnm_ssd_scan_segment_states: ssd_scan_states writing every
//     sub-chunk's and tile's records whatever the layout, then
//     ssd_carry_segment, ssd_carry's walk from zero that also leaves in
//     place of each tile's decay the decay D_k from the segment's start to
//     tile k, and writes the segment's end state and decay;
//   * adnm_ssd_scan_carried_outputs: ssd_scan_outputs, each sub-chunk
//     walking from (S0 D_k + S_k) G_w + P_w, S0 the state entering the
//     segment, S_k the state entering tile k from zero.
//
// Four launches where the plain scan takes one to three; a segment's y is
// the whole scan's up to rounding. Without a carried state the entry
// adnm_ssd_chunked_scan is unchanged.
//
// Left for later: a single-pass form of the many-tile case that fuses
// phases 1 and 3 with a decoupled look-back across tiles, so that x, dt and
// B are read once, no carry launch is needed, and a tile's loads overlap
// the previous tile's walk.
//
// Backward. With G_t the adjoint of S_t, G_t = C_t dy_t^T + a_{t+1} G_{t+1}
// (a_t = exp(dA_t)), u_t = G_t^T B_t and w_t = a_t <G_t, S_{t-1}>:
//
//     dx_t = dt_t u_t + D dy_t        ddt_t = x_t . u_t + A w_t
//     dA = sum_{b,t} dt_t w_t         dD = sum_{b,t} x_t . dy_t
//     dB_t = sum_h G_t x_t dt_t       dC_t = sum_h S_t dy_t
//
// in scan order (with reverse, token i is position L - 1 - i as above).
// w_t needs no kept state. Since a_t S_{t-1} = S_t - B_t (x_t dt_t)^T and
// <G_t, S_t> = C_t . S_t dy_t + w_{t+1},
//
//     w_t = w_{t+1} + z_t - dt_t x_t . u_t,      z_t = C_t . S_t dy_t:
//
// the walk of the states forward gives z_t (beside dC_t), the walk of the
// adjoints backward gives u_t (beside dB_t), each on its own, and w is a
// suffix sum of their terms within a sub-chunk of 32 tokens, from the
// sub-chunk's end product <R, S_end> (R the adjoint entering it from the
// right). No S_{t-1} is rebuilt by dividing by a_t (at the model's decays,
// dA down to -0.3 a token, that would scale the rounding by up to e^10 over
// a sub-chunk), and no sum spans more than a sub-chunk, as the plain
// version's sums stay within a chunk.
//
// A block is a tile of 128 tokens (kBSubs = 4 sub-chunks of kBT = 32) of
// one batch sample and 8 heads: warp 2w walks sub-chunk w's states forward
// and warp 2w + 1 its adjoints backward, each for the 8 heads; lane
// (head, q) keeps the 16 values (n, p) of its head with n = q + 4m, every p,
// so the sums over p of dB and dC are in-thread FMAs. The state warps stage
// x, dt and B, the adjoint warps dy and C, with 16-byte cp.async copies
// (4-byte where L, a stride or a pointer is unaligned), and each direction
// starts when its own rows are in (named barriers). Phases of a tile:
//
//   1. each sub-chunk walked from zero: its end state, or the adjoint it
//      hands to the token before it, and its decay;
//   2. the combine in shared memory, in order and in reversed order: the
//      state entering each sub-chunk from the tile's start, the adjoint
//      entering it from the tile's end, and the tile's own end state and
//      adjoint (its records);
//   3. the state and adjoint entering the tile:
//      * at most 8 tiles (L <= 1,024: every 8^2..32^2 Block): ssd_bwd_fused,
//        one launch, a thread cluster of one block per tile, as the
//        forward's. Each block pushes its tile's end state into the shared
//        memory of every later block and its adjoint into every earlier
//        one's, one cluster barrier, and composes both from its own memory.
//      * more (the refiner: 512): ssd_bwd_summary writes the tiles' records,
//        ssd_bwd_carry (the forward's carry with a window of 512 tiles, both
//        directions in one launch) carries them, and ssd_bwd_grads reads
//        them; 2 x 512 records of 64 floats per (batch, head), 2 MB at the
//        refiner, batch 1;
//   4. the gradient walks, a pair of tokens at a time. The recurrences
//      advance with no cross-lane sum; after each pair, dC (state warps) and
//      dB (adjoint warps) are summed over the warp's 8 heads by a
//      reduce-scatter (7 shuffles leave each lane one of the 32 (n, token)
//      sums), and z and u over the head's 4 lanes, into shared memory;
//   5. a warp per head, a lane per token: the suffix sum of w, ddt, dx and
//      the block's sums of dA and dD; then dx, ddt, dB and dC are stored
//      coalesced;
//   6. ssd_bwd_sums, one launch: dA and dD of each head over the blocks, and
//      dB and dC over the head groups (more than 8 heads: decoder2 has 32).
//
// No atomics: every sum runs in one fixed order, so two launches are
// bit-equal. What bounds it: the function's bytes are x, dt, B, C, dy read
// and dx, ddt, dB, dC written (46 MB at the refiner, batch 1, in fp32:
// 13.8 us at 3.35 TB/s; 6.9 us in bf16); its fp32 operations (about 0.5 G
// there, chip_smoke.py::k2_bwd_flops) take 7.4 us at the card's fp32 rate,
// so in bf16 the operations bound it.
// At the refiner the summary and gradient passes each read the inputs
// (about 1.6 times the bound's bytes). ptxas gives ssd_bwd_grads and
// ssd_bwd_fused 128 registers and ssd_bwd_summary 78-80 (no spills); 93 KB
// of shared memory (a tile's staged rows and gradients) leave 2 blocks of 8
// warps an SM for the gradient pass, 72 KB 3 for the summary, and a block
// stages its tile before it walks, so its loads overlap only the other
// blocks' walks. Holding the gradient pass to 80 registers for 3 blocks an
// SM spills and runs slower; summary blocks of one direction each (half
// the rows, 5 an SM) run no faster. At the 8^2..32^2 Blocks (L = 64..1,024)
// a call is one clustered launch of 16-512 blocks and the sums: the latency
// of a tile's two walks bounds it. PERF.md has the times.
//
// Left for later: double-buffering a tile's loads against the previous
// tile's walks in a persistent grid, and a single pass over the inputs with
// a look-back across tiles in place of the summary.
//
// Carried backward. The gradient of a segment of a longer sequence (a
// rank's band on the mesh's 'seq' axis) from the state S0 entering it and
// the adjoint lambda entering its end (the gradient of its final state,
// which later segments hand back), in two phases around the caller's
// exchange of the segments' adjoints:
//
//   * adnm_ssd_segment_adjoint: ssd_bwd_summary over every tile whatever
//     the layout, then ssd_bwd_carry_segment, the carry of both directions
//     that also leaves in place of each tile's decay the decay from the
//     segment's start to the tile (states) or from its end back to the
//     tile's end (adjoints), and writes per (batch, head) the segment's
//     end state and the adjoint handed out of its first token, both from
//     zero, with its decay;
//   * adnm_ssd_segment_backward: ssd_bwd_grads, the state and adjoint
//     entering each tile being its records from zero plus S0 and lambda
//     decayed to it (fmaf(S0, D_k, S_k)), then the sums; the tile holding
//     the first token writes a_0 G_0, the gradient of S0.
//
// The decay's gradient needs no separate term: the carried state and
// adjoint enter every sub-chunk's end product and walk, so <lambda, S0>
// reaches dt and A through w_t. From S0 = lambda = 0 the gradients are
// adnm_ssd_chunked_scan_backward's bits (the one-cluster layout composes
// the tiles' records in the carry's order). Four launches where the plain
// backward takes two to four, the inputs read twice.
//
// Built by adnm_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes: adnm_ssd_chunked_scan and
// adnm_ssd_chunked_scan_backward return cudaGetLastError() after the
// launches, and the wrappers (adnm_tpu_torch/ops/ssd.py) raise if it is
// not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// The tensors a call reads and writes hold IO, float or __nv_bfloat16, all of
// one type; everything staged, carried and computed is fp32.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// v rounded to the type of *p (to nearest even) and stored there.
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// 4 consecutive values at p (aligned to 4 of them) as fp32, and back.
__device__ __forceinline__ float4 load4g(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4g(const bf16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);  // the first value in the low half
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4g(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4g(bf16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

template <typename IO>
struct Args {
    const IO* x;
    const IO* dt;
    const IO* A;
    const IO* B;
    const IO* C;
    const IO* D;
    IO* y;
    float* sub_state;   // (batch, H, nsub, P, N): state entering a sub-chunk from its tile's start
    float* sub_decay;   // (batch, H, nsub): decay from the tile's start to the sub-chunk
    float* tile_state;  // (batch, H, ntile, P, N): each tile's end state, then the entering one
    float* tile_decay;  // (batch, H, ntile): decay across each tile
    int64_t sx, sdt, sb, sc;  // batch strides in elements
    int H, L, nsub, ntile;
    int tl;   // tokens per tile: kSubs * T, or nsub * T when there is one tile
    int vec;  // copies of 4 values (16 bytes in fp32, 8 in bf16)
    // The carried form (a segment of a longer sequence), 0 and null otherwise:
    // the states write every sub-chunk's and tile's records, whatever the
    // layout, and the outputs start from the state entering the segment.
    int seg;
    const float* init;  // (batch, H, P, N): the state entering the segment
};

// The positions [lo, hi) of tile k, held at shared index l - base.
struct Range {
    int base, lo, hi;
};

template <bool REV, typename A>  // Args or BArgs
__device__ __forceinline__ Range tile_range(const A& a, int k) {
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

// f(r, i) for every r < rows and i < cols, spread over the n threads of a
// group, this one being tid, with no division in the loop.
template <typename F>
__device__ __forceinline__ void for_each_of(int tid, int n, int rows, int cols, F f) {
    if (cols <= 0) return;
    const int dr = n / cols, di = n % cols;
    int r = tid / cols, i = tid % cols;
    while (r < rows) {
        f(r, i);
        r += dr;
        i += di;
        if (i >= cols) i -= cols, ++r;
    }
}

// for_each_of over the block's threads.
template <typename F>
__device__ __forceinline__ void for_each(int rows, int cols, F f) {
    for_each_of(threadIdx.x, blockDim.x, rows, cols, f);
}

// Copy `rows` rows of length n (row r at g + r * L) into s (row stride rs)
// at columns [z0, z0 + n), over the n threads of a group: fp32 rows by
// cp.async (16 bytes, or 4 where the copy is not vector), bf16 rows by
// loads widened to fp32 and stored (their wait is the caller's barrier).
template <typename IO>
__device__ __forceinline__ void copy_rows(float* s, const IO* g, int rows, int n, int rs, int z0,
                                          int64_t L, bool vec, int tid, int nthreads) {
    if constexpr (std::is_same_v<IO, float>) {
        if (vec)
            for_each_of(tid, nthreads, rows, n / 4, [&](int r, int i) {
                copy_async<16>(s + r * rs + z0 + 4 * i, g + r * L + 4 * i);
            });
        else
            for_each_of(tid, nthreads, rows, n, [&](int r, int i) {
                copy_async<4>(s + r * rs + z0 + i, g + r * L + i);
            });
    } else {
        if (vec)
            for_each_of(tid, nthreads, rows, n / 4, [&](int r, int i) {
                *reinterpret_cast<float4*>(s + r * rs + z0 + 4 * i) = load4g(g + r * L + 4 * i);
            });
        else
            for_each_of(tid, nthreads, rows, n,
                        [&](int r, int i) { s[r * rs + z0 + i] = to_f(g[r * L + i]); });
    }
}

// Store `rows` rows of length n from s (row stride rs, columns [z0, z0 + n))
// to g (row r at g + r * L), rounded to g's type, over the block.
template <typename OUT>
__device__ __forceinline__ void store_rows(OUT* g, const float* s, int rows, int n, int rs, int z0,
                                           int64_t L, bool vec) {
    if (vec)
        for_each(rows, n / 4, [&](int r, int i) {
            store4g(g + r * L + 4 * i, *reinterpret_cast<const float4*>(s + r * rs + z0 + 4 * i));
        });
    else
        for_each(rows, n, [&](int r, int i) { put(g + r * L + i, s[r * rs + z0 + i]); });
}

// Stage `rows` rows of the tile (row r at g + r * L) into s (row stride
// tl + kPad); shared indices outside the tile's range are zero.
template <typename IO>
__device__ void stage(float* s, const IO* g, int rows, const Args<IO>& a, Range t) {
    const int rs = a.tl + kPad, z0 = t.lo - t.base, z1 = t.hi - t.base;
    for_each(rows, a.tl - (z1 - z0),
             [&](int r, int i) { s[r * rs + (i < z0 ? i : i - z0 + z1)] = 0.f; });
    copy_rows(s, g + t.lo, rows, z1 - z0, rs, z0, a.L, a.vec, threadIdx.x, blockDim.x);
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
template <typename IO, int T, bool REV, Mode MODE>
__device__ __forceinline__ void scan_tile(const Args<IO>& a) {
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
    if (MODE == OUTPUTS && (a.nsub > 1 || a.seg) && sub < a.nsub) {
        // the state entering the sub-chunk, loaded under the copies
        const int64_t o = (int64_t(b) * a.H + h) * a.nsub + sub;
        const float G = a.sub_decay[o];
        const float* Pw = a.sub_state + o * (kP * kN) + so;
        const int64_t ot = (int64_t(b) * a.H + h) * a.ntile + k;
        const float* Sin = a.tile_state + ot * (kP * kN) + so;
        if (a.seg) {
            // Sin: the state entering the tile from the segment's start, from
            // zero; the entering state's part decays by tile_decay (the
            // decay from the segment's start to the tile, after the carry)
            const float Dk = a.tile_decay[ot];
            const float* I = a.init + (int64_t(b) * a.H + h) * (kP * kN) + so;
#pragma unroll
            for (int m = 0; m < kS; ++m)
                S[m] = fmaf(fmaf(I[m * kNQ], Dk, Sin[m * kNQ]), G, Pw[m * kNQ]);
        } else {
#pragma unroll
            for (int m = 0; m < kS; ++m)
                S[m] = a.ntile > 1 ? fmaf(Sin[m * kNQ], G, Pw[m * kNQ]) : Pw[m * kNQ];
        }
    }
    const float A2 = to_f(a.A[h]) * kLog2e, d = to_f(a.D[h]);
    copy_wait();
    __syncthreads();

    float* xrow = xs + (hh * kP + p) * rs;
    const float* dtrow = dts + hh * rs;
    if constexpr (MODE != OUTPUTS) {
        if (a.nsub > 1 || a.seg) {
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
                if (active && w == subs - 1 && (a.ntile > 1 || a.seg)) {
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
        IO* y = a.y + (int64_t(b) * a.H + h0) * kP * a.L + t.lo;
        store_rows(y, xs, hn * kP, t.hi - t.lo, rs, t.lo - t.base, a.L, a.vec);
    }
}

template <typename IO, int T, bool REV>
__global__ void __launch_bounds__(kThreads) ssd_scan_states(Args<IO> a) {
    scan_tile<IO, T, REV, STATES>(a);
}

template <typename IO, int T, bool REV>
__global__ void __launch_bounds__(kThreads) ssd_scan_outputs(Args<IO> a) {
    scan_tile<IO, T, REV, OUTPUTS>(a);
}

template <typename IO, int T, bool REV>
__global__ void __launch_bounds__(kThreads) ssd_scan_fused(Args<IO> a) {
    scan_tile<IO, T, REV, FUSED>(a);
}

// Phase 2: a block per (batch, head) carries the state across its tiles.
// The tiles' end states E (nc, P * N) and decays G (nc) are staged in
// shared memory WINDOW tiles at a time with coalesced 16-byte copies. The
// window is cut into THREADS / (P * N) segments, a thread per (segment,
// value): each
// composes its segment from zero, the segments' compositions meet in
// shared memory, and each thread walks its segment again from the state
// entering it, S_in(k+1) = S_in(k) G(k) + E(k), writing the state entering
// each tile over the tile's end state. The window goes back to device
// memory coalesced.
constexpr int kCarryThreads = 256;
constexpr int kWindow = 256;  // tiles staged at a time
constexpr int kBatch = 16;    // loads issued ahead of their use

constexpr size_t carry_smem(int threads, int window) {
    return sizeof(float) * (window * (kN * kP + 1) + threads / (kN * kP) * (kN * kP + 1));
}
constexpr size_t kCarrySmem = carry_smem(kCarryThreads, kWindow);

// f(c, e, g) for the tiles c of [c0, c1) in order, with the tile's end
// state e and decay g, kBatch tiles' shared loads at a time ahead of f.
template <int WINDOW, typename F>
__device__ __forceinline__ void walk_tiles(const float* ss, const float* sd, int v, int c0, int c1,
                                           F f) {
    constexpr int np = kN * kP;
    for (int b0 = c0; b0 < c1; b0 += kBatch) {
        float e[kBatch], g[kBatch];
#pragma unroll
        for (int i = 0; i < kBatch; ++i) {
            e[i] = ss[min(b0 + i, WINDOW - 1) * np + v];
            g[i] = sd[min(b0 + i, WINDOW - 1)];
        }
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
            if (b0 + i < c1) f(b0 + i, e[i], g[i]);
    }
}

// SEG (the carried form): the decay in place of each tile's is the decay
// from the segment's start to the tile, and fin_state (P * N) and
// fin_decay (1) per (batch, head) take the segment's end state and its
// decay, both from zero.
template <int THREADS, int WINDOW, bool SEG = false>
__device__ __forceinline__ void carry(float* states, float* decay, int nc,
                                      float* fin_state = nullptr, float* fin_decay = nullptr) {
    constexpr int np = kN * kP, kSeg = THREADS / np;
    extern __shared__ float4 smem4[];
    float* ss = reinterpret_cast<float*>(smem4);
    float* sd = ss + WINDOW * np;
    float* segE = sd + WINDOW;  // [kSeg][np]
    float* segD = segE + kSeg * np;
    float* st = states + int64_t(blockIdx.x) * nc * np;  // blockIdx.x: a (batch, head)
    float* dec = decay + int64_t(blockIdx.x) * nc;
    const int tid = threadIdx.x, v = tid % np, seg = tid / np;
    float carry = 0.f;   // the state entering the window
    float carryD = 1.f;  // SEG: the decay from the segment's start to the window
    for (int w0 = 0; w0 < nc; w0 += WINDOW) {
        const int n = min(WINDOW, nc - w0);
        for (int e = tid; e < n * np / 4; e += THREADS)
            copy_async<16>(ss + 4 * e, st + int64_t(w0) * np + 4 * e);
        for (int e = tid; e < n; e += THREADS) copy_async<4>(sd + e, dec + w0 + e);
        copy_wait();
        __syncthreads();
        const int len = (n + kSeg - 1) / kSeg, c0 = min(n, seg * len), c1 = min(n, c0 + len);
        float E = 0.f, D = 1.f;
        walk_tiles<WINDOW>(ss, sd, v, c0, c1, [&](int, float e, float g) {
            E = fmaf(E, g, e);
            D *= g;
        });
        segE[seg * np + v] = E;
        if (v == 0) segD[seg] = D;
        __syncthreads();
        float S = carry;
        for (int q = 0; q < seg; ++q) S = fmaf(S, segD[q], segE[q * np + v]);
        if constexpr (SEG) {
            // the staged decays stay in shared memory: each tile's decay in
            // device memory becomes the decay from the segment's start to it
            float Dp = carryD;
            for (int q = 0; q < seg; ++q) Dp *= segD[q];
            walk_tiles<WINDOW>(ss, sd, v, c0, c1, [&](int c, float e, float g) {
                ss[c * np + v] = S;
                if (v == 0) dec[w0 + c] = Dp;
                S = fmaf(S, g, e);
                Dp *= g;
            });
            for (int q = 0; q < kSeg; ++q) carryD *= segD[q];
        } else {
            walk_tiles<WINDOW>(ss, sd, v, c0, c1, [&](int c, float e, float g) {
                ss[c * np + v] = S;
                S = fmaf(S, g, e);
            });
        }
        for (int q = 0; q < kSeg; ++q) carry = fmaf(carry, segD[q], segE[q * np + v]);
        __syncthreads();
        for (int e = tid; e < n * np / 4; e += THREADS)
            reinterpret_cast<float4*>(st + int64_t(w0) * np)[e] = smem4[e];
        __syncthreads();  // stored, and the segments read, before the next window
    }
    if constexpr (SEG) {
        if (seg == 0) fin_state[int64_t(blockIdx.x) * np + v] = carry;
        if (tid == 0) fin_decay[blockIdx.x] = carryD;
    }
}

__global__ void __launch_bounds__(kCarryThreads) ssd_carry(float* states, float* decay, int nc) {
    carry<kCarryThreads, kWindow>(states, decay, nc);
}

__global__ void __launch_bounds__(kCarryThreads) ssd_carry_segment(float* states, float* decay,
                                                                   int nc, float* fin_state,
                                                                   float* fin_decay) {
    carry<kCarryThreads, kWindow, true>(states, decay, nc, fin_state, fin_decay);
}

// ---- K2's backward ---------------------------------------------------------
//
// A block is one tile of kBSubs sub-chunks of kBT tokens for one
// batch sample and kHeads heads. Warp 2w walks sub-chunk w's states S
// forward, warp 2w + 1 its adjoints backward; lane = hh * kBQ + q, the
// thread keeping the values (n, p) of head hh with n = q + kBQ * m, m < kBM,
// and every p. Staged rows are in position order, as the forward's (token s
// of the tile in scan order at shared index spos(s)), zero outside L and
// for heads past H.
constexpr int kBT = 32;                       // tokens per sub-chunk
constexpr int kBSubs = 4;                     // sub-chunks per tile
constexpr int kBQ = 4;                        // lanes per head
constexpr int kBM = kN / kBQ;                 // state rows n a thread keeps
constexpr int kBThreads = 2 * kBSubs * kWarp;
constexpr int kRec = kP * kN;                 // a (P, N) record, value p * kN + n
constexpr int kRecPad = kRec + 4;             // its stride in shared memory: heads in distinct banks
constexpr int kBRows = 2 * kHeads * kP + kHeads + 2 * kN;  // staged: x, dy, dt, B, C
constexpr int kBOut = kHeads * kP + kHeads + 2 * kN;       // u (then dx), z (then ddt), dB, dC
constexpr int kBComb = 2 * kBSubs * kHeads * kRecPad + kBSubs * kHeads;  // E, F, log2 decays
constexpr int kBSlot = kHeads * kRecPad + kHeads;          // a tile's record pushed in a cluster
constexpr int kBPush = kMaxCluster * kBSlot;
static_assert(kHeads * kBQ == kWarp, "a warp walks one direction of a sub-chunk for the block's heads");

template <typename IO>
struct BArgs {
    const IO* x;
    const IO* dt;
    const IO* A;
    const IO* B;
    const IO* C;
    const IO* D;
    const IO* dy;  // (batch, H, P, L), contiguous
    IO* dx;        // (batch, H, P, L)
    IO* ddt;       // (batch, H, L)
    IO* dB;        // (batch, N, L), where ngrp == 1
    IO* dC;
    float* gB;     // per head group (batch, ngrp, N, L), fp32, where ngrp > 1
    float* gC;
    float* carry;      // (2, batch * H, ntile, P * N): each tile's end state, then the one
                       // entering it; each tile's adjoint from zero in reversed tile order, then
                       // the one entering it from the right
    float* carry_dec;  // (2, batch * H, ntile): the decays across each tile, in the same order
    float* part_dA;    // (H, batch * ntile): per-block sums, reduced in a fixed order
    float* part_dD;
    int64_t sx, sdt, sb, sc;
    int batch, H, L, ntile, nsb, tl, ngrp;
    int vec;  // copies and stores of 4 values
    // The carried form (a segment of a longer sequence), null otherwise:
    // the state entering the segment and the adjoint entering its end,
    // (batch, H, P, N) fp32, and the adjoint leaving its start (out).
    const float* s0;
    const float* lam;
    float* ds0;
};

enum BMode { BSUMMARY, BGRADS, BFUSED };

// Floats of the region after the staged rows: the combine's records (and in
// BFUSED the records other blocks of the cluster push), overlaid by the
// gradients staged for the store; then, but in BSUMMARY, the adjoint
// products at each sub-chunk's end.
template <BMode MODE>
__host__ __device__ __forceinline__ int bwd_region(int rs) {
    const int comb = kBComb + (MODE == BFUSED ? kBPush : 0), out = kBOut * rs;
    return MODE == BSUMMARY ? comb : (out > comb ? out : comb);
}

template <BMode MODE>
size_t bwd_smem_bytes(int tl) {
    const int rs = tl + kPad;
    return sizeof(float) *
           (size_t(kBRows) * rs + bwd_region<MODE>(rs) + (MODE == BSUMMARY ? 0 : kBSubs * kHeads));
}

template <bool REV>
__device__ __forceinline__ int spos(int tl, int s) {
    return REV ? tl - 1 - s : s;
}

// The scan tokens s, s + 1 (s even) of a staged row, in scan order.
template <bool REV>
__device__ __forceinline__ void load2(const float* row, int tl, int s, float (&v)[2]) {
    const float2 q = *reinterpret_cast<const float2*>(row + (REV ? tl - 2 - s : s));
    v[0] = REV ? q.y : q.x;
    v[1] = REV ? q.x : q.y;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Stage `rows` rows of the tile (row r at g + r * L) into s, spread over
// the group's n threads; tokens outside [t.lo, t.hi) and rows from `valid`
// on are zero.
template <typename IO>
__device__ void stage_bwd(float* s, const IO* g, int rows, int valid, const BArgs<IO>& a, Range t,
                          int tid, int n) {
    const int rs = a.tl + kPad, z0 = t.lo - t.base, z1 = t.hi - t.base;
    for_each_of(tid, n, valid, a.tl - (z1 - z0),
                [&](int r, int i) { s[r * rs + (i < z0 ? i : i - z0 + z1)] = 0.f; });
    for_each_of(tid, n, rows - valid, a.tl, [&](int r, int i) { s[(valid + r) * rs + i] = 0.f; });
    copy_rows(s, g + t.lo, valid, z1 - z0, rs, z0, a.L, a.vec, tid, n);
}

// v[0, 2K) summed with the lane l ^ mask: the lane with `upper` keeps the
// sums of v[K, 2K) in v[0, K), the other those of v[0, K). Each sum is
// taken by one lane, in one order.
template <int K>
__device__ __forceinline__ void halve(float* v, int mask, bool upper) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const float send = upper ? v[i] : v[K + i];
        const float keep = upper ? v[K + i] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 1; off < kWarp; off *= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// acc = acc * dec + r, over the thread's values of the record r.
__device__ __forceinline__ void fold(float (&acc)[kBM][kP], const float* r, float dec, int q) {
#pragma unroll
    for (int m = 0; m < kBM; ++m)
#pragma unroll
        for (int p = 0; p < kP; ++p) acc[m][p] = fmaf(acc[m][p], dec, r[p * kN + kBQ * m + q]);
}

// One tile of K2's backward.
//   BSUMMARY: walk each sub-chunk from zero both ways, combine, and write
//     the tile's end state and its adjoint from zero, with its decay.
//   BGRADS: the same walks and combine, then from the state and adjoint
//     that the carry brought to the tile, the gradient walks.
//   BFUSED (at most kMaxCluster tiles, one a block of a cluster): the tiles'
//     records go through the cluster's shared memory; no scratch.
template <typename IO, bool REV, BMode MODE>
__device__ __forceinline__ void bwd_tile(const BArgs<IO>& a) {
    const int k = blockIdx.x, h0 = blockIdx.y * kHeads, b = blockIdx.z;
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    const int w = warp / 2, dir = warp % 2, hh = lane / kBQ, q = lane % kBQ;
    const int nsb = a.nsb, half = nsb * kWarp;  // threads per direction
    const int hn = min(kHeads, a.H - h0), h = h0 + min(hh, hn - 1);
    const int tl = a.tl, rs = tl + kPad, s0 = w * kBT;
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);
    float* dys = xs + kHeads * kP * rs;
    float* dts = dys + kHeads * kP * rs;
    float* Bs = dts + kHeads * rs;
    float* Cs = Bs + kN * rs;
    float* region = Cs + kN * rs;
    float* Ec = region;                            // [sub][head][kRecPad]: end states from zero
    float* Fc = Ec + kBSubs * kHeads * kRecPad;    // adjoints handed left, from zero
    float* ldc = Fc + kBSubs * kHeads * kRecPad;   // [sub][head]: log2 decays
    float* push = region + kBComb;                 // [rank][kBSlot]
    float* Us = region;                            // [head * P][rs]: u, then dx
    float* Zs = Us + kHeads * kP * rs;             // [head][rs]: z, then ddt
    float* dBs = Zs + kHeads * rs;                 // [N][rs]
    float* dCs = dBs + kN * rs;
    float* wend = region + bwd_region<MODE>(rs);   // [sub][head]
    const bool cluster = MODE == BFUSED && a.ntile > 1;
    if (cluster) cluster_arrive_relaxed();  // no block pushes into one that has not started

    // x, dt, B staged by the state walkers, dy and C by the adjoint walkers:
    // each direction starts when its own rows (and dt) are in.
    const Range t = tile_range<REV>(a, k);
    const int td = w * kWarp + lane;
    const int64_t hl = int64_t(h0) * a.L;
    if (dir == 0) {
        stage_bwd(xs, a.x + b * a.sx + hl * kP, kHeads * kP, hn * kP, a, t, td, half);
        stage_bwd(dts, a.dt + b * a.sdt + hl, kHeads, hn, a, t, td, half);
        stage_bwd(Bs, a.B + b * a.sb, kN, kN, a, t, td, half);
    } else {
        stage_bwd(dys, a.dy + int64_t(b) * a.H * kP * a.L + hl * kP, kHeads * kP, hn * kP, a, t,
                  td, half);
        stage_bwd(Cs, a.C + b * a.sc, kN, kN, a, t, td, half);
    }
    const float A2 = to_f(a.A[h]) * kLog2e;
    copy_wait();
    if (dir == 0) {
        bar_arrive(2, 2 * half);
        bar_sync(1, half);
    } else {
        bar_sync(2, 2 * half);
    }

    const float* xr = xs + hh * kP * rs;
    const float* dyr = dys + hh * kP * rs;
    const float* dtr = dts + hh * rs;
    // V: the states (dir 0) or the adjoint handed to the token before (dir 1)
    float V[kBM][kP], ld = 0.f;
#pragma unroll
    for (int m = 0; m < kBM; ++m)
#pragma unroll
        for (int p = 0; p < kP; ++p) V[m][p] = 0.f;

    // 1. The sub-chunk from zero: its end state E_w, or its adjoint F_w
    //    handed to the token before it, and its log2 decay.
    if (dir == 0) {
#pragma unroll 2
        for (int s = s0; s < s0 + kBT; s += 2) {
            float d[2], xv[kP][2], av[2];
            load2<REV>(dtr, tl, s, d);
#pragma unroll
            for (int p = 0; p < kP; ++p) load2<REV>(xr + p * rs, tl, s, xv[p]);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const float e = d[j] * A2;
                av[j] = exp2f(e);
                ld += e;
            }
#pragma unroll
            for (int m = 0; m < kBM; ++m) {
                float bv[2];
                load2<REV>(Bs + (q + kBQ * m) * rs, tl, s, bv);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    const float bd = bv[j] * d[j];
#pragma unroll
                    for (int p = 0; p < kP; ++p) V[m][p] = fmaf(V[m][p], av[j], bd * xv[p][j]);
                }
            }
        }
    } else {
#pragma unroll 2
        for (int s = s0 + kBT - 2; s >= s0; s -= 2) {
            float d[2], gv[kP][2], av[2];
            load2<REV>(dtr, tl, s, d);
#pragma unroll
            for (int p = 0; p < kP; ++p) load2<REV>(dyr + p * rs, tl, s, gv[p]);
#pragma unroll
            for (int j = 0; j < 2; ++j) av[j] = exp2f(d[j] * A2);
#pragma unroll
            for (int m = 0; m < kBM; ++m) {
                float cv[2];
                load2<REV>(Cs + (q + kBQ * m) * rs, tl, s, cv);
#pragma unroll
                for (int j = 1; j >= 0; --j)
#pragma unroll
                    for (int p = 0; p < kP; ++p)
                        V[m][p] = av[j] * fmaf(cv[j], gv[p][j], V[m][p]);
            }
        }
    }
    {
        float* r = (dir == 0 ? Ec : Fc) + (w * kHeads + hh) * kRecPad + q;
#pragma unroll
        for (int m = 0; m < kBM; ++m)
#pragma unroll
            for (int p = 0; p < kP; ++p) r[p * kN + kBQ * m] = V[m][p];
        if (dir == 0 && q == 0) ldc[w * kHeads + hh] = ld;
    }
    __syncthreads();

    // 2. The combine: P, the state entering sub-chunk w from the tile's
    //    start (log2 decay Gl), and Q, the adjoint entering it from the
    //    tile's end (Gr).
    float P[kBM][kP], Q[kBM][kP], Gl = 0.f, Gr = 0.f;
#pragma unroll
    for (int m = 0; m < kBM; ++m)
#pragma unroll
        for (int p = 0; p < kP; ++p) P[m][p] = Q[m][p] = 0.f;
    auto cross_state = [&](int v) {
        const float e2 = ldc[v * kHeads + hh];
        fold(P, Ec + (v * kHeads + hh) * kRecPad, exp2f(e2), q);
        Gl += e2;
    };
    auto cross_adjoint = [&](int v) {
        const float e2 = ldc[v * kHeads + hh];
        fold(Q, Fc + (v * kHeads + hh) * kRecPad, exp2f(e2), q);
        Gr += e2;
    };
    if constexpr (MODE == BSUMMARY) {
        if (hh >= hn) return;
        const int64_t bh = int64_t(b) * a.H + h, nbh = int64_t(a.batch) * a.H;
        if (dir == 0 && w == nsb - 1) {  // the tile's end state
            for (int v = 0; v < nsb; ++v) cross_state(v);
            const int64_t o = bh * a.ntile + k;
            float* r = a.carry + o * kRec + q;
#pragma unroll
            for (int m = 0; m < kBM; ++m)
#pragma unroll
                for (int p = 0; p < kP; ++p) r[p * kN + kBQ * m] = P[m][p];
            if (q == 0) a.carry_dec[o] = exp2f(Gl);
        }
        if (dir == 1 && w == 0) {  // the tile's adjoint, in reversed tile order
            for (int v = nsb - 1; v >= 0; --v) cross_adjoint(v);
            const int64_t o = (nbh + bh) * a.ntile + (a.ntile - 1 - k);
            float* r = a.carry + o * kRec + q;
#pragma unroll
            for (int m = 0; m < kBM; ++m)
#pragma unroll
                for (int p = 0; p < kP; ++p) r[p * kN + kBQ * m] = Q[m][p];
            if (q == 0) a.carry_dec[o] = exp2f(Gr);
        }
        return;
    } else {
        if (dir == 0)
            for (int v = 0; v < w; ++v) cross_state(v);
        for (int v = nsb - 1; v > w; --v) cross_adjoint(v);

        // 3. The state entering the tile (Si) and the adjoint entering it
        //    from the right (Ri).
        float Si[kBM][kP], Ri[kBM][kP];
#pragma unroll
        for (int m = 0; m < kBM; ++m)
#pragma unroll
            for (int p = 0; p < kP; ++p) Si[m][p] = Ri[m][p] = 0.f;
        if (MODE == BGRADS && hh < hn) {
            const int64_t bh = int64_t(b) * a.H + h, nbh = int64_t(a.batch) * a.H;
            const int64_t ks = bh * a.ntile + k, kr = (nbh + bh) * a.ntile + (a.ntile - 1 - k);
            fold(Si, a.carry + ks * kRec, 0.f, q);
            fold(Ri, a.carry + kr * kRec, 0.f, q);
            if (a.s0 != nullptr) {
                // The carried form: the segment's entering state decayed to
                // the tile (the carry left the decay from the segment's start
                // to it in place) and its entering adjoint decayed back from
                // the segment's end, on the records from zero.
                const float dl = a.carry_dec[ks], dr = a.carry_dec[kr];
                const float* s0 = a.s0 + bh * kRec + q;
                const float* lam = a.lam + bh * kRec + q;
#pragma unroll
                for (int m = 0; m < kBM; ++m)
#pragma unroll
                    for (int p = 0; p < kP; ++p) {
                        Si[m][p] = fmaf(s0[p * kN + kBQ * m], dl, Si[m][p]);
                        Ri[m][p] = fmaf(lam[p * kN + kBQ * m], dr, Ri[m][p]);
                    }
            }
        }
        if (cluster) {
            // Push the tile's end state into every later block of the
            // cluster and its adjoint into every earlier one, then take the
            // other tiles' from this block's memory.
            auto grp = cg::this_cluster();
            cluster_wait();
            if ((dir == 0 && w == nsb - 1) || (dir == 1 && w == 0)) {
                float R[kBM][kP];
                const float e2 = ldc[w * kHeads + hh], dv = exp2f(e2);
                const float* own = (dir == 0 ? Ec : Fc) + (w * kHeads + hh) * kRecPad + q;
#pragma unroll
                for (int m = 0; m < kBM; ++m)
#pragma unroll
                    for (int p = 0; p < kP; ++p)
                        R[m][p] = fmaf(dir == 0 ? P[m][p] : Q[m][p], dv, own[p * kN + kBQ * m]);
                const float dec = exp2f((dir == 0 ? Gl : Gr) + e2);
                const int r0 = dir == 0 ? k + 1 : 0, r1 = dir == 0 ? a.ntile : k;
                for (int r = r0; r < r1; ++r) {
                    float* dst = grp.map_shared_rank(push + k * kBSlot, r);
#pragma unroll
                    for (int m = 0; m < kBM; ++m)
#pragma unroll
                        for (int p = 0; p < kP; ++p)
                            dst[hh * kRecPad + p * kN + kBQ * m + q] = R[m][p];
                    if (q == 0) dst[kHeads * kRecPad + hh] = dec;
                }
            }
            grp.sync();
            for (int r = 0; r < k; ++r)
                fold(Si, push + r * kBSlot + hh * kRecPad, push[r * kBSlot + kHeads * kRecPad + hh],
                     q);
            for (int r = a.ntile - 1; r > k; --r)
                fold(Ri, push + r * kBSlot + hh * kRecPad, push[r * kBSlot + kHeads * kRecPad + hh],
                     q);
        }

        // The walks' starts: Q becomes the adjoint entering sub-chunk w from
        // the right, R_w; P the state entering it, S_in. The state walkers
        // take w's end product <R_w, S_in dec_w + E_w>, the adjoint term at
        // the token after the sub-chunk.
        const float dl = exp2f(Gl), dr = exp2f(Gr);
#pragma unroll
        for (int m = 0; m < kBM; ++m)
#pragma unroll
            for (int p = 0; p < kP; ++p) {
                Q[m][p] = fmaf(Ri[m][p], dr, Q[m][p]);
                P[m][p] = fmaf(Si[m][p], dl, P[m][p]);
            }
        if (dir == 0) {
            const float dw = exp2f(ld);
            float e = 0.f;
#pragma unroll
            for (int m = 0; m < kBM; ++m)
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                    e = fmaf(Q[m][p], fmaf(P[m][p], dw, V[m][p]), e);
                    V[m][p] = P[m][p];
                }
            e += __shfl_xor_sync(0xffffffffu, e, 1);
            e += __shfl_xor_sync(0xffffffffu, e, 2);
            if (q == 0) wend[w * kHeads + hh] = e;
        } else {
#pragma unroll
            for (int m = 0; m < kBM; ++m)
#pragma unroll
                for (int p = 0; p < kP; ++p) V[m][p] = Q[m][p];
        }
        __syncthreads();  // the records read before the gradients overwrite them

        // 4. The gradient walks. State walkers: S_t, dC_t = sum_h S_t dy_t
        //    (over the block's heads in the warp) and z_t = C_t . S_t dy_t.
        //    Adjoint walkers: G_t, dB_t = sum_h G_t x_t dt_t and u_t = G_t^T B_t.
        //    Each pair of tokens' partials is summed across lanes after the
        //    pair, off the recurrences: dC and dB over the 8 heads of the warp
        //    (7 shuffles give each lane one of the 32 (n, token) sums), z and u
        //    over the kBQ lanes of a head.
        const int jm = hh & 1, nm = q + kBQ * (hh >> 1);  // the (token, n) a lane keeps
        if (dir == 0) {
#pragma unroll 2
            for (int s = s0; s < s0 + kBT; s += 2) {
                float d[2], xv[kP][2], gv[kP][2], av[2];
                load2<REV>(dtr, tl, s, d);
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                    load2<REV>(xr + p * rs, tl, s, xv[p]);
                    load2<REV>(dyr + p * rs, tl, s, gv[p]);
                }
#pragma unroll
                for (int j = 0; j < 2; ++j) av[j] = exp2f(d[j] * A2);
                float dc[2 * kBM], z[2] = {0.f, 0.f};
#pragma unroll
                for (int m = 0; m < kBM; ++m) {
                    float bv[2], cv[2];
                    load2<REV>(Bs + (q + kBQ * m) * rs, tl, s, bv);
                    load2<REV>(Cs + (q + kBQ * m) * rs, tl, s, cv);
#pragma unroll
                    for (int j = 0; j < 2; ++j) {
                        const float bd = bv[j] * d[j];
                        float c = 0.f;
#pragma unroll
                        for (int p = 0; p < kP; ++p) {
                            V[m][p] = fmaf(V[m][p], av[j], bd * xv[p][j]);
                            c = fmaf(V[m][p], gv[p][j], c);
                        }
                        dc[2 * m + j] = c;
                        z[j] = fmaf(cv[j], c, z[j]);
                    }
                }
                halve<4>(dc, 16, hh & 4);
                halve<2>(dc, 8, hh & 2);
                halve<1>(dc, 4, hh & 1);
                halve<1>(z, 2, q & 2);
                z[0] += __shfl_xor_sync(0xffffffffu, z[0], 1);
                dCs[nm * rs + spos<REV>(tl, s + jm)] = dc[0];
                if ((q & 1) == 0) Zs[hh * rs + spos<REV>(tl, s + (q >> 1))] = z[0];
            }
        } else {
#pragma unroll 2
            for (int s = s0 + kBT - 2; s >= s0; s -= 2) {
                float d[2], xv[kP][2], gv[kP][2], av[2];
                load2<REV>(dtr, tl, s, d);
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                    load2<REV>(xr + p * rs, tl, s, xv[p]);
                    load2<REV>(dyr + p * rs, tl, s, gv[p]);
                }
#pragma unroll
                for (int j = 0; j < 2; ++j) av[j] = exp2f(d[j] * A2);
                float db[2 * kBM], u[2 * kP];
#pragma unroll
                for (int i = 0; i < 2 * kP; ++i) u[i] = 0.f;
#pragma unroll
                for (int m = 0; m < kBM; ++m) {
                    float bv[2], cv[2];
                    load2<REV>(Bs + (q + kBQ * m) * rs, tl, s, bv);
                    load2<REV>(Cs + (q + kBQ * m) * rs, tl, s, cv);
#pragma unroll
                    for (int j = 1; j >= 0; --j) {
                        float c = 0.f;
#pragma unroll
                        for (int p = 0; p < kP; ++p) {
                            const float g = fmaf(cv[j], gv[p][j], V[m][p]);
                            V[m][p] = av[j] * g;
                            c = fmaf(g, xv[p][j], c);
                            u[2 * p + j] = fmaf(g, bv[j], u[2 * p + j]);
                        }
                        db[2 * m + j] = c * d[j];
                    }
                }
                halve<4>(db, 16, hh & 4);
                halve<2>(db, 8, hh & 2);
                halve<1>(db, 4, hh & 1);
                halve<4>(u, 2, q & 2);
                halve<2>(u, 1, q & 1);  // u[j]: column p = q of token s + j
                dBs[nm * rs + spos<REV>(tl, s + jm)] = db[0];
                Us[(hh * kP + q) * rs + spos<REV>(tl, s)] = u[0];
                Us[(hh * kP + q) * rs + spos<REV>(tl, s + 1)] = u[1];
            }
            if (MODE == BGRADS && a.ds0 != nullptr && k == 0 && w == 0 && hh < hn) {
                // a_0 G_0, the adjoint handed to the token before the
                // segment's first: the gradient of its entering state
                float* r = a.ds0 + (int64_t(b) * a.H + h) * kRec + q;
#pragma unroll
                for (int m = 0; m < kBM; ++m)
#pragma unroll
                    for (int p = 0; p < kP; ++p) r[p * kN + kBQ * m] = V[m][p];
            }
        }
        __syncthreads();

        // 5. Per head, a warp, a lane per token of each sub-chunk: with
        //    w_t = a_t <G_t, S_{t-1}> = w_{t+1} + z_t - dt_t x_t . u_t, a
        //    suffix sum within the sub-chunk from its end product,
        //    ddt_t = x_t . u_t + A w_t, dx_t = dt_t u_t + D dy_t, and the
        //    block's sums of dA (dt_t w_t) and dD (x_t . dy_t).
        const int nwarps = blockDim.x / kWarp;
        for (int hf = warp; hf < hn; hf += nwarps) {
            const float Ah = to_f(a.A[h0 + hf]), Dh = to_f(a.D[h0 + hf]);
            float dA = 0.f, dD = 0.f;
            for (int v = 0; v < nsb; ++v) {
                const int i = spos<REV>(tl, v * kBT + lane);
                float uv[kP], xu = 0.f, xg = 0.f;
                const float dtv = dts[hf * rs + i];
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                    const int r = (hf * kP + p) * rs + i;
                    uv[p] = Us[r];
                    xu = fmaf(xs[r], uv[p], xu);
                    xg = fmaf(xs[r], dys[r], xg);
                }
                float e = Zs[hf * rs + i] - dtv * xu;
#pragma unroll
                for (int off = 1; off < kWarp; off *= 2) {
                    const float o = __shfl_down_sync(0xffffffffu, e, off);
                    if (lane + off < kWarp) e += o;
                }
                const float wv = wend[v * kHeads + hf] + e;
                Zs[hf * rs + i] = fmaf(Ah, wv, xu);
#pragma unroll
                for (int p = 0; p < kP; ++p) {
                    const int r = (hf * kP + p) * rs + i;
                    Us[r] = fmaf(dtv, uv[p], Dh * dys[r]);
                }
                dA = fmaf(dtv, wv, dA);
                dD += xg;
            }
            dA = warp_sum(dA);
            dD = warp_sum(dD);
            if (lane == 0) {
                const int64_t o = int64_t(h0 + hf) * a.batch * a.ntile + int64_t(b) * a.ntile + k;
                a.part_dA[o] = dA;
                a.part_dD[o] = dD;
            }
        }
        __syncthreads();

        // 6. dx, ddt, dB and dC of the tile's range, coalesced; dB and dC
        //    of a head group in fp32 where the groups are summed after.
        const int z0 = t.lo - t.base, n = t.hi - t.lo;
        const int64_t L = a.L, o = t.lo;
        store_rows(a.dx + (int64_t(b) * a.H + h0) * kP * L + o, Us, hn * kP, n, rs, z0, L, a.vec);
        store_rows(a.ddt + (int64_t(b) * a.H + h0) * L + o, Zs, hn, n, rs, z0, L, a.vec);
        if (a.ngrp > 1) {
            const int64_t g0 = (int64_t(b) * a.ngrp + blockIdx.y) * kN * L + o;
            store_rows(a.gB + g0, dBs, kN, n, rs, z0, L, a.vec);
            store_rows(a.gC + g0, dCs, kN, n, rs, z0, L, a.vec);
        } else {
            store_rows(a.dB + int64_t(b) * kN * L + o, dBs, kN, n, rs, z0, L, a.vec);
            store_rows(a.dC + int64_t(b) * kN * L + o, dCs, kN, n, rs, z0, L, a.vec);
        }
    }
}

template <typename IO, bool REV>
__global__ void __launch_bounds__(kBThreads, 3) ssd_bwd_summary(BArgs<IO> a) {
    bwd_tile<IO, REV, BSUMMARY>(a);
}

template <typename IO, bool REV>
__global__ void __launch_bounds__(kBThreads, 2) ssd_bwd_grads(BArgs<IO> a) {
    bwd_tile<IO, REV, BGRADS>(a);
}

template <typename IO, bool REV>
__global__ void __launch_bounds__(kBThreads, 2) ssd_bwd_fused(BArgs<IO> a) {
    bwd_tile<IO, REV, BFUSED>(a);
}

// The carry of the tiles' records, the forward's (ssd_carry's body) with
// twice its threads and window (the refiner's 512 tiles in one window), a
// block per (batch, head) and direction: the state entering each tile from
// the left and the adjoint entering it from the right.
constexpr int kBwdCarryThreads = 2 * kCarryThreads;
constexpr int kBwdWindow = 2 * kWindow;
constexpr size_t kBwdCarrySmem = carry_smem(kBwdCarryThreads, kBwdWindow);

__global__ void __launch_bounds__(kBwdCarryThreads) ssd_bwd_carry(float* states, float* decay,
                                                                  int nc) {
    carry<kBwdCarryThreads, kBwdWindow>(states, decay, nc);
}

// The carried form's carry: ssd_bwd_carry's walk from zero, which also
// leaves in place of each tile's decay the decay from the segment's start
// to the tile (states) or from the segment's end back to the tile's end
// (adjoints, in reversed tile order), and writes per (batch, head) and
// direction the segment's record from zero and its decay: the end state,
// and the adjoint handed out of the segment's first token.
__global__ void __launch_bounds__(kBwdCarryThreads) ssd_bwd_carry_segment(float* states,
                                                                          float* decay, int nc,
                                                                          float* fin_state,
                                                                          float* fin_decay) {
    carry<kBwdCarryThreads, kBwdWindow, true>(states, decay, nc, fin_state, fin_decay);
}

// The fixed-order sums, one launch: block j < H sums head j's m per-block
// dA and dD, each thread a strided share in order, then a tree over the
// threads; the blocks after them sum dB and dC over the head groups in
// order (ngrp > 1), from the partials (batch, ngrp, N, L) into (batch, N, L).
// Every sum is fp32, rounded to IO once, when it is stored.
constexpr int kSumBatch = 16;

template <typename IO>
struct BSums {
    const float* part_dA;
    const float* part_dD;
    IO* dA;
    IO* dD;
    const float* pb;
    const float* pc;
    IO* dB;
    IO* dC;
    int64_t m, nl;
    int H, batch, ngrp;
};

template <typename IO>
__global__ void __launch_bounds__(kThreads) ssd_bwd_sums(BSums<IO> s) {
    const int tid = threadIdx.x;
    if (blockIdx.x >= unsigned(s.H)) {
        const int64_t total = int64_t(s.batch) * s.nl;
        const int64_t step = int64_t(gridDim.x - s.H) * blockDim.x;
        for (int64_t e = (blockIdx.x - s.H) * int64_t(blockDim.x) + tid; e < total; e += step) {
            const int64_t b = e / s.nl, i = e % s.nl;
            const float* qb = s.pb + b * s.ngrp * s.nl + i;
            const float* qc = s.pc + b * s.ngrp * s.nl + i;
            float vb = 0.f, vc = 0.f;
            for (int g0 = 0; g0 < s.ngrp; g0 += kSumBatch) {  // kSumBatch groups' loads in flight
                float lb[kSumBatch], lc[kSumBatch];
#pragma unroll
                for (int j = 0; j < kSumBatch; ++j) {
                    const int64_t o = int64_t(min(g0 + j, s.ngrp - 1)) * s.nl;
                    lb[j] = qb[o];
                    lc[j] = qc[o];
                }
#pragma unroll
                for (int j = 0; j < kSumBatch; ++j)
                    if (g0 + j < s.ngrp) {
                        vb += lb[j];
                        vc += lc[j];
                    }
            }
            put(s.dB + e, vb);
            put(s.dC + e, vc);
        }
        return;
    }
    __shared__ float sa[kThreads], sd[kThreads];
    const float* pa = s.part_dA + blockIdx.x * s.m;
    const float* pd = s.part_dD + blockIdx.x * s.m;
    float va = 0.f, vd = 0.f;
    for (int64_t i = tid; i < s.m; i += kThreads) {
        va += pa[i];
        vd += pd[i];
    }
    sa[tid] = va;
    sd[tid] = vd;
    __syncthreads();
    for (int r = kThreads / 2; r > 0; r /= 2) {
        if (tid < r) {
            sa[tid] += sa[tid + r];
            sd[tid] += sd[tid + r];
        }
        __syncthreads();
    }
    if (tid == 0) {
        put(s.dA + blockIdx.x, sa[0]);
        put(s.dD + blockIdx.x, sd[0]);
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    return bytes > 48 * 1024
               ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(bytes))
               : cudaSuccess;
}

// A block per (tile, head group, batch sample), in clusters of `cluster`
// tiles where that is above 1.
template <typename Kernel, typename A>  // Args or BArgs
cudaError_t launch_tiles(Kernel kernel, const A& a, int batch, int threads, size_t smem,
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

template <typename IO, int T, bool REV>
cudaError_t launch(const Args<IO>& a, int batch, int threads, cudaStream_t stream) {
    if (a.ntile <= kMaxCluster)
        return launch_tiles(ssd_scan_fused<IO, T, REV>, a, batch, threads,
                            smem_bytes<FUSED>(a.tl), a.ntile, stream);
    cudaError_t err = launch_tiles(ssd_scan_states<IO, T, REV>, a, batch, threads,
                                   smem_bytes<STATES>(a.tl), 1, stream);
    if (err != cudaSuccess) return err;
    err = allow_smem(ssd_carry, kCarrySmem);
    if (err != cudaSuccess) return err;
    ssd_carry<<<static_cast<unsigned>(int64_t(batch) * a.H), kCarryThreads, kCarrySmem, stream>>>(
        a.tile_state, a.tile_decay, a.ntile);
    err = launch_tiles(ssd_scan_outputs<IO, T, REV>, a, batch, threads,
                       smem_bytes<OUTPUTS>(a.tl), 1, stream);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// The carried form, a segment of a longer sequence, in two phases around
// the exchange of the segments' states (the caller's). With fin_state:
// ssd_scan_states, which writes every sub-chunk's and tile's records in
// any layout, then ssd_carry_segment, which leaves the state entering each
// tile from zero and the decay from the segment's start to it in place and
// writes the segment's end state and decay. Without: ssd_scan_outputs,
// each sub-chunk from the state entering the segment (a.init) decayed to
// it plus its own from zero.
template <typename IO, int T, bool REV>
cudaError_t launch_segment(const Args<IO>& a, int batch, int threads, float* fin_state,
                           float* fin_decay, cudaStream_t stream) {
    if (fin_state == nullptr)
        return launch_tiles(ssd_scan_outputs<IO, T, REV>, a, batch, threads,
                            smem_bytes<OUTPUTS>(a.tl), 1, stream);
    cudaError_t err = launch_tiles(ssd_scan_states<IO, T, REV>, a, batch, threads,
                                   smem_bytes<STATES>(a.tl), 1, stream);
    if (err != cudaSuccess) return err;
    err = allow_smem(ssd_carry_segment, kCarrySmem);
    if (err != cudaSuccess) return err;
    ssd_carry_segment<<<static_cast<unsigned>(int64_t(batch) * a.H), kCarryThreads, kCarrySmem,
                        stream>>>(a.tile_state, a.tile_decay, a.ntile, fin_state, fin_decay);
    return cudaGetLastError();
}

struct BLayout {
    int nsub, nsb, ntile, tl, threads, ngrp;
    int64_t carry, carry_dec, part, groups;  // floats of each scratch region
};

int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }  // regions stay 16-byte aligned

BLayout bwd_layout(int batch, int H, int L, bool segment = false) {
    BLayout s;
    s.nsub = (L + kBT - 1) / kBT;
    s.nsb = std::min(kBSubs, s.nsub);
    s.ntile = (s.nsub + kBSubs - 1) / kBSubs;
    s.tl = s.nsb * kBT;
    s.threads = 2 * s.nsb * kWarp;
    s.ngrp = (H + kHeads - 1) / kHeads;
    const int64_t nbh = int64_t(batch) * H;
    const bool carried = segment || s.ntile > kMaxCluster;
    s.carry = carried ? 2 * nbh * s.ntile * kRec : 0;
    s.carry_dec = carried ? round4(2 * nbh * s.ntile) : 0;
    s.part = round4(nbh * s.ntile);
    s.groups = s.ngrp > 1 ? round4(int64_t(batch) * s.ngrp * kN * L) : 0;
    return s;
}

// The fixed-order sums of dA, dD and, over the head groups, dB and dC.
template <typename IO>
cudaError_t launch_bwd_sums(const BArgs<IO>& a, const BLayout& s, IO* dA, IO* dD,
                            cudaStream_t stream) {
    const int64_t nl = int64_t(kN) * a.L, total = a.batch * nl;
    const int gblocks =
        s.ngrp > 1 ? static_cast<int>(std::min<int64_t>((total + kThreads - 1) / kThreads, 1056))
                   : 0;
    const BSums<IO> sums{a.part_dA, a.part_dD, dA, dD, a.gB, a.gC, a.dB, a.dC,
                         int64_t(a.batch) * s.ntile, nl, a.H, a.batch, s.ngrp};
    ssd_bwd_sums<IO><<<a.H + gblocks, kThreads, 0, stream>>>(sums);
    return cudaGetLastError();
}

// At most kMaxCluster tiles (every 8^2..32^2 Block): ssd_bwd_fused, one
// clustered launch. More (the refiner): ssd_bwd_summary, the carry of the
// tiles' records both ways, ssd_bwd_grads. Then the fixed-order sums.
template <typename IO, bool REV>
cudaError_t launch_bwd(const BArgs<IO>& a, const BLayout& s, IO* dA, IO* dD,
                       cudaStream_t stream) {
    cudaError_t err;
    if (s.ntile <= kMaxCluster) {
        err = launch_tiles(ssd_bwd_fused<IO, REV>, a, a.batch, s.threads,
                           bwd_smem_bytes<BFUSED>(s.tl), s.ntile, stream);
        if (err != cudaSuccess) return err;
    } else {
        err = launch_tiles(ssd_bwd_summary<IO, REV>, a, a.batch, s.threads,
                           bwd_smem_bytes<BSUMMARY>(s.tl), 1, stream);
        if (err != cudaSuccess) return err;
        if ((err = allow_smem(ssd_bwd_carry, kBwdCarrySmem)) != cudaSuccess) return err;
        ssd_bwd_carry<<<static_cast<unsigned>(2 * int64_t(a.batch) * a.H), kBwdCarryThreads,
                        kBwdCarrySmem, stream>>>(a.carry, a.carry_dec, s.ntile);
        err = launch_tiles(ssd_bwd_grads<IO, REV>, a, a.batch, s.threads,
                           bwd_smem_bytes<BGRADS>(s.tl), 1, stream);
        if (err != cudaSuccess) return err;
    }
    return launch_bwd_sums(a, s, dA, dD, stream);
}

// The carried form's phases, on any layout: with fin_state, the summary of
// every tile and the segment carry (the adjoint leaving the segment's
// start from dy alone, for the caller's exchange); without, from a.s0 and
// a.lam, the gradient walks and the sums.
template <typename IO, bool REV>
cudaError_t launch_bwd_segment(const BArgs<IO>& a, const BLayout& s, float* fin_state,
                               float* fin_decay, IO* dA, IO* dD, cudaStream_t stream) {
    cudaError_t err;
    if (fin_state != nullptr) {
        err = launch_tiles(ssd_bwd_summary<IO, REV>, a, a.batch, s.threads,
                           bwd_smem_bytes<BSUMMARY>(s.tl), 1, stream);
        if (err != cudaSuccess) return err;
        if ((err = allow_smem(ssd_bwd_carry_segment, kBwdCarrySmem)) != cudaSuccess) return err;
        ssd_bwd_carry_segment<<<static_cast<unsigned>(2 * int64_t(a.batch) * a.H),
                                kBwdCarryThreads, kBwdCarrySmem, stream>>>(
            a.carry, a.carry_dec, s.ntile, fin_state, fin_decay);
        return cudaGetLastError();
    }
    err = launch_tiles(ssd_bwd_grads<IO, REV>, a, a.batch, s.threads,
                       bwd_smem_bytes<BGRADS>(s.tl), 1, stream);
    if (err != cudaSuccess) return err;
    return launch_bwd_sums(a, s, dA, dD, stream);
}

// p aligned for copies of 4 values of `size` bytes each.
bool aligned4(const void* p, size_t size) {
    return reinterpret_cast<uintptr_t>(p) % (4 * size) == 0;
}

// The walkers' sub-chunk: 32 tokens up to L = 256 (the 8^2 and 16^2
// Blocks: more walkers, shorter walks), else 64 (fewer tiles to carry).
int sub_chunk(int L) { return L <= 256 ? 32 : 64; }

bool bad_shape(int batch, int H, int P, int N, int L, int Q) {
    return P != kP || N != kN || batch <= 0 || H <= 0 || L <= 0 || Q <= 0 || L % Q != 0 ||
           batch > 65535 || (H + kHeads - 1) / kHeads > 65535;
}

template <typename IO>
cudaError_t scan_call(const void* x, const void* dt, const void* A, const void* B, const void* C,
                      const void* D, void* y, float* st, float* dec, int64_t sx, int64_t sdt,
                      int64_t sb, int64_t sc, int batch, int H, int L, int reverse,
                      cudaStream_t strm) {
    const int T = sub_chunk(L);
    const Layout s = layout(L, T);
    const int64_t n = int64_t(batch) * H;
    const bool scratch = s.ntile > kMaxCluster;
    const size_t e = sizeof(IO);
    const bool vec = L % 4 == 0 && sx % 4 == 0 && sdt % 4 == 0 && sb % 4 == 0 && sc % 4 == 0 &&
                     aligned4(x, e) && aligned4(dt, e) && aligned4(B, e) && aligned4(C, e) &&
                     aligned4(y, e);
    const Args<IO> a{static_cast<const IO*>(x), static_cast<const IO*>(dt),
                     static_cast<const IO*>(A), static_cast<const IO*>(B),
                     static_cast<const IO*>(C), static_cast<const IO*>(D),
                     static_cast<IO*>(y),
                     scratch ? st : nullptr,
                     scratch ? dec : nullptr,
                     scratch ? st + n * s.nsub * kN * kP : nullptr,
                     scratch ? dec + n * s.nsub : nullptr,
                     sx, sdt, sb, sc, H, L, s.nsub, s.ntile, s.tl, vec};
    cudaError_t err;
    if (T == 32)
        err = reverse ? launch<IO, 32, true>(a, batch, s.threads, strm)
                      : launch<IO, 32, false>(a, batch, s.threads, strm);
    else
        err = reverse ? launch<IO, 64, true>(a, batch, s.threads, strm)
                      : launch<IO, 64, false>(a, batch, s.threads, strm);
    return err != cudaSuccess ? err : cudaGetLastError();
}

// The carried form's phases (launch_segment): the states with fin_state
// and fin_decay (y null), or the outputs from init. The scratch always
// holds every sub-chunk's and tile's records (adnm_ssd_segment_scratch_floats).
template <typename IO>
cudaError_t segment_call(const void* x, const void* dt, const void* A, const void* B,
                         const void* C, const void* D, void* y, float* st, float* dec,
                         float* fin_state, float* fin_decay, const float* init, int64_t sx,
                         int64_t sdt, int64_t sb, int64_t sc, int batch, int H, int L,
                         int reverse, cudaStream_t strm) {
    const int T = sub_chunk(L);
    const Layout s = layout(L, T);
    const int64_t n = int64_t(batch) * H;
    const size_t e = sizeof(IO);
    const bool vec = L % 4 == 0 && sx % 4 == 0 && sdt % 4 == 0 && sb % 4 == 0 && sc % 4 == 0 &&
                     aligned4(x, e) && aligned4(dt, e) && aligned4(B, e) && aligned4(C, e) &&
                     aligned4(y, e);
    const Args<IO> a{static_cast<const IO*>(x), static_cast<const IO*>(dt),
                     static_cast<const IO*>(A), static_cast<const IO*>(B),
                     static_cast<const IO*>(C), static_cast<const IO*>(D),
                     static_cast<IO*>(y), st, dec, st + n * s.nsub * kN * kP, dec + n * s.nsub,
                     sx, sdt, sb, sc, H, L, s.nsub, s.ntile, s.tl, vec, 1, init};
    cudaError_t err;
    if (T == 32)
        err = reverse ? launch_segment<IO, 32, true>(a, batch, s.threads, fin_state, fin_decay, strm)
                      : launch_segment<IO, 32, false>(a, batch, s.threads, fin_state, fin_decay,
                                                      strm);
    else
        err = reverse ? launch_segment<IO, 64, true>(a, batch, s.threads, fin_state, fin_decay, strm)
                      : launch_segment<IO, 64, false>(a, batch, s.threads, fin_state, fin_decay,
                                                      strm);
    return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename IO>
cudaError_t bwd_call(const void* x, const void* dt, const void* A, const void* B, const void* C,
                     const void* D, const void* dy, void* dx, void* ddt, void* dA, void* dB,
                     void* dC, void* dD, float* f, int64_t sx, int64_t sdt, int64_t sb,
                     int64_t sc, int batch, int H, int L, int reverse, cudaStream_t strm,
                     bool segment = false, float* fin_state = nullptr,
                     float* fin_decay = nullptr, const float* s0 = nullptr,
                     const float* lam = nullptr, float* ds0 = nullptr) {
    const BLayout s = bwd_layout(batch, H, L, segment);
    float* carry = f;
    float* carry_dec = carry + s.carry;
    float* part_dA = carry_dec + s.carry_dec;
    float* part_dD = part_dA + s.part;
    float* group_dB = part_dD + s.part;
    float* group_dC = group_dB + s.groups;
    const size_t e = sizeof(IO);
    const bool grads_aligned =
        s.ngrp > 1 ? aligned4(group_dB, 4) && aligned4(group_dC, 4)
                   : aligned4(dB, e) && aligned4(dC, e);
    const bool vec = L % 4 == 0 && sx % 4 == 0 && sdt % 4 == 0 && sb % 4 == 0 && sc % 4 == 0 &&
                     aligned4(x, e) && aligned4(dt, e) && aligned4(B, e) && aligned4(C, e) &&
                     aligned4(dy, e) && aligned4(dx, e) && aligned4(ddt, e) && grads_aligned;
    const BArgs<IO> a{static_cast<const IO*>(x), static_cast<const IO*>(dt),
                      static_cast<const IO*>(A), static_cast<const IO*>(B),
                      static_cast<const IO*>(C), static_cast<const IO*>(D),
                      static_cast<const IO*>(dy), static_cast<IO*>(dx), static_cast<IO*>(ddt),
                      static_cast<IO*>(dB), static_cast<IO*>(dC), group_dB, group_dC, carry,
                      carry_dec, part_dA, part_dD, sx, sdt, sb, sc, batch, H, L, s.ntile, s.nsb,
                      s.tl, s.ngrp, vec, s0, lam, ds0};
    IO *oA = static_cast<IO*>(dA), *oD = static_cast<IO*>(dD);
    if (segment)
        return reverse ? launch_bwd_segment<IO, true>(a, s, fin_state, fin_decay, oA, oD, strm)
                       : launch_bwd_segment<IO, false>(a, s, fin_state, fin_decay, oA, oD, strm);
    return reverse ? launch_bwd<IO, true>(a, s, oA, oD, strm)
                   : launch_bwd<IO, false>(a, s, oA, oD, strm);
}

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

// x, dt, A, B, C, D and y of one type, float32 (dtype 0) or bfloat16
// (dtype 1), on the current device; y and the fp32 scratch (sizes from
// adnm_ssd_scratch_floats) contiguous. Q is the caller's chunk: the
// result does not depend on it, but L must be a multiple of it. Returns
// cudaGetLastError() after the launches.
int adnm_ssd_chunked_scan(const void* x, const void* dt, const void* A, const void* B,
                          const void* C, const void* D, void* y, void* states, void* decay,
                          int64_t sx, int64_t sdt, int64_t sb, int64_t sc, int batch, int H,
                          int P, int N, int L, int Q, int reverse, int dtype, void* stream) {
    if (bad_shape(batch, H, P, N, L, Q) || (dtype != 0 && dtype != 1))
        return cudaErrorInvalidValue;
    float *st = static_cast<float*>(states), *dec = static_cast<float*>(decay);
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        dtype == 0 ? scan_call<float>(x, dt, A, B, C, D, y, st, dec, sx, sdt, sb, sc, batch, H, L,
                                      reverse, strm)
                   : scan_call<bf16>(x, dt, A, B, C, D, y, st, dec, sx, sdt, sb, sc, batch, H, L,
                                     reverse, strm);
    return static_cast<int>(err);
}


// Floats of scratch the carried form needs, in any layout: states (batch,
// H, nsub + ntile, P, N) and decays (batch, H, nsub + ntile).
int adnm_ssd_segment_scratch_floats(int batch, int H, int L, int64_t* states, int64_t* decay) {
    if (batch <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
    const Layout s = layout(L, sub_chunk(L));
    const int64_t n = int64_t(batch) * H * (s.nsub + s.ntile);
    *states = n * kN * kP;
    *decay = n;
    return cudaSuccess;
}

// The carried form's first phase, on the inputs of adnm_ssd_chunked_scan and
// the scratch of adnm_ssd_segment_scratch_floats: the segment's states from
// zero, its end state (batch, H, P, N) into fin_state and its decay
// exp(sum dt A) (batch, H) into fin_decay, both fp32. The scratch then holds
// what the second phase reads.
int adnm_ssd_scan_segment_states(const void* x, const void* dt, const void* A, const void* B,
                                 const void* C, const void* D, void* states, void* decay,
                                 void* fin_state, void* fin_decay, int64_t sx, int64_t sdt,
                                 int64_t sb, int64_t sc, int batch, int H, int P, int N, int L,
                                 int Q, int reverse, int dtype, void* stream) {
    if (bad_shape(batch, H, P, N, L, Q) || (dtype != 0 && dtype != 1))
        return cudaErrorInvalidValue;
    float *st = static_cast<float*>(states), *dec = static_cast<float*>(decay);
    float *fs = static_cast<float*>(fin_state), *fd = static_cast<float*>(fin_decay);
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        dtype == 0 ? segment_call<float>(x, dt, A, B, C, D, nullptr, st, dec, fs, fd, nullptr, sx,
                                         sdt, sb, sc, batch, H, L, reverse, strm)
                   : segment_call<bf16>(x, dt, A, B, C, D, nullptr, st, dec, fs, fd, nullptr, sx,
                                        sdt, sb, sc, batch, H, L, reverse, strm);
    return static_cast<int>(err);
}

// The carried form's second phase, after adnm_ssd_scan_segment_states on the
// same inputs and scratch: y of the segment with init (batch, H, P, N),
// fp32, contiguous, the state entering its first token in scan order.
int adnm_ssd_scan_carried_outputs(const void* x, const void* dt, const void* A, const void* B,
                                  const void* C, const void* D, void* y, void* states,
                                  void* decay, const void* init, int64_t sx, int64_t sdt,
                                  int64_t sb, int64_t sc, int batch, int H, int P, int N, int L,
                                  int Q, int reverse, int dtype, void* stream) {
    if (bad_shape(batch, H, P, N, L, Q) || (dtype != 0 && dtype != 1) || init == nullptr)
        return cudaErrorInvalidValue;
    float *st = static_cast<float*>(states), *dec = static_cast<float*>(decay);
    const float* in = static_cast<const float*>(init);
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        dtype == 0 ? segment_call<float>(x, dt, A, B, C, D, y, st, dec, nullptr, nullptr, in, sx,
                                         sdt, sb, sc, batch, H, L, reverse, strm)
                   : segment_call<bf16>(x, dt, A, B, C, D, y, st, dec, nullptr, nullptr, in, sx,
                                        sdt, sb, sc, batch, H, L, reverse, strm);
    return static_cast<int>(err);
}

// Floats of scratch K2's backward needs: the tiles' carried states and
// adjoints with their decays (none where the tiles fit one cluster), the
// per-block sums of dA and dD, and per head group dB and dC (none up to
// kHeads heads); each region a multiple of 4 floats.
int adnm_ssd_backward_scratch_floats(int batch, int H, int L, int64_t* floats) {
    if (batch <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
    const BLayout s = bwd_layout(batch, H, L);
    *floats = s.carry + s.carry_dec + 2 * s.part + 2 * s.groups;
    return cudaSuccess;
}

// K2's backward: dx, ddt (contiguous, x's and dt's shapes), dA, dD (H),
// dB, dC (contiguous (batch, N, L)) of the scan for dy (contiguous, x's
// shape); x, dt, B, C at the batch strides given, as in the forward; every
// input and output of one type, float32 (dtype 0) or bfloat16 (dtype 1);
// the fp32 scratch sized by adnm_ssd_backward_scratch_floats. Every output
// is written, none accumulated into; no atomics, so two launches are
// bit-equal. Returns cudaGetLastError() after the launches.
int adnm_ssd_chunked_scan_backward(const void* x, const void* dt, const void* A, const void* B,
                                   const void* C, const void* D, const void* dy, void* dx,
                                   void* ddt, void* dA, void* dB, void* dC, void* dD,
                                   void* scratch, int64_t sx, int64_t sdt, int64_t sb, int64_t sc,
                                   int batch, int H, int P, int N, int L, int Q, int reverse,
                                   int dtype, void* stream) {
    if (bad_shape(batch, H, P, N, L, Q) || (dtype != 0 && dtype != 1))
        return cudaErrorInvalidValue;
    float* f = static_cast<float*>(scratch);
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        dtype == 0 ? bwd_call<float>(x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, f, sx, sdt,
                                     sb, sc, batch, H, L, reverse, strm)
                   : bwd_call<bf16>(x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, f, sx, sdt,
                                    sb, sc, batch, H, L, reverse, strm);
    return static_cast<int>(err);
}

// Floats of scratch K2's carried backward needs, in any layout: the
// backward's (adnm_ssd_backward_scratch_floats) with the tiles' records
// and their decays always present.
int adnm_ssd_segment_backward_scratch_floats(int batch, int H, int L, int64_t* floats) {
    if (batch <= 0 || H <= 0 || L <= 0) return cudaErrorInvalidValue;
    const BLayout s = bwd_layout(batch, H, L, true);
    *floats = s.carry + s.carry_dec + 2 * s.part + 2 * s.groups;
    return cudaSuccess;
}

// The carried backward's first phase, on the inputs of
// adnm_ssd_chunked_scan_backward and the scratch of
// adnm_ssd_segment_backward_scratch_floats: every tile's records from
// zero and their carry. fin_state (2, batch, H, P, N) and fin_decay (2,
// batch, H), fp32, take per direction the segment's record from zero and
// its decay: [0] the end state, [1] the adjoint leaving the segment's first
// token in scan order when none enters its end (from dy alone). The
// scratch then holds what the second phase reads.
int adnm_ssd_segment_adjoint(const void* x, const void* dt, const void* A, const void* B,
                             const void* C, const void* D, const void* dy, void* scratch,
                             void* fin_state, void* fin_decay, int64_t sx, int64_t sdt,
                             int64_t sb, int64_t sc, int batch, int H, int P, int N, int L, int Q,
                             int reverse, int dtype, void* stream) {
    if (bad_shape(batch, H, P, N, L, Q) || (dtype != 0 && dtype != 1) || fin_state == nullptr ||
        fin_decay == nullptr)
        return cudaErrorInvalidValue;
    float* f = static_cast<float*>(scratch);
    float *fs = static_cast<float*>(fin_state), *fd = static_cast<float*>(fin_decay);
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        dtype == 0 ? bwd_call<float>(x, dt, A, B, C, D, dy, nullptr, nullptr, nullptr, nullptr,
                                     nullptr, nullptr, f, sx, sdt, sb, sc, batch, H, L, reverse,
                                     strm, true, fs, fd)
                   : bwd_call<bf16>(x, dt, A, B, C, D, dy, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, f, sx, sdt, sb, sc, batch, H, L, reverse,
                                    strm, true, fs, fd);
    return static_cast<int>(err);
}

// The carried backward's second phase, after adnm_ssd_segment_adjoint on
// the same inputs and scratch: the outputs of adnm_ssd_chunked_scan_backward
// with s0, the state entering the segment, and lam, the adjoint entering its
// end (the gradient of its final state), both (batch, H, P, N) fp32
// contiguous; ds0 (batch, H, P, N) fp32 takes the gradient of s0. From s0 =
// lam = 0 the gradients are the backward's.
int adnm_ssd_segment_backward(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* D, const void* dy, void* dx, void* ddt,
                              void* dA, void* dB, void* dC, void* dD, void* ds0, void* scratch,
                              const void* s0, const void* lam, int64_t sx, int64_t sdt,
                              int64_t sb, int64_t sc, int batch, int H, int P, int N, int L,
                              int Q, int reverse, int dtype, void* stream) {
    if (bad_shape(batch, H, P, N, L, Q) || (dtype != 0 && dtype != 1) || s0 == nullptr ||
        lam == nullptr || ds0 == nullptr)
        return cudaErrorInvalidValue;
    float* f = static_cast<float*>(scratch);
    const float *i0 = static_cast<const float*>(s0), *il = static_cast<const float*>(lam);
    float* o0 = static_cast<float*>(ds0);
    const cudaStream_t strm = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        dtype == 0 ? bwd_call<float>(x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, f, sx, sdt,
                                     sb, sc, batch, H, L, reverse, strm, true, nullptr, nullptr,
                                     i0, il, o0)
                   : bwd_call<bf16>(x, dt, A, B, C, D, dy, dx, ddt, dA, dB, dC, dD, f, sx, sdt,
                                    sb, sc, batch, H, L, reverse, strm, true, nullptr, nullptr,
                                    i0, il, o0);
    return static_cast<int>(err);
}

const char* adnm_ssd_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
