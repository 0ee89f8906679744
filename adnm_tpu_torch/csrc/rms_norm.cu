// RMS normalisation over one axis, its backward, and the gated variant,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of adnm_tpu/ops/pallas/fused_norm.py:
//
//   K1  rms_norm_pallas (:57; _row_call with _rms_kernel):
//         y = x * rsqrt(mean(x^2) + eps) * w        adnm_rms_norm
//   K3  gated_rms_norm_pallas (:63; _row_call with _gated_rms_kernel):
//         g = x * silu(z);  y = g * rsqrt(mean(g^2) + eps) * w
//                                                   adnm_gated_rms_norm
//
// with the statistics in fp32 and y in x's dtype. The Pallas kernels have
// no VJP; both backwards here are new. K1's (the port trains through the
// Block norms), adnm_rms_norm_backward:
//
//   r = rsqrt(mean_c(x^2) + eps),  gw = dy * w
//   dx = r * gw - x * r^3 * mean_c(gw * x)      (in x's dtype)
//   dw_c = sum over every position of dy * x * r (fp32)
//
// and K3's, on the last axis only (the JAX GatedRMSNorm's, whose gradient
// is XLA's), adnm_gated_rms_norm_backward: K1's formula applied to
// g = x * silu(z), with r from g, then
//
//   dg = r * gw - g * r^3 * mean_c(gw * g)
//   dx = dg * silu(z),  dz = dg * x * s * (1 + z * (1 - s)),  s = sigmoid(z)
//   dw_c = sum over every row of dy * g * r (fp32)
//
// The wrappers (adnm_tpu_torch/ops/rms_norm.py) view a contiguous tensor
// as (outer, C, inner) and normalise over C:
//
//   * inner == 1, the Pallas contract (rows of the last axis; K3's rows
//     at the refiner are (B*L, d), d = 32 or 64). See "The row path".
//   * inner > 1, NCHW with C at stride inner: the port's 20 Block norms of
//     a forward, at (1, 32, 256^2) in the refiner and (1, 128..1024,
//     32^2..8^2) in the encoder and decoder.
//
// The row path. A row of d = 32 fp32 is 128 bytes, so a norm of 262,144
// rows moves 96-192 MiB forward and 160-320 MiB backward: bytes bound it,
// 30-100 us at 3.35 TB/s. One warp per row (the first version) issued
// 4-byte loads, waited through a 5-step shuffle chain with nothing else in
// flight, and read x and z twice; it reached 10-55 % of the bound. Now,
// where a row is at most 32 packs of 16 bytes (V = 4 fp32 or 8 bf16
// values; V = 1 where d % V != 0 or a pointer is not 16-byte aligned):
//
//   * tpr = d / V threads (rounded up to a power of 2) take a row, one
//     pack each; a block's 256 threads take 256 / tpr rows in each of
//     kRowSlots slots, so a warp reads 512 neighbouring bytes per slot and
//     input. A thread issues the loads of all its slots before its first
//     sum, and its sums are xor shuffles over its row's tpr lanes only
//     (log2(tpr) steps, the slots interleaved).
//   * The values stay in registers from the load to the store: x, z (and
//     dy) are read once and the gate is computed once per element.
//   * A persistent grid (kRowBlocksPerSM, kRowBwdBlocksPerSM blocks per SM,
//     chosen by timing on the H100) walks the tiles, so each thread keeps
//     its pack's columns, and loads its weights once. Chosen from 2 or 4
//     slots and 2-8 (forward) and 1-4 (backward) blocks per SM; 4 slots,
//     or 4 backward blocks per SM, make the bf16 backward spill.
//   * The backward keeps each thread's dw terms in registers over its
//     tiles, adds them across the block in a fixed order and writes one
//     row of `partial` per block (below).
//   * Rows of more than 32 packs (d > 128 fp32 or 256 bf16 aligned) keep
//     one warp per row.
//
// What bounds the strided path on this card. At 8^2..32^2 a norm moves
// 0.25-4 MiB in the forward and 0.4-6 MiB in the backward (0.08-1.25 us
// and 0.12-1.88 us at 3.35 TB/s): launch latency, the chain of dependent
// steps inside a block and how many of the 132 SMs take part bound it, not
// bytes: a block per tile of 32 positions would give (1, 1024, 8, 8) two
// blocks, each walking 1,024 channels.
// At the refiner's (B, 32, 256^2) bytes bound it: 16 MiB (forward) or 24
// MiB (backward) per sample, 5.0 and 7.5 us.
//
// The split, chosen on the host from (outer, C, inner) (choose_split):
//
//   * A unit is a tile of tx * V neighbouring positions of one outer
//     index. Thread (ty, px) = (tid / tx, tid % tx) of a block's 256 takes
//     V positions and up to 8 channels ty, ty + 256 / tx, ... Its values
//     stay in registers between the statistics and the output, so x (and
//     dy) are read from device memory once. Where inner % V == 0 and every
//     pointer is 16-byte aligned (tested on the address, not on
//     contiguity), V is 16 bytes of the dtype (4 fp32, 8 bf16) and each
//     load and store moves 16 bytes; otherwise V = 1, the same kernel.
//   * Where one block per unit leaves the card idle, a thread cluster of
//     k <= 8 blocks shares a unit: block `rank` takes channels
//     [rank * slice, (rank + 1) * slice), slice = C / k. Each block sums
//     its channels and writes the sums into the shared memory of every
//     block of its cluster (distributed shared memory); after one cluster
//     barrier each block adds them in rank order from its own memory, so
//     no block waits for the others at its exit. The cluster barrier it
//     arrives at on entry is waited for only before the first such write,
//     behind the loads.
//   * The host aims at min(1 per SM, max(64, one 16-byte vector per
//     thread)) blocks. It takes no cluster where tiles of at least 4
//     threads with at most 4 channels a thread give a quarter of that
//     (the 32^2 and 16^2 Blocks of 128 and 256 channels: 32 and 16
//     blocks); else the widest tile (tx from 32 down to 1), then the
//     smallest cluster, with at most 8 channels a thread, that reach it
//     (the 8^2 Blocks: tiles of 8 positions, clusters of 8, 64 blocks; the
//     refiner: tiles of 128 positions, no cluster). The order and the
//     targets were chosen from timings of the alternatives on the H100.
//   * Sums in a fixed order: xor shuffles across the warp's rows, the
//     block's 8 warps in order, the cluster's blocks in rank order.
//   * Channels too many for registers (C > 16,384, forward only) are read
//     again for the output in chunks of 8 per thread.
//
// dw without atomics on values: the strided backward runs a grid fixed by
// the shape and the SM count (at most 2 blocks per SM, each cluster walking
// its units in a fixed order and loading the next unit's x and dy under
// the current one's sums), keeps each channel's sum in a register of the
// thread that owns it, and writes one fp32 row of C per cluster into a
// (rows, C) scratch; rms_norm_dw_reduce adds the rows in a fixed order, so
// dw is bit-equal from launch to launch. Folding that sum into the same
// launch (the last block to take a ticket after a __threadfence adds the
// rows) timed slower on the H100 at every shape tried: the fence, the
// ticket and one block's sum cost more than the second launch.
//
// Built by adnm_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes: each entry point returns the launch's error
// or cudaGetLastError(), and the wrappers raise if it is not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ float load_f32(const T* p) { return to_f32(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kWarp = 32;
constexpr int kThreads = 256;             // threads of every block
constexpr int kWarps = kThreads / kWarp;  // 8
constexpr int kRowsPerBlock = kWarps;     // row kernels: one warp per row
constexpr int kMaxCluster = 8;            // the portable cluster size
constexpr int kMaxNC = 8;                 // channels a thread keeps in registers
constexpr int kBlocksPerSM = 1;           // the split's target of blocks
constexpr int64_t kMinBlocks = 64;       // ... but at least this, where the shape has them
constexpr int kBwdBlocksPerSM = 2;        // the strided backward's largest grid
constexpr int kReduceRows = 32;           // threadIdx.y extent of the dw reduction
constexpr int64_t kMaxRowBwdBlocks = 1024;  // the warp-per-row backward's largest grid
constexpr int64_t kMaxRowsD = 1536;       // backward rows: 8 warps x d fp32 in 48 KB
constexpr int kRowSlots = 2;              // packed row kernels: rows a thread takes per tile
constexpr int kRowBlocksPerSM = 4;        // ... the forward's persistent grid
constexpr int kRowBwdBlocksPerSM = 2;     // ... the backward's
constexpr int64_t kMaxStridedC = int64_t{kMaxCluster} * kMaxNC * kThreads;  // 16,384

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
    T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load_pack(const T* p, float (&out)[V]) {
    const Pack<T, V> pk = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = to_f32(pk.v[v]);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, const float (&in)[V]) {
    Pack<T, V> pk;
#pragma unroll
    for (int v = 0; v < V; ++v) store_f32(&pk.v[v], in[v]);
    *reinterpret_cast<Pack<T, V>*>(p) = pk;
}

// The fast exp and reciprocal: a few ulp of the gate, far inside the
// tolerance of the kernels' comparisons with their plain versions.
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float silu_gate(float v, float g) { return v * (g * sigmoid(g)); }

// dx and dz of g = x * silu(z), for dg, the gradient of g; s = sigmoid(z).
__device__ __forceinline__ void gate_backward(float xv, float zv, float s, float dg, float& dx,
                                              float& dz) {
    dx = dg * (zv * s);
    dz = dg * xv * s * (1.f + zv * (1.f - s));
}

// The normalised input at x[at]: x itself (K1) or x * silu(z) (K3).
template <typename T, bool kGated>
__device__ __forceinline__ float load_in(const T* __restrict__ x, const T* __restrict__ z,
                                         int64_t at) {
    const float v = load_f32(x + at);
    if constexpr (kGated) {
        return silu_gate(v, load_f32(z + at));
    } else {
        return v;
    }
}

// V values of the normalised input from x[at] on, or zeros where !ok.
template <typename T, int V, bool kGated>
__device__ __forceinline__ void load_in_pack(const T* x, const T* z, int64_t at, bool ok,
                                             float (&out)[V]) {
    if (!ok) {
#pragma unroll
        for (int v = 0; v < V; ++v) out[v] = 0.f;
        return;
    }
    load_pack<T, V>(x + at, out);
    if constexpr (kGated) {
        float g[V];
        load_pack<T, V>(z + at, g);
#pragma unroll
        for (int v = 0; v < V; ++v) out[v] = silu_gate(out[v], g[v]);
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// ---- the strided path's split ---------------------------------------------

// How a launch cuts (outer, C, inner) when inner > 1 (see the note above).
struct Split {
    int64_t C, inner;
    int64_t tiles;   // units per outer index, of tx * V positions each
    int64_t units;   // outer * tiles
    int64_t slice;   // channels of each block of a cluster
    int tx;          // threads along the positions; 256 / tx along the channels
    int k;           // blocks of a cluster
    int nc;          // channels a thread keeps, 1, 2, 4 or 8
    int chunks;      // rounds of nc channels (forward only, > 1 above 16,384)
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

int pow2_at_least(int64_t n) {
    int p = 1;
    while (p < n) p *= 2;
    return p;
}

Split choose_split(int64_t outer, int64_t C, int64_t inner, int V, int sms) {
    const int64_t vectors = outer * C * ceil_div(inner, V);
    int64_t target = vectors / kThreads > kMinBlocks ? vectors / kThreads : kMinBlocks;
    if (target > int64_t{kBlocksPerSM} * sms) target = int64_t{kBlocksPerSM} * sms;
    const int64_t padded = ceil_div(inner, V) * V;
    Split best{};
    bool found = false;
    // No cluster where rows of at least 4 threads, each with at most 4
    // channels, reach a quarter of the target: no cluster barrier to wait for.
    for (int tx = kWarp; tx >= 4; tx /= 2) {
        const int64_t tw = int64_t{tx} * V;
        if (tw / 2 >= padded) continue;
        const int64_t tiles = ceil_div(inner, tw), nc = ceil_div(C, kThreads / tx);
        const Split s{C, inner, tiles, outer * tiles, C, tx, 1, pow2_at_least(nc), 1};
        if (nc <= 4 && s.units * 4 >= target) return s;
    }
    for (int tx = kWarp; tx >= 1; tx /= 2) {
        const int64_t tw = int64_t{tx} * V;
        if (tx > 1 && tw / 2 >= padded) continue;  // half the tile would cover inner
        const int cy = kThreads / tx;
        const int64_t tiles = ceil_div(inner, tw);
        for (int k = 1; k <= kMaxCluster; k *= 2) {
            const int64_t slice = ceil_div(C, k);
            if (k > 1 && slice < cy / 2) continue;  // most of the block's rows idle
            const int64_t nc = ceil_div(slice, cy);
            if (nc > kMaxNC) continue;
            const Split s{C, inner, tiles, outer * tiles, slice, tx, k, pow2_at_least(nc), 1};
            if (s.units * k >= target) return s;
            if (!found || s.units * k > best.units * best.k) best = s;
            found = true;
        }
    }
    if (found) return best;
    // More channels than registers hold: the forward reads them in chunks.
    const int64_t slice = ceil_div(C, kMaxCluster);
    const int chunks = static_cast<int>(ceil_div(ceil_div(slice, kThreads), kMaxNC));
    return Split{C, inner, ceil_div(inner, V), outer * ceil_div(inner, V), slice, 1,
                 kMaxCluster, kMaxNC, chunks};
}

// ---- the row path's split ---------------------------------------------------

// How the packed row kernels cut (rows, d), V dividing d: tile t holds rows
// t * groups * kRowSlots on; its slot s, rows s * groups on, one per group
// of tpr threads. tpr == 0: a row is wider than a warp's packs.
struct RowSplit {
    int64_t rows, d;
    int64_t tiles;
    int tpr;     // threads of a row, a power of 2 <= 32
    int npk;     // packs of a row, d / V; lanes npk..tpr-1 of a row idle
    int groups;  // rows of a slot, 256 / tpr
};

RowSplit row_split(int64_t rows, int64_t d, int V) {
    const int64_t npk = d / V;
    if (npk > kWarp) return RowSplit{rows, d, 0, 0, 0, 0};
    const int tpr = pow2_at_least(npk);
    const int groups = kThreads / tpr;
    return RowSplit{rows, d, ceil_div(rows, int64_t{groups} * kRowSlots), tpr,
                    static_cast<int>(npk), groups};
}

// Shared memory of the unit sums of S statistics over tiles of 32 * V
// positions at most.
template <int S, int V>
struct TileSmem {
    float part[S][kWarps][kWarp * V];  // per warp
    // The sums of the cluster's blocks, by rank, written by each block into
    // every block of its cluster; two, as a block may run one unit ahead.
    float got[2][kMaxCluster][S][kWarp * V];
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// acc[s][v], this thread's sums over its channels at its position v,
// becomes the sum over all C channels of the cluster's unit. Fixed order:
// xor shuffles across the rows of a warp, the 8 warps in index order, the
// cluster's blocks in rank order. A block pushes its sums into the shared
// memory of every block of its cluster before one cluster barrier, so that
// no block reads another's memory after it and none waits at its exit.
// `started`: false until the cluster barrier that the kernel arrived at on
// entry (no block writes into a block that has not started) was waited for.
template <int S, int V>
__device__ __forceinline__ void unit_sums(float (&acc)[S][V], TileSmem<S, V>& sm, int tx, int k,
                                          int rank, int buf, bool& started) {
    const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
    const int tw = tx * V;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
            float a = acc[s][v];
            for (int off = kWarp / 2; off >= tx; off /= 2) a += __shfl_xor_sync(0xffffffffu, a, off);
            if (lane < tx) sm.part[s][warp][lane * V + v] = a;  // lane == px on the warp's first row
        }
    }
    __syncthreads();
    if (k > 1 && !started) {
        cluster_wait();
        started = true;
    }
    if (tid < tw) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
            float b = 0.f;
#pragma unroll
            for (int q = 0; q < kWarps; ++q) b += sm.part[s][q][tid];
            if (k == 1) {
                sm.got[buf][0][s][tid] = b;
            } else {
                cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
                for (int q = 0; q < kMaxCluster; ++q)
                    if (q < k) *cluster.map_shared_rank(&sm.got[buf][rank][s][tid], q) = b;
            }
        }
    }
    if (k > 1) {
        cg::this_cluster().sync();
    } else {
        __syncthreads();
    }
    const int px = tid % tx;
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
            float t = 0.f;
#pragma unroll
            for (int r = 0; r < kMaxCluster; ++r)
                if (r < k) t += sm.got[buf][r][s][px * V + v];
            acc[s][v] = t;
        }
    }
}

// dw[c] = sum over blocks of partial[block][c], in a fixed order: thread
// (x, y) sums rows y, y + 32, ... of column c, then row 0 adds the 32 sums.
__global__ void rms_norm_dw_reduce(const float* __restrict__ partial, float* __restrict__ dw,
                                   int64_t blocks, int64_t C) {
    __shared__ float part[kReduceRows][kWarp + 1];
    const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarp + threadIdx.x;
    float s = 0.f;
    if (c < C)
        for (int64_t p = threadIdx.y; p < blocks; p += kReduceRows) s += partial[p * C + c];
    part[threadIdx.y][threadIdx.x] = s;
    __syncthreads();
    if (threadIdx.y == 0 && c < C) {
        float total = 0.f;
#pragma unroll
        for (int k = 0; k < kReduceRows; ++k) total += part[k][threadIdx.x];
        dw[c] = total;
    }
}

// ---- forward -----------------------------------------------------------

// inner == 1, rows of more than 32 packs: x is (rows, d), one warp per row.
template <typename T, bool kGated>
__global__ void rms_norm_rows(const T* __restrict__ x, const T* __restrict__ z,
                              const float* __restrict__ w, T* __restrict__ y, int64_t rows,
                              int64_t d, float eps) {
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (row >= rows) return;  // uniform across the warp
    const int64_t base = row * d;
    float ss = 0.f;
    for (int64_t c = lane; c < d; c += kWarp) {
        const float v = load_in<T, kGated>(x, z, base + c);
        ss += v * v;
    }
    ss = warp_sum(ss);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    for (int64_t c = lane; c < d; c += kWarp)
        store_f32(y + base + c, load_in<T, kGated>(x, z, base + c) * r * w[c]);
}

// Each of S sums over the tpr lanes of its row (tpr a power of 2 <= 32, a
// row on an aligned group of lanes), the S chains interleaved; every lane
// of the row gets the same bits.
template <int S>
__device__ __forceinline__ void row_sums(float (&a)[S], int tpr) {
    for (int off = tpr / 2; off > 0; off /= 2) {
#pragma unroll
        for (int s = 0; s < S; ++s) a[s] += __shfl_xor_sync(0xffffffffu, a[s], off);
    }
}

// Where a thread's kRowSlots packs of tile t lie, and whether each is in
// the tensor.
struct RowPacks {
    int64_t at[kRowSlots];
    bool ok[kRowSlots];
};

__device__ __forceinline__ RowPacks row_packs(const RowSplit& sp, int64_t t, int grp,
                                              int64_t col, bool col_ok) {
    RowPacks p;
#pragma unroll
    for (int s = 0; s < kRowSlots; ++s) {
        const int64_t row = (t * kRowSlots + s) * sp.groups + grp;
        p.at[s] = row * sp.d + col;
        p.ok[s] = col_ok && row < sp.rows;
    }
    return p;
}

// inner == 1, rows of at most 32 packs (RowSplit): thread (grp, q) =
// (tid / tpr, tid % tpr) keeps pack q's weights and walks tiles
// blockIdx.x, + gridDim.x, ...
template <typename T, int V, bool kGated>
__global__ void __launch_bounds__(kThreads, kRowBlocksPerSM)
    rms_norm_rows_packed(const T* __restrict__ x, const T* __restrict__ z,
                         const float* __restrict__ w, T* __restrict__ y, RowSplit sp, float eps) {
    const int q = threadIdx.x % sp.tpr, grp = threadIdx.x / sp.tpr;
    const bool col_ok = q < sp.npk;
    const int64_t col = int64_t{q} * V;
    float wv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) wv[v] = col_ok ? w[col + v] : 0.f;
    const float inv_d = 1.f / static_cast<float>(sp.d);
    for (int64_t t = blockIdx.x; t < sp.tiles; t += gridDim.x) {
        const RowPacks p = row_packs(sp, t, grp, col, col_ok);
        float xv[kRowSlots][V], zv[kRowSlots][V];
#pragma unroll
        for (int s = 0; s < kRowSlots; ++s) {
            load_in_pack<T, V, false>(x, nullptr, p.at[s], p.ok[s], xv[s]);
            if constexpr (kGated) load_in_pack<T, V, false>(z, nullptr, p.at[s], p.ok[s], zv[s]);
        }
        float ss[kRowSlots];
#pragma unroll
        for (int s = 0; s < kRowSlots; ++s) {
            ss[s] = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                if constexpr (kGated) xv[s][v] = silu_gate(xv[s][v], zv[s][v]);
                ss[s] += xv[s][v] * xv[s][v];
            }
        }
        row_sums<kRowSlots>(ss, sp.tpr);
#pragma unroll
        for (int s = 0; s < kRowSlots; ++s) {
            const float r = rsqrtf(ss[s] * inv_d + eps);
            float out[V];
#pragma unroll
            for (int v = 0; v < V; ++v) out[v] = xv[s][v] * r * wv[v];
            if (p.ok[s]) store_pack<T, V>(y + p.at[s], out);
        }
    }
}

// inner > 1: x is (outer, C, inner), cut as `sp` says; blockIdx.x =
// cluster * k + rank, one unit per cluster.
template <typename T, int V, int NC, bool kGated>
__global__ void __launch_bounds__(kThreads)
    rms_norm_tiles(const T* __restrict__ x, const T* __restrict__ z, const float* __restrict__ w,
                   T* __restrict__ y, Split sp, float eps) {
    __shared__ TileSmem<1, V> sm;
    const int tx = sp.tx, cy = kThreads / tx, k = sp.k;
    const int px = threadIdx.x % tx, ty = threadIdx.x / tx, rank = blockIdx.x % k;
    const int units = static_cast<int>(sp.units), tiles = static_cast<int>(sp.tiles);
    const int64_t c_first = rank * sp.slice + ty;
    const int64_t c_end = sp.C < (rank + 1) * sp.slice ? sp.C : (rank + 1) * sp.slice;
    const float inv_c = 1.f / static_cast<float>(sp.C);
    bool started = k == 1;
    if (!started) cluster_arrive_relaxed();
    float wv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
        const int64_t c = c_first + int64_t{cy} * j;
        wv[j] = c < c_end ? w[c] : 0.f;
    }
    int buf = 0;
    for (int u = blockIdx.x / k; u < units; u += gridDim.x / k, buf ^= 1) {
        const int64_t i = int64_t{u % tiles} * tx * V + int64_t{px} * V;
        const int64_t base = int64_t{u / tiles} * sp.C * sp.inner + i;
        const bool in_range = i < sp.inner;
        float val[NC][V], acc[1][V] = {};
        for (int ch = 0; ch < sp.chunks; ++ch) {
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                const int64_t c = c_first + int64_t{cy} * (j + NC * ch);
                load_in_pack<T, V, kGated>(x, z, base + c * sp.inner, in_range && c < c_end,
                                           val[j]);
#pragma unroll
                for (int v = 0; v < V; ++v) acc[0][v] += val[j][v] * val[j][v];
            }
        }
        unit_sums<1, V>(acc, sm, tx, k, rank, buf, started);
        float r[V];
#pragma unroll
        for (int v = 0; v < V; ++v) r[v] = rsqrtf(acc[0][v] * inv_c + eps);
        if (!in_range) continue;
        for (int ch = 0; ch < sp.chunks; ++ch) {
#pragma unroll
            for (int j = 0; j < NC; ++j) {
                const int64_t c = c_first + int64_t{cy} * (j + NC * ch);
                if (c >= c_end) break;
                const int64_t at = base + c * sp.inner;
                if (sp.chunks > 1) load_in_pack<T, V, kGated>(x, z, at, true, val[j]);
                const float wc = sp.chunks > 1 ? w[c] : wv[j];
                float out[V];
#pragma unroll
                for (int v = 0; v < V; ++v) out[v] = val[j][v] * r[v] * wc;
                store_pack<T, V>(y + at, out);
            }
        }
    }
    if (!started) cluster_wait();  // a block with no unit still meets the entry barrier
}

// ---- backward (K1, and K3 on the last axis) ---------------------------------

// inner == 1, rows of more than 32 packs: warp `warp` of block b walks rows
// b*8 + warp, then + grid*8, ...; lane l owns channels l, l + 32, ... of
// its warp's dw sums in shared memory (acc[warp][c]); the block adds its 8
// warps' sums in order.
template <typename T, bool kGated>
__global__ void rms_norm_bwd_rows(const T* __restrict__ x, const T* __restrict__ z,
                                  const float* __restrict__ w, const T* __restrict__ dy,
                                  T* __restrict__ dx, T* __restrict__ dz,
                                  float* __restrict__ partial, int64_t rows, int64_t d,
                                  float eps) {
    extern __shared__ float acc[];  // kRowsPerBlock x d
    const int warp = threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    float* mine = acc + warp * d;
    for (int64_t c = lane; c < d; c += kWarp) mine[c] = 0.f;
    const float inv_d = 1.f / static_cast<float>(d);
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + warp; row < rows;
         row += static_cast<int64_t>(gridDim.x) * kRowsPerBlock) {  // uniform across the warp
        const int64_t base = row * d;
        float ss = 0.f, gx = 0.f;
        for (int64_t c = lane; c < d; c += kWarp) {
            const float nv = load_in<T, kGated>(x, z, base + c);
            ss += nv * nv;
            gx += load_f32(dy + base + c) * w[c] * nv;
        }
        ss = warp_sum(ss);
        gx = warp_sum(gx);
        const float r = rsqrtf(ss * inv_d + eps);
        const float coef = r * r * r * gx * inv_d;
        for (int64_t c = lane; c < d; c += kWarp) {
            const float xv = load_f32(x + base + c);
            const float g = load_f32(dy + base + c);
            if constexpr (kGated) {
                const float zv = load_f32(z + base + c), s = sigmoid(zv), nv = xv * (zv * s);
                float dxv, dzv;
                gate_backward(xv, zv, s, r * g * w[c] - nv * coef, dxv, dzv);
                store_f32(dx + base + c, dxv);
                store_f32(dz + base + c, dzv);
                mine[c] += g * nv * r;
            } else {
                store_f32(dx + base + c, r * g * w[c] - xv * coef);
                mine[c] += g * xv * r;
            }
        }
    }
    __syncthreads();
    for (int64_t c = threadIdx.x; c < d; c += blockDim.x) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kRowsPerBlock; ++k) s += acc[k * d + c];
        partial[static_cast<int64_t>(blockIdx.x) * d + c] = s;
    }
}

// inner == 1, rows of at most 32 packs, laid out as rms_norm_rows_packed;
// each thread sums its pack's dw terms over its tiles in registers, then
// the block adds them in a fixed order (xor shuffles across the warp's
// rows, the 8 warps in order) into row blockIdx.x of `partial`.
template <typename T, int V, bool kGated>
__global__ void __launch_bounds__(kThreads, kRowBwdBlocksPerSM)
    rms_norm_bwd_rows_packed(const T* __restrict__ x, const T* __restrict__ z,
                             const float* __restrict__ w, const T* __restrict__ dy,
                             T* __restrict__ dx, T* __restrict__ dz,
                             float* __restrict__ partial, RowSplit sp, float eps) {
    __shared__ float part[kWarps][kWarp * V];
    const int q = threadIdx.x % sp.tpr, grp = threadIdx.x / sp.tpr;
    const bool col_ok = q < sp.npk;
    const int64_t col = int64_t{q} * V;
    float wv[V], dw_acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        wv[v] = col_ok ? w[col + v] : 0.f;
        dw_acc[v] = 0.f;
    }
    const float inv_d = 1.f / static_cast<float>(sp.d);
    for (int64_t t = blockIdx.x; t < sp.tiles; t += gridDim.x) {
        const RowPacks p = row_packs(sp, t, grp, col, col_ok);
        float xv[kRowSlots][V], zv[kRowSlots][V], gv[kRowSlots][V];
#pragma unroll
        for (int s = 0; s < kRowSlots; ++s) {
            load_in_pack<T, V, false>(x, nullptr, p.at[s], p.ok[s], xv[s]);
            load_in_pack<T, V, false>(dy, nullptr, p.at[s], p.ok[s], gv[s]);
            if constexpr (kGated) load_in_pack<T, V, false>(z, nullptr, p.at[s], p.ok[s], zv[s]);
        }
        // per slot: the sum of n^2, then of dy * w * n, n the normalised
        // input (x, or x * silu(z), recomputed below from x, z and sigmoid(z))
        float sums[2 * kRowSlots], sv[kRowSlots][V];
#pragma unroll
        for (int s = 0; s < kRowSlots; ++s) {
            sums[s] = sums[kRowSlots + s] = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                float nv = xv[s][v];
                if constexpr (kGated) {
                    sv[s][v] = sigmoid(zv[s][v]);
                    nv = xv[s][v] * (zv[s][v] * sv[s][v]);
                }
                sums[s] += nv * nv;
                sums[kRowSlots + s] += gv[s][v] * wv[v] * nv;
            }
        }
        row_sums<2 * kRowSlots>(sums, sp.tpr);
#pragma unroll
        for (int s = 0; s < kRowSlots; ++s) {
            const float r = rsqrtf(sums[s] * inv_d + eps);
            const float coef = r * r * r * sums[kRowSlots + s] * inv_d;
            float ox[V], oz[V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
                float nv = xv[s][v];
                if constexpr (kGated) nv = xv[s][v] * (zv[s][v] * sv[s][v]);
                const float dg = r * gv[s][v] * wv[v] - nv * coef;
                dw_acc[v] += gv[s][v] * nv * r;
                if constexpr (kGated) {
                    gate_backward(xv[s][v], zv[s][v], sv[s][v], dg, ox[v], oz[v]);
                } else {
                    ox[v] = dg;
                }
            }
            if (p.ok[s]) {
                store_pack<T, V>(dx + p.at[s], ox);
                if constexpr (kGated) store_pack<T, V>(dz + p.at[s], oz);
            }
        }
    }
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
    for (int v = 0; v < V; ++v) {
        float a = dw_acc[v];
        for (int off = kWarp / 2; off >= sp.tpr; off /= 2) a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane < sp.tpr && col_ok) part[warp][col + v] = a;  // lane == q
    }
    __syncthreads();
    for (int64_t c = threadIdx.x; c < sp.d; c += kThreads) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) s += part[k][c];
        partial[static_cast<int64_t>(blockIdx.x) * sp.d + c] = s;
    }
}

// inner > 1: each cluster walks units blockIdx.x / k, + grid / k, ...; the
// thread that owns channel c keeps its dw sum over the positions of those
// units (a shuffle sum across its row's lanes per unit) in a register and
// writes it into row `cluster` of `partial`.
template <typename T, int V, int NC>
__global__ void __launch_bounds__(kThreads)
    rms_norm_bwd_tiles(const T* __restrict__ x, const float* __restrict__ w,
                       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                       Split sp, float eps) {
    __shared__ TileSmem<2, V> sm;
    const int tx = sp.tx, cy = kThreads / tx, k = sp.k;
    const int px = threadIdx.x % tx, ty = threadIdx.x / tx, rank = blockIdx.x % k;
    const int units = static_cast<int>(sp.units), tiles = static_cast<int>(sp.tiles);
    bool started = k == 1;
    if (!started) cluster_arrive_relaxed();
    const int64_t c_first = rank * sp.slice + ty;
    const int64_t c_end = sp.C < (rank + 1) * sp.slice ? sp.C : (rank + 1) * sp.slice;
    const float inv_c = 1.f / static_cast<float>(sp.C);
    float wv[NC], dw_acc[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
        const int64_t c = c_first + int64_t{cy} * j;
        wv[j] = c < c_end ? w[c] : 0.f;
        dw_acc[j] = 0.f;
    }
    // The unit's x and dy: this thread's channels at its V positions, zero
    // outside the tensor or past the last unit.
    float xv[NC][V], gv[NC][V];
    const auto load_unit = [&](int u, float (&xa)[NC][V], float (&ga)[NC][V]) {
        const int64_t i = int64_t{u % tiles} * tx * V + int64_t{px} * V;
        const int64_t base = int64_t{u / tiles} * sp.C * sp.inner + i;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            const int64_t c = c_first + int64_t{cy} * j;
            const bool ok = u < units && i < sp.inner && c < c_end;
            load_in_pack<T, V, false>(x, nullptr, base + c * sp.inner, ok, xa[j]);
            load_in_pack<T, V, false>(dy, nullptr, base + c * sp.inner, ok, ga[j]);
        }
    };
    const int stride = gridDim.x / k;
    int buf = 0;
    load_unit(blockIdx.x / k, xv, gv);
    for (int u = blockIdx.x / k; u < units; u += stride, buf ^= 1) {
        const int64_t i = int64_t{u % tiles} * tx * V + int64_t{px} * V;
        const int64_t base = int64_t{u / tiles} * sp.C * sp.inner + i;
        const bool in_range = i < sp.inner;
        float acc[2][V] = {};
#pragma unroll
        for (int j = 0; j < NC; ++j) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                acc[0][v] += xv[j][v] * xv[j][v];
                acc[1][v] += gv[j][v] * wv[j] * xv[j][v];
            }
        }
        // the next unit's loads run under this unit's sums and stores
        float xn[NC][V], gn[NC][V];
        load_unit(u + stride, xn, gn);
        unit_sums<2, V>(acc, sm, tx, k, rank, buf, started);
        float r[V], coef[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            r[v] = rsqrtf(acc[0][v] * inv_c + eps);
            coef[v] = r[v] * r[v] * r[v] * acc[1][v] * inv_c;
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            const int64_t c = c_first + int64_t{cy} * j;
            float out[V], d = 0.f;
#pragma unroll
            for (int v = 0; v < V; ++v) {
                out[v] = r[v] * gv[j][v] * wv[j] - xv[j][v] * coef[v];
                d += gv[j][v] * xv[j][v] * r[v];
            }
            if (in_range && c < c_end) store_pack<T, V>(dx + base + c * sp.inner, out);
            for (int off = tx / 2; off > 0; off /= 2) d += __shfl_xor_sync(0xffffffffu, d, off);
            dw_acc[j] += d;
        }
#pragma unroll
        for (int j = 0; j < NC; ++j) {
#pragma unroll
            for (int v = 0; v < V; ++v) {
                xv[j][v] = xn[j][v];
                gv[j][v] = gn[j][v];
            }
        }
    }
    if (px == 0) {
        float* row = partial + static_cast<int64_t>(blockIdx.x / k) * sp.C;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            const int64_t c = c_first + int64_t{cy} * j;
            if (c < c_end) row[c] = dw_acc[j];
        }
    }
    if (!started) cluster_wait();  // a block with no unit still meets the entry barrier
}

// ---- host side -------------------------------------------------------------

int sm_count() {
    static int counts[64] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
    if (counts[dev] == 0) {
        int n = 0;
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        counts[dev] = n > 0 ? n : 132;
    }
    return counts[dev];
}

// 16 bytes of T where `extent` (the contiguous run a pack lies in: inner,
// or d on the row path) is a multiple of it and every pointer is 16-byte
// aligned (null ones, absent tensors, are), else 1.
template <typename T>
int vector_width(int64_t extent, std::initializer_list<const void*> ptrs) {
    constexpr int kVec = 16 / sizeof(T);
    if (extent % kVec != 0) return 1;
    for (const void* p : ptrs)
        if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return 1;
    return kVec;
}

template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int64_t grid, int k, size_t smem, cudaStream_t stream,
           Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(grid));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = static_cast<unsigned>(k);
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = k > 1 ? 1 : 0;
    const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, args...);
    return static_cast<int>(rc != cudaSuccess ? rc : cudaGetLastError());
}

// The packed row kernels' persistent grid: every tile, or `per_sm` blocks
// on each SM.
int64_t row_grid(const RowSplit& rs, int per_sm) {
    const int64_t cap = int64_t{per_sm} * sm_count();
    return rs.tiles < cap ? rs.tiles : cap;
}

template <typename T, int V, bool kGated>
int forward_tiles(const T* x, const T* z, const float* w, T* y, const Split& sp, float eps,
                  cudaStream_t s) {
    const int64_t grid = sp.units * sp.k;
    switch (sp.nc) {
        case 1: return launch(rms_norm_tiles<T, V, 1, kGated>, grid, sp.k, 0, s, x, z, w, y, sp, eps);
        case 2: return launch(rms_norm_tiles<T, V, 2, kGated>, grid, sp.k, 0, s, x, z, w, y, sp, eps);
        case 4: return launch(rms_norm_tiles<T, V, 4, kGated>, grid, sp.k, 0, s, x, z, w, y, sp, eps);
        default: return launch(rms_norm_tiles<T, V, 8, kGated>, grid, sp.k, 0, s, x, z, w, y, sp, eps);
    }
}

template <typename T, bool kGated>
int launch_forward(const void* x, const void* z, const float* w, void* y, int64_t outer,
                   int64_t C, int64_t inner, float eps, cudaStream_t s) {
    const T* xt = static_cast<const T*>(x);
    const T* zt = static_cast<const T*>(z);
    T* yt = static_cast<T*>(y);
    if (inner == 1) {
        const int V = vector_width<T>(C, {x, z, y});
        const RowSplit rs = row_split(outer, C, V);
        if (rs.tpr > 0) {
            const int64_t grid = row_grid(rs, kRowBlocksPerSM);
            if (V == 1) return launch(rms_norm_rows_packed<T, 1, kGated>, grid, 1, 0, s, xt, zt, w, yt, rs, eps);
            return launch(rms_norm_rows_packed<T, 16 / sizeof(T), kGated>, grid, 1, 0, s, xt, zt, w,
                          yt, rs, eps);
        }
        const int64_t blocks = ceil_div(outer, kRowsPerBlock);
        if (blocks > 2147483647LL) return cudaErrorInvalidValue;
        rms_norm_rows<T, kGated><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            xt, zt, w, yt, outer, C, eps);
        return static_cast<int>(cudaGetLastError());
    }
    const int V = vector_width<T>(inner, {x, z, y});
    const Split sp = choose_split(outer, C, inner, V, sm_count());
    if (sp.units * sp.k > 2147483647LL) return cudaErrorInvalidValue;
    if (V == 1) return forward_tiles<T, 1, kGated>(xt, zt, w, yt, sp, eps, s);
    return forward_tiles<T, 16 / sizeof(T), kGated>(xt, zt, w, yt, sp, eps, s);
}

int forward(const void* x, const void* z, const void* w, void* y, int64_t outer, int64_t C,
            int64_t inner, float eps, int dtype, void* stream, bool gated) {
    if (outer <= 0 || C <= 0 || inner <= 0) return cudaErrorInvalidValue;
    const float* wf = static_cast<const float*>(w);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype * 2 + (gated ? 1 : 0)) {
        case 0: return launch_forward<float, false>(x, z, wf, y, outer, C, inner, eps, s);
        case 1: return launch_forward<float, true>(x, z, wf, y, outer, C, inner, eps, s);
        case 2: return launch_forward<__nv_bfloat16, false>(x, z, wf, y, outer, C, inner, eps, s);
        case 3: return launch_forward<__nv_bfloat16, true>(x, z, wf, y, outer, C, inner, eps, s);
        default: return cudaErrorInvalidValue;
    }
}

// The strided backward's grid: `units` tiles over at most 2 blocks per SM,
// each cluster of k taking the same number of units. Returns the clusters,
// one row of `partial` each.
int64_t backward_clusters(int64_t units, int k) {
    const int64_t cap = int64_t{kBwdBlocksPerSM} * sm_count() / k;
    if (units <= cap) return units;
    return ceil_div(units, ceil_div(units, cap));
}

// The row path's split (rs->tpr == 0: a warp per row) and grid, or the
// strided path's split and grid: the rows of `partial`, one per block or
// cluster; -1 where the kernel does not take C, or for the gated backward
// (z given) off the last axis.
template <typename T>
int64_t plan_backward(const void* x, const void* z, const void* dy, const void* dx,
                      const void* dz, int64_t outer, int64_t C, int64_t inner, Split* sp,
                      RowSplit* rs, int* V) {
    if (inner == 1) {
        if (C > kMaxRowsD) return -1;
        *V = vector_width<T>(C, {x, z, dy, dx, dz});
        *rs = row_split(outer, C, *V);
        if (rs->tpr > 0) return row_grid(*rs, kRowBwdBlocksPerSM);
        const int64_t units = ceil_div(outer, kRowsPerBlock);
        return units < kMaxRowBwdBlocks ? units : kMaxRowBwdBlocks;
    }
    if (z != nullptr || C > kMaxStridedC) return -1;
    *V = vector_width<T>(inner, {x, dy, dx});
    *sp = choose_split(outer, C, inner, *V, sm_count());
    if (sp->units > 2147483647LL) return -1;
    return backward_clusters(sp->units, sp->k);
}

template <typename T, int V>
int backward_tiles(const T* x, const float* w, const T* dy, T* dx, float* partial,
                   const Split& sp, int64_t rows, float eps, cudaStream_t s) {
    const int64_t grid = rows * sp.k;
    switch (sp.nc) {
        case 1: return launch(rms_norm_bwd_tiles<T, V, 1>, grid, sp.k, 0, s, x, w, dy, dx, partial, sp, eps);
        case 2: return launch(rms_norm_bwd_tiles<T, V, 2>, grid, sp.k, 0, s, x, w, dy, dx, partial, sp, eps);
        case 4: return launch(rms_norm_bwd_tiles<T, V, 4>, grid, sp.k, 0, s, x, w, dy, dx, partial, sp, eps);
        default: return launch(rms_norm_bwd_tiles<T, V, 8>, grid, sp.k, 0, s, x, w, dy, dx, partial, sp, eps);
    }
}

template <typename T, bool kGated>
int launch_backward(const void* x, const void* z, const float* w, const void* dy, void* dx,
                    void* dz, float* partial, float* dw, int64_t outer, int64_t C, int64_t inner,
                    float eps, int64_t rows, cudaStream_t s) {
    Split sp{};
    RowSplit rs{};
    int V = 1;
    if (rows != plan_backward<T>(x, z, dy, dx, dz, outer, C, inner, &sp, &rs, &V))
        return cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const T* zt = static_cast<const T*>(z);
    const T* dyt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    T* dzt = static_cast<T*>(dz);
    int rc = 0;
    if (inner == 1 && rs.tpr > 0) {
        rc = V == 1 ? launch(rms_norm_bwd_rows_packed<T, 1, kGated>, rows, 1, 0, s, xt, zt, w, dyt,
                             dxt, dzt, partial, rs, eps)
                    : launch(rms_norm_bwd_rows_packed<T, 16 / sizeof(T), kGated>, rows, 1, 0, s,
                             xt, zt, w, dyt, dxt, dzt, partial, rs, eps);
    } else if (inner == 1) {
        rc = launch(rms_norm_bwd_rows<T, kGated>, rows, 1, sizeof(float) * kRowsPerBlock * C, s, xt,
                    zt, w, dyt, dxt, dzt, partial, outer, C, eps);
    } else if constexpr (!kGated) {
        rc = V == 1 ? backward_tiles<T, 1>(xt, w, dyt, dxt, partial, sp, rows, eps, s)
                    : backward_tiles<T, 16 / sizeof(T)>(xt, w, dyt, dxt, partial, sp, rows, eps, s);
    }
    if (rc != 0) return rc;
    rms_norm_dw_reduce<<<static_cast<unsigned>(ceil_div(C, kWarp)), dim3(kWarp, kReduceRows), 0,
                         s>>>(partial, dw, rows, C);
    return static_cast<int>(cudaGetLastError());
}

int backward(const void* x, const void* z, const void* w, const void* dy, void* dx, void* dz,
             void* partial, void* dw, int64_t outer, int64_t C, int64_t inner, float eps,
             int dtype, int64_t rows, void* stream, bool gated) {
    if (outer <= 0 || C <= 0 || inner <= 0 || rows <= 0) return cudaErrorInvalidValue;
    const float* wf = static_cast<const float*>(w);
    float* pf = static_cast<float*>(partial);
    float* dwf = static_cast<float*>(dw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype * 2 + (gated ? 1 : 0)) {
        case 0:
            return launch_backward<float, false>(x, z, wf, dy, dx, dz, pf, dwf, outer, C, inner,
                                                 eps, rows, s);
        case 1:
            return launch_backward<float, true>(x, z, wf, dy, dx, dz, pf, dwf, outer, C, inner,
                                                eps, rows, s);
        case 2:
            return launch_backward<__nv_bfloat16, false>(x, z, wf, dy, dx, dz, pf, dwf, outer, C,
                                                         inner, eps, rows, s);
        case 3:
            return launch_backward<__nv_bfloat16, true>(x, z, wf, dy, dx, dz, pf, dwf, outer, C,
                                                        inner, eps, rows, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. w is float32 of length C. x and y are
// contiguous (outer, C, inner). Returns the launch's CUDA error code.
int adnm_rms_norm(const void* x, const void* w, void* y, int64_t outer, int64_t C,
                  int64_t inner, float eps, int dtype, void* stream) {
    return forward(x, nullptr, w, y, outer, C, inner, eps, dtype, stream, false);
}

// K3: as adnm_rms_norm, of x * silu(z); z has x's shape and dtype.
int adnm_gated_rms_norm(const void* x, const void* z, const void* w, void* y, int64_t outer,
                        int64_t C, int64_t inner, float eps, int dtype, void* stream) {
    return forward(x, z, w, y, outer, C, inner, eps, dtype, stream, true);
}

// The rows of the fp32 (rows, C) scratch `partial` that the backward takes
// for these tensors (the split depends on their addresses), or -1 where the
// kernel does not take C. K1: z and dz null; K3: inner == 1.
int64_t adnm_rms_norm_backward_rows(const void* x, const void* z, const void* dy, const void* dx,
                                    const void* dz, int64_t outer, int64_t C, int64_t inner,
                                    int dtype) {
    if (outer <= 0 || C <= 0 || inner <= 0) return -1;
    Split sp{};
    RowSplit rs{};
    int V = 1;
    if (dtype == 0) return plan_backward<float>(x, z, dy, dx, dz, outer, C, inner, &sp, &rs, &V);
    if (dtype == 1)
        return plan_backward<__nv_bfloat16>(x, z, dy, dx, dz, outer, C, inner, &sp, &rs, &V);
    return -1;
}

// K1 backward: x, dy, dx contiguous (outer, C, inner) in `dtype`; w and dw
// float32 of length C; partial float32 (rows, C), rows from
// adnm_rms_norm_backward_rows. The dx kernel, then the dw reduction.
int adnm_rms_norm_backward(const void* x, const void* w, const void* dy, void* dx,
                           void* partial, void* dw, int64_t outer, int64_t C, int64_t inner,
                           float eps, int dtype, int64_t rows, void* stream) {
    return backward(x, nullptr, w, dy, dx, nullptr, partial, dw, outer, C, inner, eps, dtype,
                    rows, stream, false);
}

// K3 backward over the last axis: x, z, dy, dx, dz contiguous (outer, C) in
// `dtype`; otherwise as adnm_rms_norm_backward. The dx and dz kernel, then
// the dw reduction.
int adnm_gated_rms_norm_backward(const void* x, const void* z, const void* w, const void* dy,
                                 void* dx, void* dz, void* partial, void* dw, int64_t outer,
                                 int64_t C, float eps, int dtype, int64_t rows, void* stream) {
    if (z == nullptr || dz == nullptr) return cudaErrorInvalidValue;
    return backward(x, z, w, dy, dx, dz, partial, dw, outer, C, 1, eps, dtype, rows, stream,
                    true);
}

const char* adnm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
