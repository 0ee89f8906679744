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
// no VJP; K1's backward here is new (the port trains through the Block
// norms), adnm_rms_norm_backward:
//
//   r = rsqrt(mean_c(x^2) + eps),  gw = dy * w
//   dx = r * gw - x * r^3 * mean_c(gw * x)      (in x's dtype)
//   dw_c = sum over every position of dy * x * r (fp32)
//
// The wrappers (adnm_tpu_torch/ops/rms_norm.py) view a contiguous tensor
// as (outer, C, inner) and normalise over C:
//
//   * inner == 1, the Pallas contract (rows of the last axis): one warp per
//     row, lanes stride over C, fp32 sums reduced by warp shuffles.
//   * inner > 1, NCHW with C at stride inner: the port's 20 Block norms of
//     a forward, at (1, 32, 256^2) in the refiner and (1, 128..1024,
//     32^2..8^2) in the encoder and decoder.
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
// dw without atomics on values: the backward runs a grid fixed by the
// shape and the SM count (at most 2 blocks per SM, each cluster walking
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
constexpr int64_t kMaxRowBwdBlocks = 1024;  // the row backward's largest grid
constexpr int64_t kMaxRowsD = 1536;       // backward rows: 8 warps x d fp32 in 48 KB
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

__device__ __forceinline__ float silu_gate(float v, float g) { return v * (g / (1.f + expf(-g))); }

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

// inner == 1: x is (rows, d), one warp per row.
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

// ---- K1 backward ---------------------------------------------------------

// inner == 1: warp `warp` of block b walks rows b*8 + warp, then + grid*8,
// ...; lane l owns channels l, l + 32, ... of its warp's dw sums in shared
// memory (acc[warp][c]); the block adds its 8 warps' sums in order.
template <typename T>
__global__ void rms_norm_bwd_rows(const T* __restrict__ x, const float* __restrict__ w,
                                  const T* __restrict__ dy, T* __restrict__ dx,
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
            const float xv = load_f32(x + base + c);
            ss += xv * xv;
            gx += load_f32(dy + base + c) * w[c] * xv;
        }
        ss = warp_sum(ss);
        gx = warp_sum(gx);
        const float r = rsqrtf(ss * inv_d + eps);
        const float coef = r * r * r * gx * inv_d;
        for (int64_t c = lane; c < d; c += kWarp) {
            const float xv = load_f32(x + base + c);
            const float g = load_f32(dy + base + c);
            store_f32(dx + base + c, r * g * w[c] - xv * coef);
            mine[c] += g * xv * r;
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

// 16 bytes of T where inner is a multiple of it and every pointer is
// 16-byte aligned, else 1.
template <typename T>
int vector_width(int64_t inner, const void* a, const void* b, const void* c) {
    constexpr int kVec = 16 / sizeof(T);
    if (inner % kVec != 0) return 1;
    for (const void* p : {a, b, c})
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
        const int64_t blocks = ceil_div(outer, kRowsPerBlock);
        if (blocks > 2147483647LL) return cudaErrorInvalidValue;
        rms_norm_rows<T, kGated><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            xt, zt, w, yt, outer, C, eps);
        return static_cast<int>(cudaGetLastError());
    }
    const int V = vector_width<T>(inner, x, z, y);
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

// The row path's grid, or the strided path's split and grid; -1 where the
// kernel does not take C.
template <typename T>
int64_t plan_backward(const void* x, const void* dy, const void* dx, int64_t outer, int64_t C,
                      int64_t inner, Split* sp, int* V) {
    if (inner == 1) {
        const int64_t units = ceil_div(outer, kRowsPerBlock);
        return C > kMaxRowsD ? -1 : (units < kMaxRowBwdBlocks ? units : kMaxRowBwdBlocks);
    }
    if (C > kMaxStridedC) return -1;
    *V = vector_width<T>(inner, x, dy, dx);
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

template <typename T>
int launch_backward(const void* x, const float* w, const void* dy, void* dx, float* partial,
                    float* dw, int64_t outer, int64_t C, int64_t inner, float eps, int64_t rows,
                    cudaStream_t s) {
    Split sp{};
    int V = 1;
    if (rows != plan_backward<T>(x, dy, dx, outer, C, inner, &sp, &V)) return cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    if (inner == 1) {
        rms_norm_bwd_rows<T><<<static_cast<unsigned>(rows), kThreads, sizeof(float) * kRowsPerBlock * C,
                               s>>>(xt, w, dyt, dxt, partial, outer, C, eps);
    } else {
        const int rc = V == 1 ? backward_tiles<T, 1>(xt, w, dyt, dxt, partial, sp, rows, eps, s)
                              : backward_tiles<T, 16 / sizeof(T)>(xt, w, dyt, dxt, partial, sp,
                                                                  rows, eps, s);
        if (rc != 0) return rc;
    }
    rms_norm_dw_reduce<<<static_cast<unsigned>(ceil_div(C, kWarp)), dim3(kWarp, kReduceRows), 0,
                         s>>>(partial, dw, rows, C);
    return static_cast<int>(cudaGetLastError());
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

// The rows of the fp32 (rows, C) scratch `partial` that adnm_rms_norm_backward
// takes for these tensors (the split depends on their addresses), or -1
// where the kernel does not take C.
int64_t adnm_rms_norm_backward_rows(const void* x, const void* dy, const void* dx, int64_t outer,
                                    int64_t C, int64_t inner, int dtype) {
    if (outer <= 0 || C <= 0 || inner <= 0) return -1;
    Split sp{};
    int V = 1;
    if (dtype == 0) return plan_backward<float>(x, dy, dx, outer, C, inner, &sp, &V);
    if (dtype == 1) return plan_backward<__nv_bfloat16>(x, dy, dx, outer, C, inner, &sp, &V);
    return -1;
}

// K1 backward: x, dy, dx contiguous (outer, C, inner) in `dtype`; w and dw
// float32 of length C; partial float32 (rows, C), rows from
// adnm_rms_norm_backward_rows. The dx kernel, then the dw reduction.
int adnm_rms_norm_backward(const void* x, const void* w, const void* dy, void* dx,
                           void* partial, void* dw, int64_t outer, int64_t C, int64_t inner,
                           float eps, int dtype, int64_t rows, void* stream) {
    if (outer <= 0 || C <= 0 || inner <= 0 || rows <= 0) return cudaErrorInvalidValue;
    const float* wf = static_cast<const float*>(w);
    float* pf = static_cast<float*>(partial);
    float* dwf = static_cast<float*>(dw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_backward<float>(x, wf, dy, dx, pf, dwf, outer, C, inner, eps, rows, s);
        case 1:
            return launch_backward<__nv_bfloat16>(x, wf, dy, dx, pf, dwf, outer, C, inner, eps,
                                                  rows, s);
        default: return cudaErrorInvalidValue;
    }
}

const char* adnm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
