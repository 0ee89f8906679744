// RMS normalisation over one axis, its backward, and the gated variant,
// written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of adnm_tpu/ops/pallas/fused_norm.py:
//
//   K1  rms_norm_pallas        (_row_call with _rms_kernel):
//         y = x * rsqrt(mean(x^2) + eps) * w
//   K3  gated_rms_norm_pallas  (_row_call with _gated_rms_kernel):
//         g = x * silu(z);  y = g * rsqrt(mean(g^2) + eps) * w
//
// with the statistics in fp32 and y in x's dtype. The Pallas kernels have
// no VJP; K1's backward here is new (the port trains through the Block
// norms):
//
//   r = rsqrt(mean_c(x^2) + eps),  gw = dy * w
//   dx = r * gw - x * r^3 * mean_c(gw * x)      (in x's dtype)
//   dw_c = sum over every position of dy * x * r (fp32)
//
// The Pallas kernels normalise rows of the last axis. The PyTorch port
// keeps activations in NCHW, so its Block norms reduce over the channel
// axis 1 at stride H*W. The wrappers (adnm_tpu_torch/ops/rms_norm.py) view
// a contiguous tensor as (outer, C, inner) and both cases are served:
//
//   * inner == 1 (the Pallas contract, the last axis): one warp per row,
//     lanes stride over C, fp32 sums reduced by warp shuffles.
//   * inner > 1 (NCHW, C at stride inner): a block of 32 x 8 threads owns
//     32 neighbouring inner positions of one outer index. threadIdx.x runs
//     along inner, so a warp reads 32 neighbouring addresses of one
//     channel; threadIdx.y splits C eight ways and the eight partial sums
//     meet in shared memory.
//
// What bounds them: memory bandwidth. Per element the forward does a few
// flops and must read x (and z) once and write y once; the backward reads
// x and dy and writes dx. At the refiner's (B, 32, 256, 256) fp32 that is
// 16 MiB (forward) or 24 MiB (backward) per sample, 5.0 and 7.5 us per
// sample at the H100's 3.35 TB/s. What the design does about it: one
// launch in place of the plain version's chain of elementwise and
// reduction passes, with no intermediate tensor in device memory. The
// second read of a tile (for the output) touches the block's own 32
// positions x C channels right after the first, so it is served from L1/L2
// rather than device memory. The backward recomputes r from x, which it
// reads anyway, so the forward stores nothing beside y.
//
// dw without atomics: the backward's blocks walk their positions in a
// fixed order (a grid-stride loop over a grid fixed by the shape) and sum
// each channel's share in shared memory; each block writes its fp32 sums
// into a (blocks, C) scratch tensor, and a second kernel reduces it over
// the blocks in a fixed order. Two launches on the same inputs give
// bit-equal dw.
//
// Built by adnm_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes: each entry point returns cudaGetLastError()
// after its launches, and the wrappers raise if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;  // warps per block in the row kernels
constexpr int kSplitC = 8;        // threadIdx.y extent in the strided kernels
constexpr int kReduceRows = 32;   // threadIdx.y extent of the dw reduction
constexpr int64_t kMaxRowsD = 1536;  // backward rows: 8 warps x d fp32 in 48 KB
// backward strided: C fp32 sums beside the two 8 x 33 fp32 tiles in 48 KB
constexpr int64_t kMaxStridedC = 11264;

// The normalised input at x[at]: x itself (K1) or x * silu(z) (K3).
template <typename T, bool kGated>
__device__ __forceinline__ float load_in(const T* __restrict__ x, const T* __restrict__ z,
                                         int64_t at) {
    const float v = load_f32(x + at);
    if constexpr (kGated) {
        const float g = load_f32(z + at);
        return v * (g / (1.f + expf(-g)));
    } else {
        return v;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
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

// inner > 1: x is (outer, C, inner); blockIdx.x enumerates (outer, tile of
// 32 inner positions).
template <typename T, bool kGated>
__global__ void rms_norm_strided(const T* __restrict__ x, const T* __restrict__ z,
                                 const float* __restrict__ w, T* __restrict__ y, int64_t C,
                                 int64_t inner, int64_t tiles, float eps) {
    __shared__ float partial[kSplitC][kWarp + 1];
    const int64_t o = blockIdx.x / tiles;
    const int64_t i = (blockIdx.x % tiles) * kWarp + threadIdx.x;
    const bool valid = i < inner;
    const int64_t base = o * C * inner + i;
    float ss = 0.f;
    if (valid) {
        for (int64_t c = threadIdx.y; c < C; c += kSplitC) {
            const float v = load_in<T, kGated>(x, z, base + c * inner);
            ss += v * v;
        }
    }
    partial[threadIdx.y][threadIdx.x] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int k = 0; k < kSplitC; ++k) total += partial[k][threadIdx.x];
    if (!valid) return;
    const float r = rsqrtf(total / static_cast<float>(C) + eps);
    for (int64_t c = threadIdx.y; c < C; c += kSplitC) {
        const int64_t at = base + c * inner;
        store_f32(y + at, load_in<T, kGated>(x, z, at) * r * w[c]);
    }
}

template <typename T, bool kGated>
void launch_forward(const void* x, const void* z, const float* w, void* y, int64_t outer,
                    int64_t C, int64_t inner, float eps, cudaStream_t stream) {
    const T* xt = static_cast<const T*>(x);
    const T* zt = static_cast<const T*>(z);
    T* yt = static_cast<T*>(y);
    if (inner == 1) {
        const int64_t blocks = (outer + kRowsPerBlock - 1) / kRowsPerBlock;
        rms_norm_rows<T, kGated><<<static_cast<unsigned>(blocks), kRowsPerBlock * kWarp, 0,
                                   stream>>>(xt, zt, w, yt, outer, C, eps);
    } else {
        const int64_t tiles = (inner + kWarp - 1) / kWarp;
        const dim3 block(kWarp, kSplitC);
        rms_norm_strided<T, kGated><<<static_cast<unsigned>(outer * tiles), block, 0, stream>>>(
            xt, zt, w, yt, C, inner, tiles, eps);
    }
}

int64_t forward_blocks(int64_t outer, int64_t inner) {
    return inner == 1 ? (outer + kRowsPerBlock - 1) / kRowsPerBlock
                      : outer * ((inner + kWarp - 1) / kWarp);
}

int forward(const void* x, const void* z, const void* w, void* y, int64_t outer, int64_t C,
            int64_t inner, float eps, int dtype, void* stream, bool gated) {
    // Grid x is at most 2^31 - 1 blocks.
    if (outer <= 0 || C <= 0 || inner <= 0 || forward_blocks(outer, inner) > 2147483647LL)
        return cudaErrorInvalidValue;
    const float* wf = static_cast<const float*>(w);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype * 2 + (gated ? 1 : 0)) {
        case 0: launch_forward<float, false>(x, z, wf, y, outer, C, inner, eps, s); break;
        case 1: launch_forward<float, true>(x, z, wf, y, outer, C, inner, eps, s); break;
        case 2: launch_forward<__nv_bfloat16, false>(x, z, wf, y, outer, C, inner, eps, s); break;
        case 3: launch_forward<__nv_bfloat16, true>(x, z, wf, y, outer, C, inner, eps, s); break;
        default: return cudaErrorInvalidValue;
    }
    return static_cast<int>(cudaGetLastError());
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

// inner > 1: block b walks the units (outer, tile of 32 positions) b, b +
// grid, ...; per channel, the warp that owns it (threadIdx.y = c % 8) sums
// dy * x * r over its 32 lanes with shuffles and lane 0 adds it to acc[c].
template <typename T>
__global__ void rms_norm_bwd_strided(const T* __restrict__ x, const float* __restrict__ w,
                                     const T* __restrict__ dy, T* __restrict__ dx,
                                     float* __restrict__ partial, int64_t C, int64_t inner,
                                     int64_t tiles, int64_t units, float eps) {
    extern __shared__ float acc[];  // C
    __shared__ float part_ss[kSplitC][kWarp + 1];
    __shared__ float part_gx[kSplitC][kWarp + 1];
    const int tid = threadIdx.y * kWarp + threadIdx.x;
    for (int64_t c = tid; c < C; c += kWarp * kSplitC) acc[c] = 0.f;
    __syncthreads();
    const float inv_c = 1.f / static_cast<float>(C);
    for (int64_t u = blockIdx.x; u < units; u += gridDim.x) {
        const int64_t o = u / tiles;
        const int64_t i = (u % tiles) * kWarp + threadIdx.x;
        const bool valid = i < inner;
        const int64_t base = o * C * inner + i;
        float ss = 0.f, gx = 0.f;
        if (valid) {
            for (int64_t c = threadIdx.y; c < C; c += kSplitC) {
                const float xv = load_f32(x + base + c * inner);
                ss += xv * xv;
                gx += load_f32(dy + base + c * inner) * w[c] * xv;
            }
        }
        part_ss[threadIdx.y][threadIdx.x] = ss;
        part_gx[threadIdx.y][threadIdx.x] = gx;
        __syncthreads();
        float total_ss = 0.f, total_gx = 0.f;
#pragma unroll
        for (int k = 0; k < kSplitC; ++k) {
            total_ss += part_ss[k][threadIdx.x];
            total_gx += part_gx[k][threadIdx.x];
        }
        __syncthreads();  // the next unit overwrites part_ss and part_gx
        const float r = rsqrtf(total_ss * inv_c + eps);
        const float coef = r * r * r * total_gx * inv_c;
        for (int64_t c = threadIdx.y; c < C; c += kSplitC) {  // uniform across the warp
            float dwv = 0.f;
            if (valid) {
                const int64_t at = base + c * inner;
                const float xv = load_f32(x + at);
                const float g = load_f32(dy + at);
                store_f32(dx + at, r * g * w[c] - xv * coef);
                dwv = g * xv * r;
            }
            dwv = warp_sum(dwv);
            if (threadIdx.x == 0) acc[c] += dwv;
        }
    }
    __syncthreads();
    for (int64_t c = tid; c < C; c += kWarp * kSplitC)
        partial[static_cast<int64_t>(blockIdx.x) * C + c] = acc[c];
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

int64_t backward_units(int64_t outer, int64_t inner) { return forward_blocks(outer, inner); }

template <typename T>
void launch_backward(const void* x, const float* w, const void* dy, void* dx, float* partial,
                     float* dw, int64_t outer, int64_t C, int64_t inner, float eps,
                     int64_t grid, cudaStream_t stream) {
    const T* xt = static_cast<const T*>(x);
    const T* dyt = static_cast<const T*>(dy);
    T* dxt = static_cast<T*>(dx);
    if (inner == 1) {
        const size_t smem = sizeof(float) * kRowsPerBlock * C;
        rms_norm_bwd_rows<T><<<static_cast<unsigned>(grid), kRowsPerBlock * kWarp, smem,
                               stream>>>(xt, w, dyt, dxt, partial, outer, C, eps);
    } else {
        const int64_t tiles = (inner + kWarp - 1) / kWarp;
        const dim3 block(kWarp, kSplitC);
        rms_norm_bwd_strided<T><<<static_cast<unsigned>(grid), block, sizeof(float) * C,
                                  stream>>>(xt, w, dyt, dxt, partial, C, inner, tiles,
                                            outer * tiles, eps);
    }
    const dim3 rblock(kWarp, kReduceRows);
    rms_norm_dw_reduce<<<static_cast<unsigned>((C + kWarp - 1) / kWarp), rblock, 0, stream>>>(
        partial, dw, grid, C);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. w is float32 of length C. x and y are
// contiguous (outer, C, inner). Returns cudaGetLastError() after the launch.
int adnm_rms_norm(const void* x, const void* w, void* y, int64_t outer, int64_t C,
                  int64_t inner, float eps, int dtype, void* stream) {
    return forward(x, nullptr, w, y, outer, C, inner, eps, dtype, stream, false);
}

// K3: as adnm_rms_norm, of x * silu(z); z has x's shape and dtype.
int adnm_gated_rms_norm(const void* x, const void* z, const void* w, void* y, int64_t outer,
                        int64_t C, int64_t inner, float eps, int dtype, void* stream) {
    return forward(x, z, w, y, outer, C, inner, eps, dtype, stream, true);
}

// The largest grid of the K1 backward: its units (rows of 8, or tiles of
// 32 positions) or this, whichever is smaller. The wrapper allocates the
// (grid, C) fp32 scratch `partial`.
int64_t adnm_rms_norm_backward_grid(int64_t outer, int64_t inner) {
    const int64_t units = backward_units(outer, inner);
    return units < 1024 ? units : 1024;
}

// K1 backward: x, dy, dx contiguous (outer, C, inner) in `dtype`; w and dw
// float32 of length C; partial float32 (grid, C), grid from
// adnm_rms_norm_backward_grid.
int adnm_rms_norm_backward(const void* x, const void* w, const void* dy, void* dx,
                           void* partial, void* dw, int64_t outer, int64_t C, int64_t inner,
                           float eps, int dtype, int64_t grid, void* stream) {
    if (outer <= 0 || C <= 0 || inner <= 0 || grid != adnm_rms_norm_backward_grid(outer, inner))
        return cudaErrorInvalidValue;
    if ((inner == 1 && C > kMaxRowsD) || (inner > 1 && C > kMaxStridedC))
        return cudaErrorInvalidValue;
    const float* wf = static_cast<const float*>(w);
    float* pf = static_cast<float*>(partial);
    float* dwf = static_cast<float*>(dw);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: launch_backward<float>(x, wf, dy, dx, pf, dwf, outer, C, inner, eps, grid, s); break;
        case 1:
            launch_backward<__nv_bfloat16>(x, wf, dy, dx, pf, dwf, outer, C, inner, eps, grid, s);
            break;
        default: return cudaErrorInvalidValue;
    }
    return static_cast<int>(cudaGetLastError());
}

const char* adnm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
