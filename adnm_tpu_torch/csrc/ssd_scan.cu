// Causal chunked SSD scan (kernel K2), written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel adnm_tpu/ops/pallas/ssd_scan.py
// ssd_chunked_scan_pallas (_forward with the body _kernel), the function of
// adnm_tpu/ops/ssd.py::ssd_chunked_scan. Forward only, fp32 throughout
// (no TF32, no tensor cores). In the port's sequence-minor layout, per
// batch b and head h, with dA = dt * A (A < 0, not negated):
//
//     y_t = sum_{s<=t} exp(sum_{r=s+1..t} dA_r) (C_t . B_s) x_s dt_s + D x_t
//
// x (B, H, P, L), dt (B, H, L), A and D (H,), B and C (B, N, L) shared by
// the heads, y (B, H, P, L), with every model's P = 4 and N = 16. Each sample of x, dt, B and C is contiguous;
// the samples lie at a batch stride of their own, so channel slices of the
// mixer's NCHW tensors are read in place. With reverse != 0 the scan runs
// from the last token to the first: token i of the scan is position
// L - 1 - i, which is flip(scan(flip(x, dt, B, C))) without the copies.
//
// The Pallas kernel walks the chunks of Q tokens in grid order and keeps
// the (N, H*P) state in VMEM. Hopper runs blocks in no order, and one
// block per (batch, head) walking 256 chunks would leave the refiner
// (L = 65,536, 8 heads) 8 blocks for 132 SMs. So the scan is split into
// the three phases of the XLA version:
//
//   1. ssd_chunk_states, a block per (chunk, batch, group of heads): the
//      in-chunk cumsum of dA (block-wide scans) and the chunk's end state
//      S_c = sum_s B_s (x_s dt_s exp(cum_end - cum_s)) of N x P values per
//      head, and the decay exp(cum_end) across the chunk.
//   2. ssd_carry, a warp per (batch, head, n, p): the carry
//      S_in(c+1) = S_in(c) exp(cum_end(c)) + S_c over the chunks, as warp
//      scans of 32 chunks at a time, written over S_c.
//   3. ssd_chunk_outputs, a block per (chunk, batch, group of heads, tile
//      of 64 rows t): the masked intra-chunk product
//      sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) x_s dt_s, the carried
//      state's exp(cum_t) (C_t . S_in), and D x_t.
//
// One chunk (L <= Q) carries nothing: phases 1 and 2 are skipped.
//
// What bounds it: bytes. At the refiner's shape (L = 65,536, Q = 256, 8
// heads of P = 4, N = 16) one batch moves 26 MiB (8.1 us at 3.35 TB/s),
// while the scan written as a state update per token needs about 5 N P
// operations per token and head, 0.17 GFLOP (2.6 us at the 67 TFLOP/s fp32
// rate). The chunked form does about 1.2 GFLOP instead, most of it in the
// Q(Q+1)/2 causal pairs of every chunk: N multiply-adds for C_t . B_s, then
// per head a subtract, an exp, a multiply and P multiply-adds. It trades
// those operations for parallel chunks and no sequential walk over L. What
// the design does about them:
//   * C_t . B_s is the same for all heads, so a block takes 4 heads and
//     computes it once for all of them; 16 sums a thread keep it within 80
//     registers, three blocks to an SM.
//   * Pairs with s > t are never visited, so the masked half costs nothing.
//   * Each row is split over 4 lanes, lane j taking s = j, j + 4, ...: the
//     longest row walks 64 pairs, not 256, and the small grids of the
//     8^2..32^2 Blocks get 4 times the blocks.
//   * B, the cumsums and x dt of the chunk sit in shared memory laid out so
//     that every load in the pair loop is a 16-byte broadcast; the cumsums
//     are scaled by log2(e) so that each decay is one exp2f.
//   * All global loads of a block are issued before its first scan, and
//     the heads' scans run side by side.
// The Q x Q product is never stored (at Q = 256 it alone would be 256 KB
// in fp32, more than a block's 227 KB). What is left: the blocks spend
// much of their time waiting on those loads and scans, and a refiner call
// takes about 17 times its bound (PERF.md).
//
// Built by adnm_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and called through ctypes: adnm_ssd_chunked_scan returns
// cudaGetLastError() after the launches, and the wrapper
// (adnm_tpu_torch/ops/ssd.py) raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;       // state size N
constexpr int kP = 4;        // head width P (headdim of every model)
constexpr int kMaxQ = 256;   // tokens per chunk, one thread each
constexpr int kHG = 4;       // heads per block: kHG * kP = 16 sums a thread
constexpr int kWarp = 32;
constexpr int kMaxWarps = kMaxQ / kWarp;

struct Args {
    const float* x;
    const float* dt;
    const float* A;
    const float* B;
    const float* C;
    const float* D;
    float* y;
    float* states;  // (batch, H, chunks, N, P), or null for one chunk
    float* decay;   // (batch, H, chunks)
    int64_t sx, sdt, sb, sc;  // batch strides in elements
    int H, L, Q, nc, reverse;
};

__device__ __forceinline__ int position(int i, const Args& a) {
    return a.reverse ? a.L - 1 - i : i;
}

// K inclusive scans over the block at once, one for each v[k] (blockDim.x
// a multiple of 32, at most 256; warp_total holds kMaxWarps * K floats).
// Every thread must call it.
template <int K>
__device__ void block_inclusive_scans(float (&v)[K], float* warp_total) {
    const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
    for (int off = 1; off < kWarp; off *= 2) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const float u = __shfl_up_sync(0xffffffffu, v[k], off);
            if (lane >= off) v[k] += u;
        }
    }
    if (lane == kWarp - 1) {
#pragma unroll
        for (int k = 0; k < K; ++k) warp_total[warp * K + k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float before = 0.f;
        for (int w = 0; w < warp; ++w) before += warp_total[w * K + k];
        v[k] += before;
    }
}

// The dA cumsums of the chunk for the block's heads, scaled by `scale`,
// with x and dt of token `tid` at position l (zeros where !loader or past
// the block's hn heads). All global loads are issued before the first scan.
__device__ void load_and_scan(const Args& a, int b, int h0, int hn, bool loader, int l,
                              float scale, float (&cum)[kHG], float (&x)[kHG][kP],
                              float (&dtv)[kHG], float* warp_total) {
#pragma unroll
    for (int hh = 0; hh < kHG; ++hh) {
        const bool on = loader && hh < hn;
        dtv[hh] = on ? a.dt[b * a.sdt + int64_t(h0 + hh) * a.L + l] : 0.f;
#pragma unroll
        for (int p = 0; p < kP; ++p)
            x[hh][p] = on ? a.x[b * a.sx + int64_t((h0 + hh) * kP + p) * a.L + l] : 0.f;
        cum[hh] = hh < hn ? dtv[hh] * a.A[h0 + hh] * scale : 0.f;
    }
    block_inclusive_scans<kHG>(cum, warp_total);
}

// K consecutive floats from shared memory in 16-byte loads (p is aligned
// to 16 bytes).
template <int K>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[K]) {
    static_assert(K % 4 == 0, "whole float4s");
#pragma unroll
    for (int k = 0; k < K / 4; ++k) {
        const float4 v = reinterpret_cast<const float4*>(p)[k];
        out[4 * k] = v.x;
        out[4 * k + 1] = v.y;
        out[4 * k + 2] = v.z;
        out[4 * k + 3] = v.w;
    }
}

// Phase 1. Shared memory: B of the chunk [N][Q], u = x dt exp(cum_end - cum)
// [heads * P][Q | 1] (an odd row stride: the rows a warp reads at one s
// fall in distinct banks).
__global__ void __launch_bounds__(kMaxQ) ssd_chunk_states(Args a) {
    constexpr int HG = kHG, P = kP;
    const int c = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
    const int t = threadIdx.x, Q = a.Q, L = a.L;
    const int hn = min(HG, a.H - h0);
    const int ustride = Q | 1;
    extern __shared__ float4 smem4[];
    float* Bs = reinterpret_cast<float*>(smem4);
    float* u = Bs + kN * Q;
    __shared__ float warp_total[kMaxWarps * HG];
    __shared__ float end_s[HG];

    const bool valid = t < Q;
    const int l = valid ? position(c * Q + t, a) : 0;
    if (valid) {
#pragma unroll
        for (int n = 0; n < kN; ++n) Bs[n * Q + t] = a.B[b * a.sb + int64_t(n) * L + l];
    }
    float cum[HG], xr[HG][P], dtv[HG];
    load_and_scan(a, b, h0, hn, valid, l, 1.f, cum, xr, dtv, warp_total);
    if (t == Q - 1) {
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) end_s[hh] = cum[hh];
    }
    __syncthreads();
    if (valid) {
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) {
            if (hh < hn) {
                const float w = dtv[hh] * expf(end_s[hh] - cum[hh]);
#pragma unroll
                for (int p = 0; p < P; ++p) u[(hh * P + p) * ustride + t] = xr[hh][p] * w;
            }
        }
    }
    if (t < hn) a.decay[(int64_t(b) * a.H + h0 + t) * a.nc + c] = expf(end_s[t]);
    __syncthreads();
    // N * HG * P sums over the chunk, a thread each.
    for (int o = t; o < kN * HG * P; o += blockDim.x) {
        const int n = o / (HG * P), hp = o % (HG * P), hh = hp / P, p = hp % P;
        if (hh >= hn) continue;
        const float* br = Bs + n * Q;
        const float* ur = u + hp * ustride;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        int k = 0;
        for (; k + 4 <= Q; k += 4) {
            s0 = fmaf(br[k], ur[k], s0);
            s1 = fmaf(br[k + 1], ur[k + 1], s1);
            s2 = fmaf(br[k + 2], ur[k + 2], s2);
            s3 = fmaf(br[k + 3], ur[k + 3], s3);
        }
        for (; k < Q; ++k) s0 = fmaf(br[k], ur[k], s0);
        a.states[((int64_t(b) * a.H + h0 + hh) * a.nc + c) * (kN * P) + n * P + p] =
            (s0 + s1) + (s2 + s3);
    }
}

// Phase 2: one warp per (batch, head, n, p) walks the chunks 32 at a time
// and leaves in states the state entering each chunk. The carry
// S' = S d + s composes associatively, (d1, s1) then (d2, s2) being
// (d1 d2, s1 d2 + s2), so each group of 32 chunks is a warp scan.
__global__ void ssd_carry(float* states, const float* decay, int64_t total, int nc, int np) {
    const int64_t w = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (w >= total) return;  // whole warps
    const int64_t bh = w / np;
    float* st = states + bh * nc * np + w % np;
    const float* dec = decay + bh * nc;
    float carry = 0.f;  // the state entering the group
    for (int c0 = 0; c0 < nc; c0 += kWarp) {
        const int c = c0 + lane;
        float d = c < nc ? dec[c] : 1.f, s = c < nc ? st[int64_t(c) * np] : 0.f;
#pragma unroll
        for (int off = 1; off < kWarp; off *= 2) {
            const float dp = __shfl_up_sync(0xffffffffu, d, off);
            const float sp = __shfl_up_sync(0xffffffffu, s, off);
            if (lane >= off) {
                s = fmaf(sp, d, s);
                d *= dp;
            }
        }
        // (d, s) now spans chunks c0..c; the state entering c spans c0..c-1
        float de = __shfl_up_sync(0xffffffffu, d, 1), se = __shfl_up_sync(0xffffffffu, s, 1);
        if (lane == 0) de = 1.f, se = 0.f;
        if (c < nc) st[int64_t(c) * np] = fmaf(carry, de, se);
        carry = fmaf(carry, __shfl_sync(0xffffffffu, d, kWarp - 1),
                     __shfl_sync(0xffffffffu, s, kWarp - 1));
    }
}

// Phase 3. A block takes a tile of kRows rows t of one chunk for a group
// of heads. Each row is split over kSplit lanes, lane j taking the pairs
// s = j, j + kSplit, ... <= t, and the lanes' sums meet by shuffles: this
// cuts the longest row's serial walk by kSplit and gives the small grids
// of the 8^2..32^2 Blocks kSplit times more blocks. Shared memory: B of
// the chunk [Q][N], x dt [Q][heads][P], the entering states [heads][N][P],
// cum [Q][heads] (log2-scaled, for exp2f), x of the tile's rows for the D
// skip [kRows][heads][P]. The kSplit lanes of a row are
// 8 apart, so a quarter warp reads one s: every load in the pair loop is
// a 16-byte broadcast.
constexpr int kSplit = 4;
constexpr int kRows = kMaxQ / kSplit;  // 64 rows of 4 lanes in 256 threads

__global__ void __launch_bounds__(kMaxQ, 3) ssd_chunk_outputs(Args a) {
    constexpr int HG = kHG, P = kP;
    const int tiles = (a.Q + kRows - 1) / kRows;
    const int c = blockIdx.x, b = blockIdx.z;
    const int h0 = blockIdx.y / tiles * HG, r0 = blockIdx.y % tiles * kRows;
    const int tid = threadIdx.x, Q = a.Q, L = a.L;
    const int hn = min(HG, a.H - h0);
    extern __shared__ float4 smem4[];
    float* Bs = reinterpret_cast<float*>(smem4);
    float* xd_s = Bs + Q * kN;
    float* S_s = xd_s + Q * HG * P;
    float* cum_s = S_s + HG * kN * P;
    float* x_s = cum_s + Q * HG;  // x of the tile's rows [kRows][heads][P]
    __shared__ float warp_total[kMaxWarps * HG];

    // Row t, split j (lanes 8 apart); rows past Q still join the shuffles.
    // The row's C goes to registers first: its loads are in flight while
    // the block loads and scans the chunk.
    const int lane = tid % kWarp, j = lane / (kWarp / kSplit);
    const int t = r0 + tid / kWarp * (kWarp / kSplit) + lane % (kWarp / kSplit);
    const bool valid = t < Q;
    const int l = valid ? position(c * Q + t, a) : 0;
    float Cr[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) Cr[n] = valid ? a.C[b * a.sc + int64_t(n) * L + l] : 0.f;

    // Load the tokens s < r0 + kRows, one a thread.
    const bool loader = tid < min(Q, r0 + kRows);
    const int ls = loader ? position(c * Q + tid, a) : 0;
    if (loader) {
#pragma unroll
        for (int n = 0; n < kN; ++n) Bs[tid * kN + n] = a.B[b * a.sb + int64_t(n) * L + ls];
    }
    {
        float cum[HG], xr[HG][P], dtv[HG];
        load_and_scan(a, b, h0, hn, loader, ls, 1.4426950408889634f, cum, xr, dtv, warp_total);
        if (loader) {
            const bool own_row = tid >= r0;
#pragma unroll
            for (int hh = 0; hh < HG; ++hh) {
                cum_s[tid * HG + hh] = cum[hh];
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    xd_s[(tid * HG + hh) * P + p] = xr[hh][p] * dtv[hh];
                    if (own_row) x_s[((tid - r0) * HG + hh) * P + p] = xr[hh][p];
                }
            }
        }
    }
    for (int e = tid; e < hn * kN * P; e += blockDim.x) {
        const int hh = e / (kN * P);
        S_s[e] = a.states == nullptr
                     ? 0.f
                     : a.states[((int64_t(b) * a.H + h0 + hh) * a.nc + c) * (kN * P) + e % (kN * P)];
    }
    __syncthreads();

    float ct[HG];
    load_vec<HG>(cum_s + (valid ? t : 0) * HG, ct);
    float acc[HG][P];
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
#pragma unroll
        for (int p = 0; p < P; ++p) acc[hh][p] = 0.f;

    for (int s = j; valid && s <= t; s += kSplit) {
        float bv[kN];
        load_vec<kN>(Bs + s * kN, bv);
        float q4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < kN; ++n) q4[n % 4] = fmaf(Cr[n], bv[n], q4[n % 4]);
        const float qk = (q4[0] + q4[1]) + (q4[2] + q4[3]);
        float cs[HG];
        load_vec<HG>(cum_s + s * HG, cs);
#pragma unroll
        for (int hh = 0; hh < HG; ++hh) {
            if (hh < hn) {
                const float w = qk * exp2f(ct[hh] - cs[hh]);
                float xv[P];
                load_vec<P>(xd_s + (s * HG + hh) * P, xv);
#pragma unroll
                for (int p = 0; p < P; ++p) acc[hh][p] = fmaf(w, xv[p], acc[hh][p]);
            }
        }
    }
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
            for (int off = kWarp / kSplit; off < kWarp; off *= 2)
                acc[hh][p] += __shfl_xor_sync(0xffffffffu, acc[hh][p], off);
    if (!valid) return;

    // Lane j writes the heads hh = j, j + kSplit, ...
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
        if (hh % kSplit == j && hh < hn) {
            const int h = h0 + hh;
            const float e = exp2f(ct[hh]);
            const float d = a.D[h];
#pragma unroll
            for (int p = 0; p < P; ++p) {
                float inter = 0.f;
#pragma unroll
                for (int n = 0; n < kN; ++n) inter = fmaf(Cr[n], S_s[(hh * kN + n) * P + p], inter);
                const float xv = x_s[((t - r0) * HG + hh) * P + p];
                a.y[int64_t(b) * a.H * P * L + int64_t(h * P + p) * L + l] =
                    acc[hh][p] + inter * e + d * xv;
            }
        }
    }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    return bytes > 48 * 1024
               ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(bytes))
               : cudaSuccess;
}

cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
    constexpr int HG = kHG, P = kP;
    const int groups = (a.H + HG - 1) / HG;
    if (a.nc > 1) {
        const int threads = (a.Q + kWarp - 1) / kWarp * kWarp;
        const size_t smem1 = sizeof(float) * (kN * a.Q + HG * P * (a.Q | 1));
        cudaError_t err = allow_smem(ssd_chunk_states, smem1);
        if (err != cudaSuccess) return err;
        ssd_chunk_states<<<dim3(a.nc, groups, batch), threads, smem1, stream>>>(a);
        const int64_t warps = int64_t(batch) * a.H * kN * P;
        ssd_carry<<<static_cast<unsigned>((warps * kWarp + 255) / 256), 256, 0, stream>>>(
            a.states, a.decay, warps, a.nc, kN * P);
    }
    const int tiles = (a.Q + kRows - 1) / kRows;
    const size_t smem3 =
        sizeof(float) * (a.Q * kN + a.Q * HG * P + HG * kN * P + a.Q * HG + kRows * HG * P);
    cudaError_t err = allow_smem(ssd_chunk_outputs, smem3);
    if (err != cudaSuccess) return err;
    ssd_chunk_outputs<<<dim3(a.nc, groups * tiles, batch), kMaxQ, smem3, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// All tensors float32 on the current device; y and the scratch (states,
// decay: sizes in the Args comments, unused for one chunk) contiguous.
// Returns cudaGetLastError() after the launches.
int adnm_ssd_chunked_scan(const void* x, const void* dt, const void* A, const void* B,
                          const void* C, const void* D, void* y, void* states, void* decay,
                          int64_t sx, int64_t sdt, int64_t sb, int64_t sc, int batch, int H,
                          int P, int N, int L, int Q, int reverse, void* stream) {
    if (P != kP || batch <= 0 || H <= 0 || N != kN || Q <= 0 || Q > kMaxQ || L % Q != 0 ||
        batch > 65535 || (H + kHG - 1) / kHG * ((Q + kRows - 1) / kRows) > 65535)
        return cudaErrorInvalidValue;
    const int nc = L / Q;
    Args a{static_cast<const float*>(x), static_cast<const float*>(dt),
           static_cast<const float*>(A), static_cast<const float*>(B),
           static_cast<const float*>(C), static_cast<const float*>(D),
           static_cast<float*>(y), nc > 1 ? static_cast<float*>(states) : nullptr,
           static_cast<float*>(decay), sx, sdt, sb, sc, H, L, Q, nc, reverse != 0};
    return static_cast<int>(launch(a, batch, static_cast<cudaStream_t>(stream)));
}

const char* adnm_ssd_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
