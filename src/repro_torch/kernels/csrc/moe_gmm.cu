// Grouped (ragged) matmul over expert-sorted rows (K4) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the TPU kernel `moe_gmm_sorted` of the reference package
// (src/repro/kernels/moe_gmm.py, body `_gmm_kernel`): tokens x (M, K) are
// sorted so that expert e owns the rows [start_e, start_e + sizes[e]), with
// start_e the sum of the sizes before it, and
//   out[i] = x[i] @ w[e(i)]          w (E, K, N), out (M, N)
// or, with `trans`, out[i] = x[i] @ w[e(i)]^T for w (E, N, K): the backward's
// dX = dY W_e^T reads the forward's weights as they lie, with no transposed
// copy (839 MB a call at phi3.5-moe's width).  Rows past sum(sizes) (clamped
// to M) come out zero, as in the Pallas kernel, which masks them for every
// expert.  bf16 or float32 in and out, float32 accumulation, any M, K, N and
// E, empty groups included.  Deterministic: every output element is summed
// by one thread in a fixed order (no split over K, no atomics).
//
// What bounds it on the H100: at phi3.5-moe's layer shape at batch 2
// (M = 16 experts x 1280 rows, K = 4096, N = 6400, bf16) it is 1.07 TFLOP
// against 0.3 GB of inputs and outputs — 3,600 flops a byte, far above the
// ~295 where the card turns compute bound: the bound is the tensor cores'
// 989 TFLOP/s (1.09 ms).  What the design does:
//   * the Pallas grid walks every (token tile x expert) pair in order and
//     skips dead pairs; here a small schedule kernel turns the sizes into
//     each group's first row and first tile, and the main grid is one block
//     per (row tile of one group, column tile of N): no block is dead except
//     the grid's slack past the last tile (at most E + 1 row tiles), and a
//     tile never straddles two experts, so no row is masked but the group's
//     ragged last tile; the tiles past sum(sizes) write zeros;
//   * column tiles are the fastest grid index, so the blocks in flight share
//     a few row tiles of x in L2 and walk one expert's weights together;
//   * bf16 with K and N multiples of 8 (every model shape): 128 x 128 tiles
//     on the tensor cores through warp-level bf16 MMA (nvcuda::wmma, 16x16x16
//     fragments, float32 accumulators), eight warps of 64 x 32, the x and w
//     tiles (64 deep) double-buffered in shared memory by cp.async 16-byte
//     copies, so the next tiles load while the current one multiplies; the
//     registers are capped at 128 a thread so that two blocks share an SM
//     (uncapped, the kernel takes 164 and one block of eight warps an SM
//     leaves the tensor cores waiting on each tile's barrier); the
//     transposed weights are staged as (N, K) rows and read as column-major
//     fragments;
//   * float32, or an unaligned width: 64 x 64 tiles of float32 FMAs from
//     shared memory, 4 x 4 outputs a thread (float32 must not round through
//     TF32's 10-bit mantissa).
// This first version uses no wgmma, TMA or clusters.  The kernels launch on
// the caller's stream, allocate nothing (the schedule's 2 (E + 2) ints are
// the caller's scratch) and do not synchronise.
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

// ---- the schedule ----------------------------------------------------------
// Group g < E is expert g's rows; group E is the rows past sum(sizes).
// row_start[g] (g = 0 .. E + 1, row_start[E + 1] = M) and tile_start[g]
// (tile_start[E + 1] = the number of row tiles) are written to `sched`.
constexpr int SCHED_THREADS = 256;

__global__ void __launch_bounds__(SCHED_THREADS)
schedule_kernel(const int* __restrict__ sizes, int E, int M, int BM,
                int* __restrict__ sched) {
    __shared__ int s_size[SCHED_THREADS];
    int* row_start = sched;
    int* tile_start = sched + E + 2;
    long long rows = 0;  // unclamped sum of the sizes so far
    int tiles = 0;
    for (int c0 = 0; c0 < E; c0 += SCHED_THREADS) {
        const int g = c0 + threadIdx.x;
        if (g < E) s_size[threadIdx.x] = max(sizes[g], 0);
        __syncthreads();
        if (threadIdx.x == 0) {
            const int n = min(SCHED_THREADS, E - c0);
            for (int i = 0; i < n; ++i) {
                const int lo = (int)min(rows, (long long)M);
                rows += s_size[i];
                const int hi = (int)min(rows, (long long)M);
                row_start[c0 + i] = lo;
                tile_start[c0 + i] = tiles;
                tiles += (hi - lo + BM - 1) / BM;
            }
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        const int lo = (int)min(rows, (long long)M);
        row_start[E] = lo;
        tile_start[E] = tiles;
        row_start[E + 1] = M;
        tile_start[E + 1] = tiles + (M - lo + BM - 1) / BM;
    }
}

// The group of row tile t: the largest g with tile_start[g] <= t (empty
// groups share their tile_start with the next group and are skipped).
__device__ __forceinline__ int group_of(const int* tile_start, int E, int t) {
    int lo = 0, hi = E;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (tile_start[mid] <= t) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// Where this block works: false when it is past the last tile.  Sets the
// group g, its rows [row0, row_end) and the column tile's first column.
__device__ __forceinline__ bool locate(const int* sched, int E, int BM,
                                       int BN, int N, int& g, int& row0,
                                       int& row_end, int& n0) {
    const int* row_start = sched;
    const int* tile_start = sched + E + 2;
    const int n_tiles = (N + BN - 1) / BN;
    const int t = blockIdx.x / n_tiles;
    n0 = (blockIdx.x - t * n_tiles) * BN;
    if (t >= tile_start[E + 1]) return false;
    g = group_of(tile_start, E, t);
    row0 = row_start[g] + (t - tile_start[g]) * BM;
    row_end = min(row0 + BM, row_start[g + 1]);
    return true;
}

// ---- bf16 on the tensor cores ---------------------------------------------
namespace tc {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 64, STAGES = 2, THREADS = 256;
constexpr int LDA = BK + 8;            // x tile (BM, BK), row-major
constexpr int LDB = BN + 8;            // w tile (BK, BN), row-major
constexpr int LDBT = BK + 8;           // transposed w tile (BN, BK)
constexpr int A_ELEMS = BM * LDA;
constexpr int B_ELEMS = BN * LDBT > BK * LDB ? BN * LDBT : BK * LDB;
constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
constexpr int WARP_M = 64, WARP_N = 32;  // 2 x 4 warps
constexpr int FM = WARP_M / 16, FN = WARP_N / 16;
constexpr size_t SMEM = sizeof(__nv_bfloat16) * STAGES * STAGE_ELEMS
                        + sizeof(float) * (THREADS / 32) * 256;

__device__ __forceinline__ void zero16(__nv_bfloat16* dst) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// Stage k tile kt of x's rows [row0, row_end) and of w[g] into `st`.
template <bool TRANS>
__device__ __forceinline__ void load_stage(
        __nv_bfloat16* st, const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ wg, int row0, int row_end, int n0,
        int kt, int K, int N) {
    const int k0 = kt * BK;
    __nv_bfloat16* As = st;
    __nv_bfloat16* Bs = st + A_ELEMS;
    // x: BM rows of BK, BK / 8 vectors of 8 a row
    for (int v = threadIdx.x; v < BM * (BK / 8); v += THREADS) {
        const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
        __nv_bfloat16* dst = As + r * LDA + c;
        if (row0 + r < row_end && k0 + c < K)
            __pipeline_memcpy_async(dst, x + (size_t)(row0 + r) * K + k0 + c,
                                    16);
        else
            zero16(dst);
    }
    if (TRANS) {  // w[g] is (N, K): BN rows of BK
        for (int v = threadIdx.x; v < BN * (BK / 8); v += THREADS) {
            const int n = v / (BK / 8), c = (v % (BK / 8)) * 8;
            __nv_bfloat16* dst = Bs + n * LDBT + c;
            if (n0 + n < N && k0 + c < K)
                __pipeline_memcpy_async(
                    dst, wg + (size_t)(n0 + n) * K + k0 + c, 16);
            else
                zero16(dst);
        }
    } else {  // w[g] is (K, N): BK rows of BN
        for (int v = threadIdx.x; v < BK * (BN / 8); v += THREADS) {
            const int k = v / (BN / 8), c = (v % (BN / 8)) * 8;
            __nv_bfloat16* dst = Bs + k * LDB + c;
            if (k0 + k < K && n0 + c < N)
                __pipeline_memcpy_async(
                    dst, wg + (size_t)(k0 + k) * N + n0 + c, 16);
            else
                zero16(dst);
        }
    }
}

template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 2)  // two blocks an SM
gmm_tc_kernel(const __nv_bfloat16* __restrict__ x,
              const __nv_bfloat16* __restrict__ w,
              __nv_bfloat16* __restrict__ out, const int* __restrict__ sched,
              int K, int N, int E) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    float* scratch = reinterpret_cast<float*>(
        smem_raw + sizeof(__nv_bfloat16) * STAGES * STAGE_ELEMS);
    int g, row0, row_end, n0;
    if (!locate(sched, E, BM, BN, N, g, row0, row_end, n0)) return;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (g == E) {  // rows past sum(sizes): zeros
        for (int v = threadIdx.x; v < BM * (BN / 8); v += THREADS) {
            const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
            if (row0 + r < row_end && n0 + c < N)
                zero16(out + (size_t)(row0 + r) * N + n0 + c);
        }
        return;
    }
    const __nv_bfloat16* wg = w + (size_t)g * K * N;
    const int wm = warp / (BN / WARP_N), wn = warp % (BN / WARP_N);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const int ktiles = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ktiles)
            load_stage<TRANS>(ring + s * STAGE_ELEMS, x, wg, row0, row_end,
                              n0, s, K, N);
        __pipeline_commit();
    }
    using BLayout = typename std::conditional<TRANS, wmma::col_major,
                                              wmma::row_major>::type;
    for (int kt = 0; kt < ktiles; ++kt) {
        __pipeline_wait_prior(STAGES - 2);  // this thread's copies of kt
        __syncthreads();  // everyone's copies; stage kt - 1 fully consumed
        const int next = kt + STAGES - 1;
        if (next < ktiles)
            load_stage<TRANS>(ring + (next % STAGES) * STAGE_ELEMS, x, wg,
                              row0, row_end, n0, next, K, N);
        __pipeline_commit();
        const __nv_bfloat16* As = ring + (kt % STAGES) * STAGE_ELEMS;
        const __nv_bfloat16* Bs = As + A_ELEMS;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a[FM];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           BLayout> b[FN];
#pragma unroll
            for (int i = 0; i < FM; ++i)
                wmma::load_matrix_sync(
                    a[i], As + (wm * WARP_M + i * 16) * LDA + kk, LDA);
#pragma unroll
            for (int j = 0; j < FN; ++j) {
                const int n = wn * WARP_N + j * 16;
                if (TRANS)
                    wmma::load_matrix_sync(b[j], Bs + n * LDBT + kk, LDBT);
                else
                    wmma::load_matrix_sync(b[j], Bs + kk * LDB + n, LDB);
            }
#pragma unroll
            for (int i = 0; i < FM; ++i)
#pragma unroll
                for (int j = 0; j < FN; ++j)
                    wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
        }
    }
    __pipeline_wait_prior(0);

    // epilogue: each fragment through the warp's 16 x 16 float scratch, then
    // 8 bf16 (16 bytes) a lane to the rows of this group only
    float* sc = scratch + warp * 256;
    const int r = lane / 2, c = (lane % 2) * 8;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) {
            wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
            __syncwarp();
            const int row = row0 + wm * WARP_M + i * 16 + r;
            const int col = n0 + wn * WARP_N + j * 16 + c;
            if (row < row_end && col < N) {
                uint4 pk;
                __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&pk);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    h[e] = __floats2bfloat162_rn(sc[r * 16 + c + 2 * e],
                                                 sc[r * 16 + c + 2 * e + 1]);
                *reinterpret_cast<uint4*>(out + (size_t)row * N + col) = pk;
            }
            __syncwarp();
        }
}

}  // namespace tc

// ---- float32 FMAs (float32, and bf16 at widths that are not 8-aligned) ----
namespace simt {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256, TM = 4, TN = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
gmm_fma_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, const int* __restrict__ sched, int K,
               int N, int E) {
    __shared__ float As[BK][BM + 4];  // x tile, k-major
    __shared__ float Bs[BK][BN + 4];
    int g, row0, row_end, n0;
    if (!locate(sched, E, BM, BN, N, g, row0, row_end, n0)) return;
    const int tid = threadIdx.x;
    const int ty = tid / (BN / TN), tx = tid % (BN / TN);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    if (g < E) {
        const T* wg = w + (size_t)g * K * N;
        for (int k0 = 0; k0 < K; k0 += BK) {
            for (int v = tid; v < BM * BK; v += THREADS) {
                const int m = v / BK, k = v % BK;
                As[k][m] = (row0 + m < row_end && k0 + k < K)
                    ? to_f(x[(size_t)(row0 + m) * K + k0 + k]) : 0.f;
            }
            for (int v = tid; v < BK * BN; v += THREADS) {
                int k, n;
                size_t off;
                if (TRANS) {  // w[g] is (N, K)
                    n = v / BK; k = v % BK;
                    off = (size_t)(n0 + n) * K + k0 + k;
                } else {      // w[g] is (K, N)
                    k = v / BN; n = v % BN;
                    off = (size_t)(k0 + k) * N + n0 + n;
                }
                Bs[k][n] = (k0 + k < K && n0 + n < N) ? to_f(wg[off]) : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < BK; ++k) {
                float a[TM], b[TN];
#pragma unroll
                for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
                for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
            }
            __syncthreads();
        }
    }
    // group E (rows past sum(sizes)) keeps its zeros
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int row = row0 + ty * TM + i;
        if (row >= row_end) continue;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int col = n0 + tx * TN + j;
            if (col < N) repro::store(out + (size_t)row * N + col, acc[i][j]);
        }
    }
}

}  // namespace simt

bool aligned16(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool grid_blocks(int M, int E, int BM, int BN, int N, long long& blocks) {
    // row tiles of the E groups and the tail: at most ceil(M / BM) + E
    const long long row_tiles = (M + BM - 1) / BM + (long long)E;
    blocks = row_tiles * ((N + BN - 1) / BN);
    return blocks <= 0x7fffffffLL;
}

template <typename T, bool TRANS>
cudaError_t launch_simt(const void* x, const int* sizes, const void* w,
                       void* out, int* sched, int M, int K, int N, int E,
                       cudaStream_t stream) {
    long long blocks;
    if (!grid_blocks(M, E, simt::BM, simt::BN, N, blocks))
        return cudaErrorInvalidValue;
    schedule_kernel<<<1, SCHED_THREADS, 0, stream>>>(sizes, E, M, simt::BM,
                                                     sched);
    simt::gmm_fma_kernel<T, TRANS><<<(unsigned)blocks, simt::THREADS, 0,
                                    stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), sched, K, N, E);
    return cudaGetLastError();
}

template <bool TRANS>
cudaError_t launch_tc(const void* x, const int* sizes, const void* w,
                      void* out, int* sched, int M, int K, int N, int E,
                      cudaStream_t stream) {
    long long blocks;
    if (!grid_blocks(M, E, tc::BM, tc::BN, N, blocks))
        return cudaErrorInvalidValue;
    auto kernel = tc::gmm_tc_kernel<TRANS>;
    // allow the ring once (not per launch, so that launches can be captured
    // in a CUDA graph)
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tc::SMEM);
    if (attr != cudaSuccess) return attr;
    schedule_kernel<<<1, SCHED_THREADS, 0, stream>>>(sizes, E, M, tc::BM,
                                                     sched);
    kernel<<<(unsigned)blocks, tc::THREADS, tc::SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), sched, K, N, E);
    return cudaGetLastError();
}

}  // namespace

// x (M, K), sizes (E,) int32, w (E, K, N) or with trans (E, N, K), out
// (M, N); sched: 2 (E + 2) int32 of scratch.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int repro_moe_gmm(const void* x, const void* sizes, const void* w,
                             void* out, void* sched, int M, int K, int N,
                             int E, int trans, int dtype, void* stream) {
    if (M < 1 || K < 0 || N < 1 || E < 0 || (dtype != 0 && dtype != 1) ||
        (trans != 0 && trans != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* sz = static_cast<const int*>(sizes);
    int* sc = static_cast<int*>(sched);
    cudaError_t err;
    const bool tensor_cores = dtype == 1 && K % 8 == 0 && N % 8 == 0 &&
        aligned16(x) && aligned16(w) && aligned16(out);
    if (tensor_cores)
        err = trans ? launch_tc<true>(x, sz, w, out, sc, M, K, N, E, st)
                    : launch_tc<false>(x, sz, w, out, sc, M, K, N, E, st);
    else if (dtype == 1)
        err = trans ? launch_simt<__nv_bfloat16, true>(x, sz, w, out, sc, M,
                                                      K, N, E, st)
                    : launch_simt<__nv_bfloat16, false>(x, sz, w, out, sc, M,
                                                       K, N, E, st);
    else
        err = trans ? launch_simt<float, true>(x, sz, w, out, sc, M, K, N, E,
                                              st)
                    : launch_simt<float, false>(x, sz, w, out, sc, M, K, N, E,
                                               st);
    return (int)err;
}

// 1 when a launch with these arguments runs on the tensor cores
extern "C" int repro_moe_gmm_tensor_cores(int K, int N, int dtype) {
    return dtype == 1 && K % 8 == 0 && N % 8 == 0;
}
