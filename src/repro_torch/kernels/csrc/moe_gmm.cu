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
// E of at least 1, empty groups included.  Deterministic: every output
// element is summed by one warpgroup (or one thread) in a fixed k order (no
// split over K, no stream-K, no atomics), whichever block takes its tile.
//
// What bounds it on the H100: at phi3.5-moe's layer shape at batch 2
// (M = 16 experts x 1280 rows, K = 4096, N = 6400, bf16) it is 1.07 TFLOP
// against 1.27 GB of inputs and outputs — 845 flops a byte, well above the
// ~295 where the card turns compute bound: the bound is the tensor cores'
// 989 TFLOP/s (1.09 ms).  A small schedule kernel first turns the sizes into
// each group's first row and first row tile (the Pallas grid instead walks
// every (token tile x expert) pair and skips the dead ones); a tile never
// straddles two experts, so no row is masked but a group's ragged last
// tile, and the tiles of the tail group E (the rows past sum(sizes)) write
// zeros.  Two paths:
//
// bf16 with K and N multiples of 8 and 16-byte-aligned pointers (every
// model shape): `gmm_wgmma_kernel`, built from hopper_common.cuh.
//   * output tiles of 128 x 256, each summed by two consumer warpgroups of
//     64 rows through wgmma m64n256k16 (float32 accumulators, 128 registers
//     a thread) straight from shared memory;
//   * one producer thread keeps a 3-stage ring of 64-deep x and w tiles
//     full with TMA (48 KB a stage), mbarriers signalling arrival and
//     release; `setmaxnreg` hands the producer warpgroup's registers to the
//     consumers (24 and 240).  x is a K-major A; w (E, K, N) an MN-major B
//     (trans-b 1) in four 64-column panels, w (E, N, K) read transposed a
//     K-major B (trans-b 0): no transposed copy.  4-D tensor maps keep a
//     box past K inside its expert (zeros, not the next expert's rows); a
//     box of x that reaches into the next group's rows feeds only rows that
//     are not stored;
//   * persistent: one block an SM walks tiles blockIdx.x, + gridDim.x, ...
//     in a fixed raster (group by group, bands of 16 row tiles, the row tile
//     fastest in a band, so that the blocks in flight share a band of x and
//     a few of one expert's weight columns in L2; `tile_order` in
//     kernels/moe_gmm.py is its Python mirror).  The ring runs on across
//     tiles, so the next tile's loads overlap this tile's epilogue;
//   * the epilogue rounds to bf16 into a 64 KB out tile in shared memory
//     (swizzled as TMA lays a box) and TMA-stores it, asynchronously, when
//     a warpgroup's 64 rows all belong to the group; a group's ragged last
//     tile goes out by 16-byte stores of its own rows only (a whole box
//     would overwrite the next group's rows).  The out tile is why the ring
//     has 3 stages and not 4 (227 KB of shared memory).
//   At phi3.5-moe's gate/up shape it takes 1.42-1.46 ms, 735-755 TFLOP/s,
//   1.03-1.04x cuBLAS's bmm on the equal-group layout in the same call
//   (`python -m repro_torch.launch.profile_gmm`, H100 80GB HBM3 at 700 W).
//   What is left: the two warpgroups run their epilogue together, so the
//   tensor cores idle for it (with the stores cut, ~800 TFLOP/s); no
//   cluster multicast of w's tiles.
// float32, or an unaligned width: 64 x 64 tiles of float32 FMAs from shared
// memory, 4 x 4 outputs a thread, one block a tile (float32 must not round
// through TF32's 10-bit mantissa).
// The kernels launch on the caller's stream, allocate nothing (the
// schedule's 2 (E + 2) ints are the caller's scratch) and do not
// synchronise; a tensor map that does not encode fails the launch.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "hopper_common.cuh"

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

// Where a block of the FMA kernel works (one block a tile, the column tile
// fastest): false when it is past the last tile.  Sets the group g, its
// rows [row0, row_end) and the column tile's first column.
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

// ---- bf16 on the tensor cores: wgmma fed by TMA, a persistent walk ------
namespace tc {

using namespace repro::hopper;

constexpr int BM = 128;   // rows of an output tile: two warpgroups of 64
constexpr int BN = 256;   // columns of an output tile: one m64n256 wgmma
constexpr int BK = 64;    // k depth of a ring stage: one 128-byte panel
constexpr int STAGES = 3;
constexpr int BAND = 16;  // row tiles of a band of the raster
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer 2
constexpr int A_BYTES = BM * BK * 2;   // x's 128 rows of 64 k: 16 KB
constexpr int B_BYTES = BN * BK * 2;   // w's 64 k by 256 n: 32 KB
constexpr int B_PANEL = 64 * BK * 2;   // 64 columns of an MN-major w: 8 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int C_BYTES = 64 * BN * 2;   // a warpgroup's 64 x 256 of out: 32 KB
// 1 KB of slack to align the ring, the stages, the two warpgroups' out
// tiles, a full and an empty barrier a stage
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * C_BYTES +
                     8 * 2 * STAGES;

// One output tile: group g's rows [row0, row_end) and the columns from n0.
struct Tile {
    int g, row0, row_end, n0;
};

// Output tiles in the order the blocks walk them: group by group (the
// tail group E last), and inside a group in bands of BAND row tiles, the
// row tile fastest inside a band, so that the blocks in flight read one
// expert's weight columns together and a band's rows of x stay in L2.
// `kernels/moe_gmm.py` `tile_order` is this walk in Python.
__device__ __forceinline__ int tile_count(const int* sched, int E, int n_ct) {
    return sched[E + 2 + E + 1] * n_ct;  // tile_start[E + 1] row tiles
}

__device__ __forceinline__ Tile tile_at(const int* sched, int E, int n_ct,
                                        int t) {
    const int* row_start = sched;
    const int* tile_start = sched + E + 2;
    Tile tl;
    // group g's tiles are [tile_start[g] n_ct, tile_start[g + 1] n_ct)
    tl.g = group_of(tile_start, E, t / n_ct);
    const int first = tile_start[tl.g];
    const int rows = tile_start[tl.g + 1] - first;
    const int u = t - first * n_ct;
    const int band = u / (BAND * n_ct);
    const int in_band = min(BAND, rows - band * BAND);
    const int r = u - band * BAND * n_ct;
    tl.row0 = row_start[tl.g] + (band * BAND + r % in_band) * BM;
    tl.row_end = min(tl.row0 + BM, row_start[tl.g + 1]);
    tl.n0 = (r / in_band) * BN;
    return tl;
}

// out (M, N) = x (M, K) @ w[g] per group: w[g] (K, N) read as an MN-major
// B (trans-b 1), or with TRANS (N, K) read as a K-major B (trans-b 0).
// Each block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ...; the
// producer's ring runs on across tiles, so the next tile's loads overlap
// this tile's epilogue.
template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap tout,
                 __nv_bfloat16* __restrict__ out,
                 const int* __restrict__ sched, int K, int N, int E) {
    extern __shared__ __align__(16) uint8_t tc_smem[];
    uint8_t* ring = align_1024(tc_smem);  // stage s at s * STAGE_BYTES
    uint8_t* cs = ring + STAGES * STAGE_BYTES;  // warpgroup w's at w C_BYTES
    uint64_t* full = reinterpret_cast<uint64_t*>(cs + 2 * C_BYTES);
    uint64_t* empty = full + STAGES;
    const int n_ct = (N + BN - 1) / BN;
    const int total = tile_count(sched, E, n_ct);
    const int ktiles = (K + BK - 1) / BK;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 2 * 128);
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {  // the producer: one thread issues every copy
        setmaxnreg_dec<24>();
        if (threadIdx.x % 128 == 0) {
            tma_prefetch_map(&tx);
            tma_prefetch_map(&tw);
            tma_prefetch_map(&tout);
            int it = 0;  // k tiles loaded so far, over all tiles
            for (int t = blockIdx.x; t < total; t += gridDim.x) {
                const Tile tl = tile_at(sched, E, n_ct, t);
                if (tl.g == E) continue;  // zeros: nothing to load
                // the MN-major w's 64-column panels that hold any of N
                // (a panel wholly past N is not loaded: it would feed only
                // columns that are not stored)
                const int panels =
                    TRANS ? 0 : min(BN / 64, (N - tl.n0 + 63) / 64);
                const uint32_t bytes =
                    A_BYTES + (TRANS ? B_BYTES : panels * B_PANEL);
                for (int kt = 0; kt < ktiles; ++kt, ++it) {
                    const int s = it % STAGES, k0 = kt * BK;
                    mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
                    mbar_arrive_expect_tx(&full[s], bytes);
                    uint8_t* as = ring + s * STAGE_BYTES;
                    uint8_t* bs = as + A_BYTES;
                    tma_load_4d(as, &tx, &full[s], k0, 0, tl.row0, 0);
                    if (TRANS)
                        tma_load_4d(bs, &tw, &full[s], k0, 0, tl.n0, tl.g);
                    else
                        for (int p = 0; p < panels; ++p)
                            tma_load_4d(bs + p * B_PANEL, &tw, &full[s],
                                        tl.n0 + 64 * p, 0, k0, tl.g);
                }
            }
        }
        return;
    }

    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of every tile
    setmaxnreg_inc<240>();
    const int t128 = threadIdx.x % 128, lane = t128 % 32;
    const int rw = wg * 64 + (t128 / 32) * 16 + lane / 4;  // and rw + 8
    const int c2 = 2 * (lane % 4);
    float acc[128];  // 64 x 256, float32
    int it = 0;
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
        const Tile tl = tile_at(sched, E, n_ct, t);
        if (tl.g == E) {  // rows past sum(sizes): zeros, 8 columns a store
            for (int v = t128; v < 64 * (BN / 8); v += 128) {
                const int row = tl.row0 + wg * 64 + v / (BN / 8);
                const int col = tl.n0 + (v % (BN / 8)) * 8;
                if (row < tl.row_end && col < N)
                    *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
                        make_uint4(0, 0, 0, 0);
            }
            continue;
        }
        int held = -1;  // the stage the products in flight read
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
            const int s = it % STAGES;
            const uint8_t* as = ring + s * STAGE_BYTES + wg * 64 * 128;
            const uint8_t* bs = ring + s * STAGE_BYTES + A_BYTES;
            mbar_wait(&full[s], (it / STAGES) & 1);
            fence_regs(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                const uint64_t db =
                    TRANS ? desc_k_major(bs + kk * 32)
                          : desc_mn_major(bs + kk * 16 * 128, B_PANEL);
                // the tile's first product overwrites the accumulator
                wgmma_ss<TRANS ? 0 : 1>(acc, desc_k_major(as + kk * 32), db,
                                        kt > 0 || kk > 0);
            }
            wgmma_commit();
            // the previous k tile's products are done: release its stage
            wgmma_wait<1>();
            fence_regs(acc);
            if (held >= 0) mbar_arrive(&empty[held]);
            held = s;
        }
        wgmma_wait<0>();
        fence_regs(acc);
        if (held >= 0) mbar_arrive(&empty[held]);

        // epilogue: the accumulator rounded to bf16 into this warpgroup's
        // out tile in shared memory (four 64-column panels of 64 rows,
        // 128-byte swizzled as TMA lays a box, so the 32 lanes of a store
        // hit 32 banks), then out to the group's rows only
        const int r0 = tl.row0 + wg * 64;  // this warpgroup's first row
        if (r0 >= tl.row_end) continue;
        uint8_t* c = cs + wg * C_BYTES;
        if (t128 == 0) bulk_wait_read<0>();  // the last tile's store read c
        named_barrier(1 + wg, 128);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = rw - wg * 64 + 8 * r;  // 0 .. 63
#pragma unroll
            for (int i = 0; i < BN / 8; ++i)
                *reinterpret_cast<uint32_t*>(
                    c + (i / 8) * 64 * 128 + row * 128 +
                    (((i % 8) ^ (row % 8)) * 16) + 2 * c2) =
                    pack_bf16(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
        }
        fence_proxy_async();
        named_barrier(1 + wg, 128);
        if (r0 + 64 <= tl.row_end) {
            // all 64 rows are this group's: TMA stores of the panels that
            // hold any of N (the map clips the columns past N)
            if (t128 == 0) {
                for (int p = 0; p < BN / 64 && tl.n0 + 64 * p < N; ++p)
                    tma_store_4d(&tout, c + p * 64 * 128, tl.n0 + 64 * p, 0,
                                 r0, 0);
                bulk_commit();
            }
        } else {
            // a group's ragged last tile: a whole box would overwrite the
            // next group's rows, so 16-byte stores of the rows below
            // row_end (the barrier at the next tile's epilogue orders these
            // reads of c before its writes)
            for (int v = t128; v < 64 * (BN / 8); v += 128) {
                const int row = v / (BN / 8), i = v % (BN / 8);
                const int col = tl.n0 + 8 * i;
                if (r0 + row < tl.row_end && col < N)
                    *reinterpret_cast<uint4*>(out + (size_t)(r0 + row) * N +
                                              col) =
                        *reinterpret_cast<const uint4*>(
                            c + (i / 8) * 64 * 128 + row * 128 +
                            (((i % 8) ^ (row % 8)) * 16));
            }
        }
    }
    if (t128 == 0) bulk_wait<0>();  // the stores are done before the exit
}

// The walk of `blocks` blocks written out: tiles[b][step] = (g, row0,
// row_end, n0) of the step-th tile block b takes, -1 past its last; the
// card test holds it against `tile_order`.
__global__ void walk_kernel(const int* __restrict__ sched, int E, int N,
                            int* __restrict__ tiles, int max_steps) {
    const int n_ct = (N + BN - 1) / BN;
    const int total = tile_count(sched, E, n_ct);
    int* mine = tiles + (size_t)blockIdx.x * max_steps * 4;
    int step = 0;
    for (int t = blockIdx.x; t < total && step < max_steps;
         t += gridDim.x, ++step) {
        const Tile tl = tile_at(sched, E, n_ct, t);
        mine[4 * step] = tl.g;
        mine[4 * step + 1] = tl.row0;
        mine[4 * step + 2] = tl.row_end;
        mine[4 * step + 3] = tl.n0;
    }
    for (; step < max_steps; ++step)
        for (int j = 0; j < 4; ++j) mine[4 * step + j] = -1;
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

// SMs of the current device: the persistent walk launches one block each
int sm_count() {
    static const int n = [] {
        int dev = 0, sms = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        return sms > 0 ? sms : 1;
    }();
    return n;
}

template <bool TRANS>
cudaError_t launch_tc(const void* x, const int* sizes, const void* w,
                      void* out, int* sched, int M, int K, int N, int E,
                      cudaStream_t stream) {
    using namespace repro::hopper;
    // one block an SM, fewer when there can be fewer tiles
    long long tiles;
    if (!grid_blocks(M, E, tc::BM, tc::BN, N, tiles))
        return cudaErrorInvalidValue;
    const int blocks = (int)std::min<long long>(sm_count(), tiles);
    // x (M, K) as (1, M, 1, K) in boxes of 64 k x 128 rows; w (E, K, N) as
    // (E, K, 1, N) in boxes of 64 columns x 64 k, or with TRANS (E, N, K)
    // as (E, N, 1, K) in boxes of 64 k x 256 rows: a box past K (or N)
    // reads zeros inside expert g, never expert g + 1's weights
    // out (M, N) as (1, M, 1, N), stored in boxes of 64 columns x 64 rows
    CUtensorMap tx, tw, tout;
    cudaError_t err = make_map_bf16(&tx, x, 1, M, 1, K, tc::BM);
    if (err == cudaSuccess)
        err = TRANS ? make_map_bf16(&tw, w, E, N, 1, K, tc::BN)
                    : make_map_bf16(&tw, w, E, K, 1, N, 64);
    if (err == cudaSuccess) err = make_map_bf16(&tout, out, 1, M, 1, N, 64);
    if (err != cudaSuccess) return err;
    auto kernel = tc::gmm_wgmma_kernel<TRANS>;
    const cudaError_t attr =
        repro::allow_smem<tc::gmm_wgmma_kernel<TRANS>>(tc::SMEM);
    if (attr != cudaSuccess) return attr;
    schedule_kernel<<<1, SCHED_THREADS, 0, stream>>>(sizes, E, M, tc::BM,
                                                     sched);
    kernel<<<blocks, tc::THREADS, tc::SMEM, stream>>>(
        tx, tw, tout, static_cast<__nv_bfloat16*>(out), sched, K, N, E);
    return cudaGetLastError();
}

}  // namespace

// 1 when a launch with these arguments (and 16-byte-aligned pointers) runs
// on the tensor cores: the one rule `repro_moe_gmm` follows
extern "C" int repro_moe_gmm_tensor_cores(int K, int N, int dtype) {
    return dtype == 1 && K % 8 == 0 && N % 8 == 0;
}

// x (M, K), sizes (E,) int32, w (E, K, N) or with trans (E, N, K), out
// (M, N); sched: 2 (E + 2) int32 of scratch.  dtype: 0 = float32,
// 1 = bfloat16.  M, K, N and E at least 1.  *tensor_cores (host memory)
// gets 1 when the tensor-core kernel was launched, 0 when the FMA kernel
// was.  Returns a cudaError_t (0 = success).
extern "C" int repro_moe_gmm(const void* x, const void* sizes, const void* w,
                             void* out, void* sched, int M, int K, int N,
                             int E, int trans, int dtype, void* stream,
                             int* tensor_cores) {
    if (M < 1 || K < 1 || N < 1 || E < 1 || (dtype != 0 && dtype != 1) ||
        (trans != 0 && trans != 1) || tensor_cores == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* sz = static_cast<const int*>(sizes);
    int* sc = static_cast<int*>(sched);
    cudaError_t err;
    *tensor_cores = repro_moe_gmm_tensor_cores(K, N, dtype) &&
        aligned16(x) && aligned16(w) && aligned16(out);
    if (*tensor_cores)
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
                    : launch_simt<float, false>(x, sz, w, out, sc, M, K, N,
                                               E, st);
    return (int)err;
}

// The tensor-core walk for these sizes, run by `blocks` blocks on the card
// as the kernel runs it: tiles (blocks, max_steps, 4) int32 gets each
// block's (group, row0, row_end, n0) in order, -1 past its last tile.
extern "C" int repro_moe_gmm_walk(const void* sizes, void* sched,
                                  void* tiles, int M, int N, int E,
                                  int blocks, int max_steps, void* stream) {
    if (M < 1 || N < 1 || E < 1 || blocks < 1 || max_steps < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    schedule_kernel<<<1, SCHED_THREADS, 0, st>>>(
        static_cast<const int*>(sizes), E, M, tc::BM,
        static_cast<int*>(sched));
    tc::walk_kernel<<<blocks, 1, 0, st>>>(static_cast<const int*>(sched), E,
                                          N, static_cast<int*>(tiles),
                                          max_steps);
    return (int)cudaGetLastError();
}
