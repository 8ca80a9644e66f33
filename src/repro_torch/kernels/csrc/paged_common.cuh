// The paged page walk shared by K2 (paged decode, paged_attention.cu) and K3
// (paged verify, paged_attention_mq.cu) for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernels `paged_attention_bkgd` / `_paged_kernel` and
// `paged_attention_mq_bkgd` / `_paged_mq_kernel` of
// src/repro/kernels/paged_attention.py.  K2 is K3 at T = 1: query row
// r = t * G + g of slot b and KV head kh (query head kh * G + g, draft
// position t) sees the kv positions < min(base[b] + t, max_pages * page),
// where base is K2's kv_len or K3's base_len.  Token p of slot b lives at
// pool[kh, table[b, p / page], p % page, :]; unmapped entries (-1) clamp
// to the null page 0.  Scores, softmax and sums are float32, in base 2
// (scores scaled by scale * log2 e, exp2); masked scores weigh exactly 0,
// and the denominator is clamped at 1e-30, so a row that sees nothing gets
// zeros.
//
// What bounds it on the H100: each visible K/V byte is read once for all
// rows of its KV head, 4 R D flops against 4 D bytes (bf16) per token with
// R = T G rows: 6 flops a byte for K2 and 30 for K3 at qwen2-1.5b's G = 6
// and spec_k 4, far under the ~295 where the card turns compute bound.
// The bound is the bytes of the visible pages.  What the design does:
//   * a split over the sequence (split-KV): the grid is (splits x row
//     tiles, KH, B); split s walks the table entries [s pps, (s + 1) pps),
//     pps pages a split, a whole number of 64-token chunks and of pages.
//     The caller chooses `splits` from B, KH, max_pages and the SM count
//     alone (never from the lengths, which live on the card), about one
//     wave of blocks (one block an SM: a second round of blocks costs more
//     than the merge of fewer, longer splits saves).  With one split the walk writes the output;
//     otherwise each block writes float32 partials (m, l, acc) and
//     `paged_merge_kernel` adds them in split order (deterministic bit for
//     bit).  A split wholly past what its rows see writes an empty
//     partial (m = -1e30, l = 0, acc = 0) and exits;
//   * the tensor-core walk (bf16, D 64 or 128, a page of 8, 16, 32 or 64
//     rows or a multiple of 64): one producer warp keeps a ring of STAGES
//     64-token chunks of K and V full with TMA, each page (or 64-row part
//     of a page) a box of a 4-D tensor map over the pool (D, page, P, KH)
//     at coordinates (d0, row, table[b, j], kh): the Hopper counterpart of
//     the Pallas index map (h, pt[b, j], 0, 0).  The warp holds 32 table
//     entries in its lanes and hands them out by shuffles.  Pages at or
//     past what the tile's last row sees are never loaded.  One consumer
//     warpgroup holds a tile of 64 query rows (G rows for K2, T G for K3,
//     padded with zero rows), S = Q K^T by wgmma m64n64k16 from shared
//     memory (K K-major), the per-row limits applied to S in registers,
//     the online softmax in registers, and O += P V by wgmma m64n{64,128}k16
//     with P rounded to bf16 in registers and V MN-major, as K1's
//     flash_fwd_tc_kernel.  The tensor maps of a pool are encoded once and
//     kept (keyed by pointer and shape): the pools live as long as the
//     engine, and encoding costs host time a decode step cannot spare;
//   * the FMA walk (float32, and widths or pages the tensor-core walk does
//     not take): the same split, 64-token chunks staged in shared memory as
//     float32 by 16-byte loads, scores and sums by FMAs, rows tiled over
//     blocks by what fits in shared memory.
// All inputs are contiguous and 16-byte aligned, D a multiple of 8.  The
// kernels launch on the caller's stream, allocate nothing (the caller
// passes the partials' scratch) and do not synchronise.
#pragma once

#include <mutex>

#include "common.cuh"
#include "hopper_common.cuh"

namespace repro {
namespace paged {
namespace {

using repro::LOG2E;
using repro::NEG_INF;

constexpr int CT = 64;            // kv tokens a chunk, both walks
constexpr int TC_ROWS = 64;       // query rows of a tensor-core tile
constexpr int STAGES = 4;         // chunks in the tensor-core ring
constexpr int TC_THREADS = 160;   // one consumer warpgroup + a producer warp
constexpr int FMA_THREADS = 256;
constexpr int U = 4;              // 16-byte loads per tensor in flight
constexpr size_t MAX_SMEM = 232448;  // what a block may use on sm_90
constexpr int PANEL = CT * 128;   // one 64-column bf16 panel of a chunk

// 1 when the walk runs on the tensor cores: bf16, D 64 or 128, and a page
// that is a whole number of TMA boxes of at least 8 rows per chunk
inline bool tensor_cores(int D, int page, int dtype) {
    return dtype == 1 && (D == 64 || D == 128) && page >= 8 &&
           (CT % page == 0 || page % CT == 0);
}

// --- the FMA walk's row tiles (shared memory grows with rows x D) ---------
inline size_t fma_smem(int rows, int d) {
    return sizeof(float) *
        (size_t)(2 * rows * d + rows * CT + 3 * rows + CT * (2 * d + 1));
}

// the fewest tiles whose largest layout fits, balanced (0 when rows < 1 or
// not even one row fits)
inline int fma_tile_rows(int rows, int d) {
    const long fixed = (long)CT * (2 * d + 1);
    const long per_row = 2L * d + CT + 3;
    const long words = (long)(MAX_SMEM / sizeof(float));
    const int fit = (int)((words - fixed) / per_row);
    if (rows < 1 || fit < 1) return 0;
    const int tiles = (rows + fit - 1) / fit;
    return (rows + tiles - 1) / tiles;
}

// rows of one row tile of a launch for rows = T * G
inline int tile_rows(int rows, int d, int page, int dtype) {
    if (rows < 1) return 0;
    return tensor_cores(d, page, dtype) ? (rows < TC_ROWS ? rows : TC_ROWS)
                                        : fma_tile_rows(rows, d);
}

// --- the split ------------------------------------------------------------
inline int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// pages of a split unit: whole pages that are also whole 64-token chunks
inline int unit_pages(int page) { return CT / gcd(page, CT); }

// pages each of `splits` splits walks; 0 when `splits` does not cut the
// table into that many non-empty page-aligned ranges
inline int split_pages(int max_pages, int page, int splits) {
    const int unit = unit_pages(page);
    const int units = (max_pages + unit - 1) / unit;
    if (splits < 1 || splits > units) return 0;
    const int per = (units + splits - 1) / splits;
    if ((units + per - 1) / per != splits) return 0;
    return per * unit;
}

// --- the arguments of a launch ---------------------------------------------
struct Args {
    const void* q;      // (B, T, H, D)
    const int* table;   // (B, max_pages)
    const int* base;    // (B,): kv_len (K2) or base_len (K3)
    void* out;          // (B, T, H, D)
    float* acc;         // (B, KH, splits, rows, D) partials, or null
    float* ml;          // (B, KH, splits, rows, 2) partials, or null
    int T, KH, G, D, P, page, max_pages;
    int tile, tiles;    // query rows a tile, tiles of the rows
    int splits, pps;    // splits, pages a split
    float scale;
};

// the rows and kv range [lo, hi) one block walks, and its rows' limit
struct Walk {
    int r0, R;   // the tile's first row and its rows
    int lo, hi;  // kv positions the block walks
    int end;     // the split's end (capped at the table's end)
    int base;
};

__device__ __forceinline__ Walk walk_of(const Args& a, int tile, int split,
                                        int b) {
    Walk w;
    const int rows = a.T * a.G;
    w.r0 = tile * a.tile;
    w.R = min(a.tile, rows - w.r0);
    w.base = a.base[b];
    w.lo = split * a.pps * a.page;
    w.end = min(a.max_pages * a.page, w.lo + a.pps * a.page);
    // what the tile's furthest row sees
    const int seen = w.base + (w.r0 + w.R - 1) / a.G;
    w.hi = max(w.lo, min(w.end, seen));
    return w;
}

// offset of element 0 of row r (r = t * G + g) of the (B, T, H, D) layout
__device__ __forceinline__ size_t row_at(const Args& a, int b, int kh,
                                         int r) {
    const int t = r / a.G, g = r - t * a.G;
    return (((size_t)b * a.T + t) * a.KH * a.G + kh * a.G + g) * a.D;
}

// offset of row r's partial of split s (in rows; acc adds x D, ml x 2)
__device__ __forceinline__ size_t part_at(const Args& a, int b, int kh,
                                          int s, int r) {
    return (((size_t)b * a.KH + kh) * a.splits + s) * (a.T * a.G) + r;
}

// ---------------------------------------------------------------------------
// The tensor-core walk: P 64-column panels of D
template <int P>
struct Tc {
    static constexpr int Q_BYTES = P * TC_ROWS * 128;
    static constexpr int KV_BYTES = P * PANEL;  // one of K or V a stage
    // 1 KB of slack to align the tiles, then Q, the K and V stages and the
    // barriers (full and empty a stage)
    static constexpr int SMEM =
        1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * 2 * STAGES;
};

template <int P>
__global__ void __launch_bounds__(TC_THREADS)
paged_tc_kernel(const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const Args a) {
    using namespace repro::hopper;
    using C = Tc<P>;
    extern __shared__ __align__(16) uint8_t pg_smem[];
    uint8_t* Qs = align_1024(pg_smem);
    uint8_t* Ks = Qs + C::Q_BYTES;            // stage s at s * KV_BYTES
    uint8_t* Vs = Ks + STAGES * C::KV_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_BYTES);
    uint64_t* empty = full + STAGES;

    const int tile = blockIdx.x % a.tiles, split = blockIdx.x / a.tiles;
    const int kh = blockIdx.y, b = blockIdx.z;
    const Walk w = walk_of(a, tile, split, b);
    const int n_chunks = (w.hi - w.lo + CT - 1) / CT;
    const int t = threadIdx.x;

    if (n_chunks == 0) {  // nothing visible: an empty partial, or zeros
        for (int idx = t; idx < w.R * a.D; idx += TC_THREADS) {
            const int r = w.r0 + idx / a.D, d = idx % a.D;
            if (a.acc == nullptr) {
                reinterpret_cast<__nv_bfloat16*>(a.out)[row_at(a, b, kh, r)
                                                        + d] =
                    __float2bfloat16(0.f);
            } else {
                const size_t at = part_at(a, b, kh, split, r);
                a.acc[at * a.D + d] = 0.f;
                if (d == 0) {
                    a.ml[2 * at] = NEG_INF;
                    a.ml[2 * at + 1] = 0.f;
                }
            }
        }
        return;
    }

    // A last chunk with pages past `hi` leaves those rows of its V stage
    // unloaded; zero them first if that stage has never been loaded (rows
    // a full chunk left there are finite, and weigh 0)
    const int last = n_chunks - 1;
    if (a.page < CT && last < STAGES &&
        w.hi - (w.lo + last * CT) <= CT - a.page) {
        uint4* vz = reinterpret_cast<uint4*>(Vs + last * C::KV_BYTES);
        for (int i = t; i < C::KV_BYTES / 16; i += TC_THREADS)
            vz[i] = make_uint4(0, 0, 0, 0);
        fence_proxy_async();
    }
    if (t == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 128);
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (t >= 128) {  // the producer warp
        const int lane = t & 31;
        const int* trow = a.table + (size_t)b * a.max_pages;
        const int box_rows = a.page < CT ? a.page : CT;
        const int per_chunk = CT / box_rows;  // boxes a chunk and panel
        const uint32_t box_bytes = box_rows * 128;
        if (lane == 0) {
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
        }
        int w0 = -64, win = 0;  // lanes hold table entries w0 .. w0 + 31
        for (int i = 0; i < n_chunks; ++i) {
            const int s = i % STAGES, c0 = w.lo + i * CT;
            const int j0 = c0 / a.page;  // the chunk's first page
            // boxes to load: the pages (or the page part) below hi
            const int nb = min(per_chunk, (w.hi - c0 + box_rows - 1) / box_rows);
            if (j0 >= w0 + 32) {  // j0 .. j0 + per_chunk - 1 share a window
                w0 = j0 & ~31;
                win = w0 + lane < a.max_pages ? trow[w0 + lane] : 0;
            }
            const int mine = __shfl_sync(0xffffffffu, win, (j0 - w0 + lane) & 31);
            mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
            if (lane == 0)
                mbar_arrive_expect_tx(&full[s], 2u * nb * P * box_bytes);
            __syncwarp();
            if (lane < nb) {  // lane q loads box q of the chunk
                const int pid = max(mine, 0);  // -1 -> the null page 0
                const int row = a.page < CT ? 0 : c0 % a.page;
                uint8_t* kst = Ks + s * C::KV_BYTES + lane * box_bytes;
                uint8_t* vst = Vs + s * C::KV_BYTES + lane * box_bytes;
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    tma_load_4d(kst + p * PANEL, &tk, &full[s], 64 * p, row,
                                pid, kh);
                    tma_load_4d(vst + p * PANEL, &tv, &full[s], 64 * p, row,
                                pid, kh);
                }
            }
        }
        return;
    }

    // the consumer warpgroup: stage the tile's rows of Q (zero rows past R)
    // in 128-byte-swizzled panels
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    for (int idx = t; idx < TC_ROWS * P * 8; idx += 128) {
        const int r = idx / (P * 8), c = idx % (P * 8);  // 8-column piece c
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < w.R)
            v = *reinterpret_cast<const uint4*>(
                q + row_at(a, b, kh, w.r0 + r) + 8 * c);
        *reinterpret_cast<uint4*>(Qs + (c / 8) * TC_ROWS * 128 +
                                  sw128(r, 8 * (c % 8))) = v;
    }
    fence_proxy_async();
    named_barrier(1, 128);

    const int lane = t % 32;
    const int rw = (t / 32) * 16 + lane / 4;  // this thread's rows rw, rw + 8
    const int c2 = 2 * (lane % 4);
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int r = rw + 8 * h;
        lim[h] = r < w.R ? min(w.end, w.base + (w.r0 + r) / a.G) : 0;
    }
    const float sl2 = a.scale * LOG2E;
    float o[32 * P];
#pragma unroll
    for (int i = 0; i < 32 * P; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    for (int i = 0; i < n_chunks; ++i) {
        const int s = i % STAGES, c0 = w.lo + i * CT;
        const uint8_t* kst = Ks + s * C::KV_BYTES;
        const uint8_t* vst = Vs + s * C::KV_BYTES;
        mbar_wait(&full[s], (i / STAGES) & 1);

        float sc[32];  // S = Q K^T, 64 x 64
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * P; ++kk) {
            const int at = (kk / 4) * PANEL + (kk % 4) * 32;
            wgmma_ss<0>(sc, desc_k_major(Qs + at), desc_k_major(kst + at),
                        kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // the per-row limits, then the online softmax; a masked score
        // weighs 0 even in a row that has seen nothing yet
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int h = (j / 2) % 2;
            const int kpos = c0 + 8 * (j / 4) + c2 + (j % 2);
            const float x = kpos < lim[h] ? sc[j] * sl2 : NEG_INF;
            sc[j] = x;
            mx[h] = fmaxf(mx[h], x);
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
            alpha[h] = exp2f(m[h] - mx[h]);
            m[h] = mx[h];
            l[h] *= alpha[h];
        }
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int h = (j / 2) % 2;
            const float p = sc[j] == NEG_INF ? 0.f : exp2f(sc[j] - m[h]);
            l[h] += p;
            sc[j] = p;
        }
#pragma unroll
        for (int j = 0; j < 32 * P; ++j) o[j] *= alpha[(j / 2) % 2];

        uint32_t pa[4][4];  // P in bf16, the A operand of O += P V
        acc_to_a(sc, pa);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < CT / 16; ++kk)
            wgmma_rs<1>(o, pa[kk], desc_mn_major(vst + kk * 16 * 128, PANEL),
                        1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        const int r = rw + 8 * h;
        if (r >= w.R) continue;
        if (a.acc == nullptr) {  // one split: the output
            const float inv = 1.f / fmaxf(l[h], 1e-30f);
            __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.out) +
                                  row_at(a, b, kh, w.r0 + r);
#pragma unroll
            for (int i = 0; i < 8 * P; ++i)
                *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i + c2) =
                    __floats2bfloat162_rn(o[4 * i + 2 * h] * inv,
                                          o[4 * i + 2 * h + 1] * inv);
        } else {  // this split's partial
            const size_t at = part_at(a, b, kh, split, w.r0 + r);
            float* arow = a.acc + at * a.D;
#pragma unroll
            for (int i = 0; i < 8 * P; ++i)
                *reinterpret_cast<float2*>(arow + 8 * i + c2) =
                    make_float2(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
            if (lane % 4 == 0) {
                a.ml[2 * at] = m[h];
                a.ml[2 * at + 1] = l[h];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The FMA walk: rows r0 .. r0 + R - 1 of a tile, float32 in shared memory
template <typename T>
__global__ void __launch_bounds__(FMA_THREADS)
paged_fma_kernel(const T* __restrict__ k_pool, const T* __restrict__ v_pool,
                 const Args a) {
    extern __shared__ float fma_smem_f[];
    const int tile = blockIdx.x % a.tiles, split = blockIdx.x / a.tiles;
    const int kh = blockIdx.y, b = blockIdx.z;
    const Walk w = walk_of(a, tile, split, b);
    const int R = w.R, D = a.D;
    const int DP = D + 1;
    const int DV = D / 8;          // 8-element vectors per row
    float* Qs = fma_smem_f;        // R x D (scaled by scale * log2 e)
    float* Ks = Qs + R * D;        // CT x DP
    float* Vs = Ks + CT * DP;      // CT x D
    float* Ss = Vs + CT * D;       // R x CT scores, then probabilities
    float* Acc = Ss + R * CT;      // R x D
    float* Ms = Acc + R * D;       // R running max
    float* Ls = Ms + R;            // R running denominator
    float* As = Ls + R;            // R rescale of this chunk

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int* table = a.table + (size_t)b * a.max_pages;
    const T* q = static_cast<const T*>(a.q);
    const float sl2 = a.scale * LOG2E;

    for (int idx = tid; idx < R * DV; idx += FMA_THREADS) {
        const int r = idx / DV, c = (idx - r * DV) * 8;
        float x[8];
        repro::load8(q + row_at(a, b, kh, w.r0 + r) + c, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            Qs[r * D + c + e] = x[e] * sl2;
            Acc[r * D + c + e] = 0.f;
        }
    }
    for (int r = tid; r < R; r += FMA_THREADS) {
        Ms[r] = NEG_INF;
        Ls[r] = 0.f;
    }

    for (int c0 = w.lo; c0 < w.hi; c0 += CT) {
        const int n = min(CT, w.hi - c0);
        __syncthreads();  // previous chunk consumed (and Qs staged)
        for (int vb = tid; vb < CT * DV; vb += U * FMA_THREADS) {
            float kx[U][8], vx[U][8];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = vb + u * FMA_THREADS;
                const int j = idx / DV;
                if (idx < CT * DV && j < n) {
                    const int p = c0 + j;
                    const int pid = max(table[p / a.page], 0);  // -1 -> 0
                    const size_t off =
                        (((size_t)kh * a.P + pid) * a.page + (p % a.page)) * D
                        + (idx - j * DV) * 8;
                    repro::load8(k_pool + off, kx[u]);
                    repro::load8(v_pool + off, vx[u]);
                } else {
                    repro::zero8(kx[u]);
                    repro::zero8(vx[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = vb + u * FMA_THREADS;
                if (idx < CT * DV) {
                    const int j = idx / DV, d = (idx - j * DV) * 8;
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        Ks[j * DP + d + e] = kx[u][e];
                        Vs[j * D + d + e] = vx[u][e];
                    }
                }
            }
        }
        __syncthreads();

        // scores: neighbouring threads take neighbouring tokens of one row
        for (int idx = tid; idx < R * CT; idx += FMA_THREADS) {
            const int r = idx / CT, j = idx - r * CT;
            const float* qrow = Qs + r * D;
            const float* krow = Ks + j * DP;
            float s = 0.f;
            for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
            const bool seen = j < n && c0 + j < w.base + (w.r0 + r) / a.G;
            Ss[idx] = seen ? s : NEG_INF;
        }
        __syncthreads();

        // online softmax: one warp per query row; masked scores weigh 0
        for (int r = warp; r < R; r += FMA_THREADS / 32) {
            const float s0 = Ss[r * CT + lane], s1 = Ss[r * CT + lane + 32];
            float mloc = fmaxf(s0, s1);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
            const float m_old = Ms[r];
            const float m_new = fmaxf(m_old, mloc);
            const float p0 = s0 == NEG_INF ? 0.f : exp2f(s0 - m_new);
            const float p1 = s1 == NEG_INF ? 0.f : exp2f(s1 - m_new);
            Ss[r * CT + lane] = p0;
            Ss[r * CT + lane + 32] = p1;
            float lsum = p0 + p1;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
            __syncwarp();
            if (lane == 0) {
                const float alpha = exp2f(m_old - m_new);
                As[r] = alpha;
                Ls[r] = Ls[r] * alpha + lsum;
                Ms[r] = m_new;
            }
        }
        __syncthreads();

        // accumulate: each (row, column) of Acc is owned by one thread
        for (int idx = tid; idx < R * D; idx += FMA_THREADS) {
            const int r = idx / D, d = idx - r * D;
            const float* prow = Ss + r * CT;
            float sum = 0.f;
            for (int j = 0; j < n; ++j) sum += prow[j] * Vs[j * D + d];
            Acc[idx] = Acc[idx] * As[r] + sum;
        }
    }
    __syncthreads();

    // the output (one split), or this split's partial (an empty one when
    // the block walked nothing)
    for (int idx = tid; idx < R * D; idx += FMA_THREADS) {
        const int r = idx / D, d = idx - r * D;
        if (a.acc == nullptr) {
            repro::store(static_cast<T*>(a.out) + row_at(a, b, kh, w.r0 + r)
                             + d,
                         Acc[idx] / fmaxf(Ls[r], 1e-30f));
        } else {
            const size_t at = part_at(a, b, kh, split, w.r0 + r);
            a.acc[at * D + d] = Acc[idx];
            if (d == 0) {
                a.ml[2 * at] = Ms[r];
                a.ml[2 * at + 1] = Ls[r];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The merge: one warp a (slot, KV head, row).  Split s weighs
// w_s = 2^(m_s - max m); the lanes take the splits 32 apart for the max
// and the denominator (then a fixed shuffle tree), and the accumulator
// adds w_s acc_s in split order, each lane its columns.  The order of
// every sum is fixed, so the result is the same bits at every launch.  The
// rows of MERGE_DEPTH splits are loaded before any is added: a shuffle
// orders the memory accesses around it, so loads issued between the
// shuffles would each wait out a whole memory latency.
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_DEPTH = 8;

template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
paged_merge_kernel(const Args a, int B) {
    const int rows = a.T * a.G;
    const long wid =
        ((long)blockIdx.x * MERGE_THREADS + threadIdx.x) / 32;
    if (wid >= (long)B * a.KH * rows) return;
    const int lane = threadIdx.x & 31;
    const int r = (int)(wid % rows);
    const int kh = (int)((wid / rows) % a.KH), b = (int)(wid / rows / a.KH);
    float M = NEG_INF;
    for (int s = lane; s < a.splits; s += 32)
        M = fmaxf(M, a.ml[2 * part_at(a, b, kh, s, r)]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float L = 0.f, acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int s0 = 0; s0 < a.splits; s0 += 32) {
        // lane k holds the weight of split s0 + k (0 past the last)
        const int n = min(32, a.splits - s0);
        float wl = 0.f;
        if (lane < n) {
            const size_t at = part_at(a, b, kh, s0 + lane, r);
            wl = exp2f(a.ml[2 * at] - M);
            L += a.ml[2 * at + 1] * wl;
        }
        for (int k0 = 0; k0 < n; k0 += MERGE_DEPTH) {
            float v[MERGE_DEPTH][8];
#pragma unroll
            for (int u = 0; u < MERGE_DEPTH; ++u) {
                const int s = s0 + min(k0 + u, n - 1);
                const float* arow = a.acc + part_at(a, b, kh, s, r) * a.D;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int d = lane + 32 * i;
                    v[u][i] = k0 + u < n && d < a.D ? arow[d] : 0.f;
                }
            }
#pragma unroll
            for (int u = 0; u < MERGE_DEPTH; ++u) {
                const float wgt =
                    __shfl_sync(0xffffffffu, wl, (k0 + u) & 31);
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[i] += v[u][i] * wgt;
            }
        }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        L += __shfl_xor_sync(0xffffffffu, L, o);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    T* orow = static_cast<T*>(a.out) + row_at(a, b, kh, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int d = lane + 32 * i;
        if (d < a.D) repro::store(orow + d, acc[i] * inv);
    }
}

// ---------------------------------------------------------------------------
// host: the pools' tensor maps, encoded once and kept.  A map depends only
// on the pool's address and shape, so a kept map is never stale; the last
// 64 pools are kept (two a layer: qwen2-1.5b's 28 layers take 56).
struct PoolMap {
    const void* base;
    int KH, P, page, D;
    CUtensorMap map;
};

inline cudaError_t pool_map(const void* base, int KH, int P, int page, int D,
                            CUtensorMap* out) {
    constexpr int KEPT = 64;
    static std::mutex mu;
    static PoolMap kept[KEPT];
    static int used = 0, next = 0;
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
        const PoolMap& e = kept[i];
        if (e.base == base && e.KH == KH && e.P == P && e.page == page &&
            e.D == D) {
            *out = e.map;
            return cudaSuccess;
        }
    }
    CUtensorMap map;
    const cudaError_t err = repro::hopper::make_map_bf16_rows(
        &map, base, KH, P, page, D, page < CT ? page : CT);
    if (err != cudaSuccess) return err;
    PoolMap& e = kept[used < KEPT ? used++ : next++ % KEPT];
    e = PoolMap{base, KH, P, page, D, map};
    *out = map;
    return cudaSuccess;
}

template <int P>
cudaError_t launch_tc(const Args& a, const void* k_pool, const void* v_pool,
                      int B, cudaStream_t stream) {
    CUtensorMap tk, tv;
    cudaError_t err = pool_map(k_pool, a.KH, a.P, a.page, a.D, &tk);
    if (err == cudaSuccess)
        err = pool_map(v_pool, a.KH, a.P, a.page, a.D, &tv);
    if (err != cudaSuccess) return err;
    err = repro::allow_smem<paged_tc_kernel<P>>(Tc<P>::SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(a.splits * a.tiles, a.KH, B);
    paged_tc_kernel<P><<<grid, TC_THREADS, Tc<P>::SMEM, stream>>>(tk, tv, a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const Args& a, const void* k_pool, const void* v_pool,
                       int B, cudaStream_t stream) {
    const cudaError_t err =
        repro::allow_smem<paged_fma_kernel<T>>((int)MAX_SMEM);
    if (err != cudaSuccess) return err;
    dim3 grid(a.splits * a.tiles, a.KH, B);
    paged_fma_kernel<T><<<grid, FMA_THREADS, fma_smem(a.tile, a.D), stream>>>(
        static_cast<const T*>(k_pool), static_cast<const T*>(v_pool), a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_merge(const Args& a, int B, cudaStream_t stream) {
    const long threads = (long)B * a.KH * a.T * a.G * 32;
    const int blocks = (int)((threads + MERGE_THREADS - 1) / MERGE_THREADS);
    paged_merge_kernel<T><<<blocks, MERGE_THREADS, 0, stream>>>(a, B);
    return cudaGetLastError();
}

// The launch of K2 (T = 1, base = kv_len) or K3 (base = base_len):
// `splits` from the caller's plan, `partials` a float32 scratch of
// B * KH * splits * T * G * (D + 2) values when splits > 1 (else unread).
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
inline cudaError_t launch(const void* q, const void* k_pool,
                          const void* v_pool, const void* page_table,
                          const void* base, void* out, int B, int T, int KH,
                          int G, int D, int P, int page, int max_pages,
                          float scale, int dtype, int splits, void* partials,
                          cudaStream_t stream) {
    if (B < 1 || T < 1 || KH < 1 || G < 1 || D < 8 || D > 256 ||
        D % 8 != 0 || P < 1 || page < 1 || max_pages < 1 || B > 65535 ||
        KH > 65535 || (dtype != 0 && dtype != 1))
        return cudaErrorInvalidValue;
    const int pps = split_pages(max_pages, page, splits);
    if (pps == 0 || (splits > 1 && partials == nullptr))
        return cudaErrorInvalidValue;
    const int rows = T * G;
    Args a;
    a.q = q;
    a.table = static_cast<const int*>(page_table);
    a.base = static_cast<const int*>(base);
    a.out = out;
    a.acc = splits > 1 ? static_cast<float*>(partials) : nullptr;
    a.ml = splits > 1 ? a.acc + (size_t)B * KH * splits * rows * D : nullptr;
    a.T = T;
    a.KH = KH;
    a.G = G;
    a.D = D;
    a.P = P;
    a.page = page;
    a.max_pages = max_pages;
    a.tile = tile_rows(rows, D, page, dtype);
    a.tiles = (rows + a.tile - 1) / a.tile;
    a.splits = splits;
    a.pps = pps;
    a.scale = scale;
    if ((long)splits * a.tiles > 2147483647L) return cudaErrorInvalidValue;
    cudaError_t err;
    if (tensor_cores(D, page, dtype))
        err = D == 64 ? launch_tc<1>(a, k_pool, v_pool, B, stream)
                      : launch_tc<2>(a, k_pool, v_pool, B, stream);
    else if (dtype == 0)
        err = launch_fma<float>(a, k_pool, v_pool, B, stream);
    else
        err = launch_fma<__nv_bfloat16>(a, k_pool, v_pool, B, stream);
    if (err != cudaSuccess || splits == 1) return err;
    return dtype == 0 ? launch_merge<float>(a, B, stream)
                      : launch_merge<__nv_bfloat16>(a, B, stream);
}

}  // namespace
}  // namespace paged
}  // namespace repro
