// Paged multi-query verify attention for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernel `paged_attention_mq_bkgd` / `_paged_mq_kernel` of
// src/repro/kernels/paged_attention.py: speculative verify scores the T = k+1
// draft positions of every slot in one pass over that slot's K/V, read
// through the page table.  Query row (t, h) of slot b, with h = kh * G + g,
// sees the kv positions < base_len[b] + t (a causal limit per row).  Token p
// of slot b lives at pool[kh, table[b, p / page], p % page, :]; unmapped
// entries (-1) clamp to the null page 0.  Scores, softmax and the accumulator
// are float32; masked scores are -1e30 and weigh exactly 0; the denominator
// is clamped at 1e-30, so a row that sees nothing gets zeros, as the TPU
// kernel gives for a slot with nothing to read.
//
// What bounds it on the H100: the block reads each live K/V token once for
// all R = T * G query rows of its KV head: 4 * R * D flops against 4 * D
// bytes (bf16 K and V) per token, R = 30 flops per byte for qwen2-1.5b at
// spec_k = 4 — still far below the ~295 flops per byte where the card turns
// compute bound, so the bound is the bytes of the visible pages.  What the
// design does:
//   * one block per (slot, KV head), as in K2 (paged_attention.cu), holds all
//     R rows when they fit (see below): the q rows (t, kh, g) are read
//     straight from the (B, T, H, D) layout (row r = t * G + g, the TPU
//     kernel's packing, with no transpose in the wrapper), and each K/V page
//     is read from device memory once per row tile;
//   * the block reads its own row of the page table and walks only positions
//     below min(base_len + t_last, max_pages * page) — what the furthest row
//     of its tile sees — in chunks of 64 tokens staged in shared memory as
//     float32 with 16-byte loads, four per tensor in flight per thread; pages
//     past that (dead pages, parked slots) are never read;
//   * the per-row limit is applied inside the chunk; each score and each
//     accumulator element is owned by one thread (no atomics), and the online
//     softmax runs one warp per row.
// Shared memory grows with R * D, so the rows a block can hold depend on D
// (128 at D = 128, 43 at D = 256).  The R rows of a (slot, KV head) are
// therefore tiled over blocks: the grid is (row tiles, KH, B), and each block
// holds a tile of at most the rows that fit in the 227 KB a block may use,
// the tiles balanced (144 rows at D = 128 run as two tiles of 72).  A block
// walks kv positions only up to what the last row of its tile sees,
// min(base_len + t_last, max_pages * page), so each tile re-reads the pages
// its rows share; when all R rows fit, the one tile is the whole row set and
// the launch is the untiled kernel, bit for bit (each row's online softmax
// depends on no other row).  Like K2 this first version runs no split over
// the sequence and uses no tensor cores.  All inputs are contiguous and
// 16-byte aligned, D a multiple of 8.  The kernel launches on the caller's
// stream, allocates nothing and does not synchronise.
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int CT = 64;        // kv tokens per chunk
constexpr int THREADS = 256;
constexpr int U = 4;          // 16-byte loads per tensor in flight per thread
constexpr size_t MAX_SMEM = 232448;  // what a block may use on sm_90

size_t smem_for(int rows, int d) {
    return sizeof(float) *
        (size_t)(2 * rows * d + rows * CT + 3 * rows + CT * (2 * d + 1));
}

// rows of one tile: the fewest tiles whose largest layout fits, balanced
// (0 when rows < 1 or not even one row fits)
int tile_rows(int rows, int d) {
    const long fixed = (long)CT * (2 * d + 1);
    const long per_row = 2L * d + CT + 3;
    const long words = (long)(MAX_SMEM / sizeof(float));
    const int fit = (int)((words - fixed) / per_row);
    if (rows < 1 || fit < 1) return 0;
    const int tiles = (rows + fit - 1) / fit;
    return (rows + tiles - 1) / tiles;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_verify_kernel(const T* __restrict__ q,            // (B, Tq, H, D)
                    const T* __restrict__ k_pool,       // (KH, P, page, D)
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table, // (B, max_pages)
                    const int* __restrict__ base_len,   // (B,)
                    T* __restrict__ out,                // (B, Tq, H, D)
                    int Tq, int KH, int G, int D, int P, int page,
                    int max_pages, int tile, float scale) {
    extern __shared__ float smem[];
    // this block's rows: r0 .. r0 + R - 1 of the Tq * G rows
    const int r0 = blockIdx.x * tile;
    const int R = min(tile, Tq * G - r0);
    const int H = KH * G;
    const int DP = D + 1;
    const int DV = D / 8;          // 8-element vectors per row
    float* Qs = smem;              // R x D (pre-scaled)
    float* Ks = Qs + R * D;        // CT x DP
    float* Vs = Ks + CT * DP;      // CT x D
    float* Ss = Vs + CT * D;       // R x CT scores, then probabilities
    float* Acc = Ss + R * CT;      // R x D
    float* Ms = Acc + R * D;       // R running max
    float* Ls = Ms + R;            // R running denominator
    float* As = Ls + R;            // R rescale of this chunk

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int kh = blockIdx.y, b = blockIdx.z;
    const int base = base_len[b];
    // the tile's furthest row sees base + t_last positions; clamp to the
    // table
    const int t_last = (r0 + R - 1) / G;
    const int len = max(0, min(base + t_last, max_pages * page));
    const int* table = page_table + (size_t)b * max_pages;
    // element d of local row r (row r0 + r = t * G + g) sits at
    // q[b, t, kh * G + g, d]
    auto q_at = [&](int r) -> size_t {
        const int t = (r0 + r) / G, g = r0 + r - t * G;
        return (((size_t)b * Tq + t) * H + kh * G + g) * D;
    };

    for (int idx = tid; idx < R * DV; idx += THREADS) {
        const int r = idx / DV, c = (idx - r * DV) * 8;
        float x[8];
        repro::load8(q + q_at(r) + c, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            Qs[r * D + c + e] = x[e] * scale;
            Acc[r * D + c + e] = 0.f;
        }
    }
    for (int r = tid; r < R; r += THREADS) {
        Ms[r] = NEG_INF;
        Ls[r] = 0.f;
    }

    for (int c0 = 0; c0 < len; c0 += CT) {
        const int n = min(CT, len - c0);
        __syncthreads();  // previous chunk consumed (and Qs staged)
        for (int vb = tid; vb < CT * DV; vb += U * THREADS) {
            float kx[U][8], vx[U][8];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = vb + u * THREADS;
                const int j = idx / DV;
                if (idx < CT * DV && j < n) {
                    const int p = c0 + j;
                    const int pid = max(table[p / page], 0);  // -1 -> page 0
                    const size_t off = (((size_t)kh * P + pid) * page
                                        + (p % page)) * D + (idx - j * DV) * 8;
                    repro::load8(k_pool + off, kx[u]);
                    repro::load8(v_pool + off, vx[u]);
                } else {
                    repro::zero8(kx[u]);
                    repro::zero8(vx[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = vb + u * THREADS;
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
        for (int idx = tid; idx < R * CT; idx += THREADS) {
            const int r = idx / CT, j = idx - r * CT;
            const float* qrow = Qs + r * D;
            const float* krow = Ks + j * DP;
            float s = 0.f;
            for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
            const bool seen = j < n && c0 + j < base + (r0 + r) / G;
            Ss[idx] = seen ? s : NEG_INF;
        }
        __syncthreads();

        // online softmax: one warp per query row; masked scores weigh 0
        for (int r = warp; r < R; r += THREADS / 32) {
            const float s0 = Ss[r * CT + lane], s1 = Ss[r * CT + lane + 32];
            float mloc = fmaxf(s0, s1);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
            const float m_old = Ms[r];
            const float m_new = fmaxf(m_old, mloc);
            const float p0 = s0 == NEG_INF ? 0.f : expf(s0 - m_new);
            const float p1 = s1 == NEG_INF ? 0.f : expf(s1 - m_new);
            Ss[r * CT + lane] = p0;
            Ss[r * CT + lane + 32] = p1;
            float lsum = p0 + p1;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
            __syncwarp();
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                As[r] = alpha;
                Ls[r] = Ls[r] * alpha + lsum;
                Ms[r] = m_new;
            }
        }
        __syncthreads();

        // accumulate: each (row, column) of Acc is owned by one thread
        for (int idx = tid; idx < R * D; idx += THREADS) {
            const int r = idx / D, d = idx - r * D;
            const float* prow = Ss + r * CT;
            float sum = 0.f;
            for (int j = 0; j < n; ++j) sum += prow[j] * Vs[j * D + d];
            Acc[idx] = Acc[idx] * As[r] + sum;
        }
    }
    __syncthreads();

    for (int idx = tid; idx < R * D; idx += THREADS) {
        const int r = idx / D, d = idx - r * D;
        repro::store(out + q_at(r) + d, Acc[idx] / fmaxf(Ls[r], 1e-30f));
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_table, const int* base_len, void* out,
                   int B, int Tq, int KH, int G, int D, int P, int page,
                   int max_pages, float scale, cudaStream_t stream) {
    auto kernel = paged_verify_kernel<T>;
    // allow the largest layout
    const cudaError_t attr =
        repro::allow_smem<paged_verify_kernel<T>>((int)MAX_SMEM);
    if (attr != cudaSuccess) return attr;
    const int tile = tile_rows(Tq * G, D);
    dim3 grid((Tq * G + tile - 1) / tile, KH, B);
    kernel<<<grid, THREADS, smem_for(tile, D), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), page_table, base_len,
        static_cast<T*>(out), Tq, KH, G, D, P, page, max_pages, tile, scale);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int repro_paged_attention_mq(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* page_table,
                                        const void* base_len, void* out,
                                        int B, int Tq, int KH, int G, int D,
                                        int P, int page, int max_pages,
                                        float scale, int dtype, void* stream) {
    if (B < 1 || Tq < 1 || KH < 1 || G < 1 || D < 8 || D > 256 ||
        D % 8 != 0 || P < 1 || page < 1 || max_pages < 1 ||
        B > 65535 || KH > 65535 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* pt = static_cast<const int*>(page_table);
    const int* bl = static_cast<const int*>(base_len);
    if (dtype == 0)
        return (int)launch<float>(q, k_pool, v_pool, pt, bl, out, B, Tq, KH, G,
                                  D, P, page, max_pages, scale, st);
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, pt, bl, out, B, Tq,
                                      KH, G, D, P, page, max_pages, scale, st);
}

// rows of one row tile of the launch for rows = T * G at head dim d
extern "C" int repro_paged_attention_mq_tile_rows(int rows, int d) {
    return tile_rows(rows, d);
}
