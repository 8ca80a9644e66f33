// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `paged_attention_bkgd` / `_paged_kernel` of
// src/repro/kernels/paged_attention.py: one decode token per slot attends
// that slot's KV through a page table.  Token t of slot b lives at
// pool[kh, table[b, t / page], t % page, :]; unmapped entries (-1) clamp to
// the null page 0; positions at or past kv_len[b] are masked (the tail of
// the last page included) and pages past it are never read.  Scores,
// softmax and the accumulator are float32; the denominator is clamped at
// 1e-30 as on the TPU.  kv_len[b] must be >= 1 (the engine decodes at
// pos + 1 >= 1); a slot with kv_len 0 gets zeros, as the TPU kernel gives.
//
// What bounds it on the H100: decode attention does 4 * G * D flops per
// KV token against 4 * D bytes (bf16 K and V) per token, one flop per byte
// at G = 6 — far below the ~295 flops per byte where the card turns
// compute bound, so the bound is the bytes of the live pages.  What the
// design does:
//   * one block per (slot, KV head) covers all G query rows of that head,
//     so each K/V page is read from device memory once for the G rows;
//   * the block reads its own row of the page table (Hopper has no scalar
//     prefetch) and walks only positions below kv_len[b], in chunks of 64
//     tokens staged in shared memory as float32, each token's row gathered
//     through the table with 16-byte loads, four per tensor in flight per
//     thread (any page size works);
//   * the online-softmax state (max, denominator) of each query row lives
//     in shared memory, the accumulator G x D in shared memory, each of its
//     columns owned by one thread, so no atomics are needed.
// This first version runs B * KH blocks with no split over the sequence, so
// at small batch it fills few SMs; splitting the KV walk across blocks is
// later work.  All inputs are contiguous and 16-byte aligned, D a multiple
// of 8.  The kernel launches on the caller's stream, allocates nothing and
// does not synchronise.
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int CT = 64;        // kv tokens per chunk
constexpr int THREADS = 128;
constexpr int U = 4;          // 16-byte loads per tensor in flight per thread
constexpr int MAX_G = 32;     // query rows per KV head the block can hold

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q,            // (B, KH, G, D)
                    const T* __restrict__ k_pool,       // (KH, P, page, D)
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_table, // (B, max_pages)
                    const int* __restrict__ kv_len,     // (B,)
                    T* __restrict__ out,                // (B, KH, G, D)
                    int KH, int G, int D, int P, int page, int max_pages,
                    float scale) {
    extern __shared__ float smem[];
    const int DP = D + 1;
    const int DV = D / 8;          // 8-element vectors per row
    float* Qs = smem;              // G x D (pre-scaled)
    float* Ks = Qs + G * D;        // CT x DP
    float* Vs = Ks + CT * DP;      // CT x D
    float* Ss = Vs + CT * D;       // G x CT scores, then probabilities
    float* Acc = Ss + G * CT;      // G x D
    float* Ms = Acc + G * D;       // G running max
    float* Ls = Ms + G;            // G running denominator
    float* As = Ls + G;            // G rescale of this chunk

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int kh = blockIdx.x, b = blockIdx.y;
    const int len = min(kv_len[b], max_pages * page);
    const int* table = page_table + (size_t)b * max_pages;
    const size_t q_base = ((size_t)b * KH + kh) * G * D;

    for (int idx = tid; idx < G * D / 8; idx += THREADS) {
        float x[8];
        repro::load8(q + q_base + idx * 8, x);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            Qs[idx * 8 + e] = x[e] * scale;
            Acc[idx * 8 + e] = 0.f;
        }
    }
    for (int g = tid; g < G; g += THREADS) {
        Ms[g] = NEG_INF;
        Ls[g] = 0.f;
    }

    for (int c0 = 0; c0 < len; c0 += CT) {
        const int n = min(CT, len - c0);
        __syncthreads();  // previous chunk consumed (and Qs staged)
        for (int base = tid; base < CT * DV; base += U * THREADS) {
            float kx[U][8], vx[U][8];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = base + u * THREADS;
                const int j = idx / DV;
                if (idx < CT * DV && j < n) {
                    const int t = c0 + j;
                    const int pid = max(table[t / page], 0);  // -1 -> null page 0
                    const size_t off = (((size_t)kh * P + pid) * page + (t % page))
                                       * D + (idx - j * DV) * 8;
                    repro::load8(k_pool + off, kx[u]);
                    repro::load8(v_pool + off, vx[u]);
                } else {
                    repro::zero8(kx[u]);
                    repro::zero8(vx[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = base + u * THREADS;
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

        // scores: thread owns token j of the chunk for rows g = half, half+2, ...
        {
            const int j = tid % CT;
            const float* krow = Ks + j * DP;
            for (int g = tid / CT; g < G; g += THREADS / CT) {
                const float* qrow = Qs + g * D;
                float s = 0.f;
                for (int d = 0; d < D; ++d) s += qrow[d] * krow[d];
                Ss[g * CT + j] = (j < n) ? s : NEG_INF;
            }
        }
        __syncthreads();

        // online softmax: one warp per query row
        for (int g = warp; g < G; g += THREADS / 32) {
            float s0 = Ss[g * CT + lane], s1 = Ss[g * CT + lane + 32];
            float mloc = fmaxf(s0, s1);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, o));
            const float m_old = Ms[g];
            const float m_new = fmaxf(m_old, mloc);
            const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
            Ss[g * CT + lane] = p0;
            Ss[g * CT + lane + 32] = p1;
            float lsum = p0 + p1;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
            __syncwarp();
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                As[g] = alpha;
                Ls[g] = Ls[g] * alpha + lsum;
                Ms[g] = m_new;
            }
        }
        __syncthreads();

        // accumulate: thread owns output columns d = tid, tid + 128, ...
        for (int d = tid; d < D; d += THREADS) {
            for (int g = 0; g < G; ++g) {
                const float* prow = Ss + g * CT;
                float sum = 0.f;
                for (int j = 0; j < n; ++j) sum += prow[j] * Vs[j * D + d];
                Acc[g * D + d] = Acc[g * D + d] * As[g] + sum;
            }
        }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += THREADS) {
        int g = idx / D;
        repro::store(out + q_base + idx, Acc[idx] / fmaxf(Ls[g], 1e-30f));
    }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_table, const int* kv_len, void* out,
                   int B, int KH, int G, int D, int P, int page, int max_pages,
                   float scale, cudaStream_t stream) {
    auto smem_for = [](int g, int d) {
        return sizeof(float) *
            (size_t)(g * d + CT * (d + 1) + CT * d + g * CT + g * d + 3 * g);
    };
    auto kernel = paged_decode_kernel<T>;
    // allow the largest G and D once (not per launch, so that launches can
    // be captured in a CUDA graph)
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_for(MAX_G, 256));
    if (attr != cudaSuccess) return attr;
    const size_t smem = smem_for(G, D);
    dim3 grid(KH, B);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), page_table, kv_len,
        static_cast<T*>(out), KH, G, D, P, page, max_pages, scale);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success).
extern "C" int repro_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool,
                                     const void* page_table,
                                     const void* kv_len, void* out, int B,
                                     int KH, int G, int D, int P, int page,
                                     int max_pages, float scale, int dtype,
                                     void* stream) {
    if (B < 1 || KH < 1 || G < 1 || G > MAX_G || D < 8 || D > 256 ||
        D % 8 != 0 || P < 1 || page < 1 || max_pages < 1 ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* pt = static_cast<const int*>(page_table);
    const int* kl = static_cast<const int*>(kv_len);
    if (dtype == 0)
        return (int)launch<float>(q, k_pool, v_pool, pt, kl, out, B, KH, G, D,
                                  P, page, max_pages, scale, st);
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, pt, kl, out, B, KH,
                                      G, D, P, page, max_pages, scale, st);
}
