// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py: online-softmax attention with GQA
// (query head h reads KV head h / (H / KH)), causal and sliding-window
// masks, an absolute query offset, and a ragged S / T (no padding by the
// caller).  Scores, softmax and the accumulator are float32 whatever the
// element type; the denominator is clamped at 1e-30 as on the TPU.
//
// What bounds it on the H100: at prefill lengths the work is
// 4 * S * T * D flops per (b, h) against (S + 2 T) * D elements read, so a
// tensor-core kernel would be compute bound.  This first version uses no
// tensor cores (no wgmma, no TMA): its arithmetic is float32 FMAs out of
// shared memory, so it is bound by shared-memory bandwidth and the
// float32 issue rate, far above the card's bound.  What the design does:
//   * one block per (q tile of 32 rows, head, batch); the TPU's
//     sequential kv grid axis becomes a loop inside the block;
//   * each KV tile of 64 rows is staged once in shared memory (converted
//     to float32) and reused by all 32 query rows of the block; it is read
//     with 16-byte loads, four per tensor in flight per thread;
//   * KV tiles that the causal or window mask rules out entirely are
//     never loaded (the loop bounds skip them), as `pl.when` skips them
//     on the TPU;
//   * a thread owns one query row's 16 scores of a tile and a quarter of
//     its output columns, so the running max and denominator of a row
//     live in the registers of four neighbouring lanes and reduce with
//     two shuffles;
//   * shared-memory rows of Q and K are padded to D + 1 floats so the
//     four threads of a row and the eight rows of a warp hit distinct
//     banks.
// Inputs and output keep the reference layout: q, out (B, S, H, D),
// k, v (B, T, KH, D), all contiguous and 16-byte aligned, D a multiple of
// 8.  For training, an optional float32 lse (B, S, H) receives each row's
// log-sum-exp m + log(max(l, 1e-30)) of the scaled, masked scores, which
// the backward kernels (flash_attention_bwd.cu) recompute P from; serving
// passes none and its work is unchanged.  The kernel launches on the
// caller's stream, allocates nothing and does not synchronise.
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 128;  // 4 threads per query row
constexpr int COLS = BK / 4;  // scores per thread per tile
constexpr int U = 4;          // 16-byte loads per tensor in flight per thread

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int Tlen, int H, int KH,
                 int D, float scale, int causal, int window, int q_offset) {
    extern __shared__ float smem[];
    const int DP = D + 1;
    const int DV = D / 8;           // 8-element vectors per row
    float* Qs = smem;               // BQ x DP
    float* Ks = Qs + BQ * DP;       // BK x DP
    float* Vs = Ks + BK * DP;       // BK x D (16-byte aligned)
    float* Ps = Vs + BK * D;        // BQ x (BK + 1)

    const int tid = threadIdx.x;
    const int r = tid >> 2;         // query row of this thread in the tile
    const int sub = tid & 3;        // quarter: columns sub + 4c, dims sub + 4i
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / KH);

    // stage the query tile, pre-scaled as the reference does (q * scale)
    for (int idx = tid; idx < BQ * DV; idx += THREADS) {
        const int rr = idx / DV, d = (idx - rr * DV) * 8;
        const int s = q0 + rr;
        float x[8];
        if (s < S) repro::load8(q + ((size_t)(b * S + s) * H + h) * D + d, x);
        else repro::zero8(x);
#pragma unroll
        for (int e = 0; e < 8; ++e) Qs[rr * DP + d + e] = x[e] * scale;
    }

    // kv range this block can see: [lo, hi)
    const int qpos_first = q_offset + q0;
    const int qpos_last = q_offset + min(q0 + BQ, S) - 1;
    int hi = Tlen;
    if (causal) hi = min(hi, qpos_last + 1);
    int lo = 0;
    if (window > 0) lo = max(0, qpos_first - window + 1);
    lo = (lo / BK) * BK;

    const int qpos = qpos_first + r;
    float m = NEG_INF, l = 0.f;
    float acc[DMAX / 4];
#pragma unroll
    for (int i = 0; i < DMAX / 4; ++i) acc[i] = 0.f;

    for (int k0 = lo; k0 < hi; k0 += BK) {
        __syncthreads();  // previous tile fully consumed (and Qs staged)
        for (int base = tid; base < BK * DV; base += U * THREADS) {
            float kx[U][8], vx[U][8];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = base + u * THREADS;
                const int j = idx / DV, t = k0 + j;
                if (idx < BK * DV && t < Tlen) {
                    const size_t off = ((size_t)(b * Tlen + t) * KH + kh) * D
                                       + (idx - j * DV) * 8;
                    repro::load8(k + off, kx[u]);
                    repro::load8(v + off, vx[u]);
                } else {
                    repro::zero8(kx[u]);
                    repro::zero8(vx[u]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const int idx = base + u * THREADS;
                if (idx < BK * DV) {
                    const int j = idx / DV, d = (idx - j * DV) * 8;
#pragma unroll
                    for (int e = 0; e < 8; ++e) Ks[j * DP + d + e] = kx[u][e];
                    float4* vs = reinterpret_cast<float4*>(Vs + j * D + d);
                    vs[0] = make_float4(vx[u][0], vx[u][1], vx[u][2], vx[u][3]);
                    vs[1] = make_float4(vx[u][4], vx[u][5], vx[u][6], vx[u][7]);
                }
            }
        }
        __syncthreads();

        float s[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) s[c] = 0.f;
        const float* qrow = Qs + r * DP;
        for (int d = 0; d < D; ++d) {
            const float qv = qrow[d];
#pragma unroll
            for (int c = 0; c < COLS; ++c) s[c] += qv * Ks[(sub + 4 * c) * DP + d];
        }

        float mloc = NEG_INF;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            const int kpos = k0 + sub + 4 * c;
            bool live = kpos < Tlen;
            if (causal) live = live && (qpos >= kpos);
            if (window > 0) live = live && (qpos - kpos < window);
            s[c] = live ? s[c] : NEG_INF;
            mloc = fmaxf(mloc, s[c]);
        }
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
        mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
        const float m_new = fmaxf(m, mloc);
        const float alpha = expf(m - m_new);
        float lsum = 0.f;
        float* prow = Ps + r * (BK + 1);
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            const float p = expf(s[c] - m_new);
            lsum += p;
            prow[sub + 4 * c] = p;
        }
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
        l = l * alpha + lsum;
        m = m_new;
        __syncwarp();  // the row's probabilities come from its own quad

#pragma unroll
        for (int i = 0; i < DMAX / 4; ++i) acc[i] *= alpha;
        for (int j = 0; j < BK; ++j) {
            const float p = prow[j];
            const float* vrow = Vs + j * D + sub;
#pragma unroll
            for (int i = 0; i < DMAX / 4; ++i)
                if (sub + 4 * i < D) acc[i] += p * vrow[4 * i];
        }
    }

    const int srow = q0 + r;
    if (srow < S) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        T* orow = out + ((size_t)(b * S + srow) * H + h) * D;
#pragma unroll
        for (int i = 0; i < DMAX / 4; ++i) {
            const int d = sub + 4 * i;
            if (d < D) repro::store(orow + d, acc[i] * inv);
        }
        if (lse != nullptr && sub == 0)
            lse[(size_t)(b * S + srow) * H + h] = m + logf(fmaxf(l, 1e-30f));
    }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int Tlen, int H, int KH, int D,
                   float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
    auto smem_for = [](int d) {
        return sizeof(float) *
            (size_t)(BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1));
    };
    auto kernel = flash_fwd_kernel<T, DMAX>;
    // allow the largest D of this instance once (not per launch, so that
    // launches can be captured in a CUDA graph)
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_for(DMAX));
    if (attr != cudaSuccess) return attr;
    const size_t smem = smem_for(D);
    dim3 grid((S + BQ - 1) / BQ, H, B);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), lse,
        S, Tlen, H, KH, D, scale, causal, window, q_offset);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       float* lse, int B, int S, int Tlen, int H, int KH,
                       int D, float scale, int causal, int window,
                       int q_offset, cudaStream_t stream) {
    if (D <= 64)
        return launch<T, 64>(q, k, v, out, lse, B, S, Tlen, H, KH, D, scale,
                             causal, window, q_offset, stream);
    if (D <= 128)
        return launch<T, 128>(q, k, v, out, lse, B, S, Tlen, H, KH, D, scale,
                              causal, window, q_offset, stream);
    return launch<T, 256>(q, k, v, out, lse, B, S, Tlen, H, KH, D, scale,
                          causal, window, q_offset, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse may be null.  Returns a
// cudaError_t (0 = success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, float* lse,
                                     int B, int S, int Tlen, int H, int KH,
                                     int D, float scale, int causal, int window,
                                     int q_offset, int dtype, void* stream) {
    if (B < 1 || S < 1 || Tlen < 1 || KH < 1 || H % KH != 0 || D < 8 ||
        D > 256 || D % 8 != 0 || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)dispatch_d<float>(q, k, v, out, lse, B, S, Tlen, H, KH,
                                      D, scale, causal, window, q_offset, st);
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, lse, B, S, Tlen, H,
                                          KH, D, scale, causal, window,
                                          q_offset, st);
}
