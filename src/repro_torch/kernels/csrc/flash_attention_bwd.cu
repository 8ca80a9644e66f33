// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// The training counterpart of K1 (flash_attention.cu).  It computes what
// the reference's custom VJP computes, `_bwd_vjp` in
// src/repro/kernels/flash_xla.py (the backward the TPU path trains with;
// flash_tri.py is its triangular variant): from the saved (q, k, v, out,
// lse) and the incoming dO,
//   delta = sum_d dO * O,            P  = exp(scale * q k^T - lse),
//   dV = P^T dO,   dP = dO v^T,      dS = P * (dP - delta),
//   dQ = scale * dS k,               dK = scale * dS^T q,
// for the same masks as the forward (causal, sliding window, absolute
// query offset, ragged S / T) and GQA (query head h reads KV head
// h / (H / KH); dK and dV sum over the G query heads of each KV head).
// Inputs and outputs keep the reference layout — q, out, dO, dq
// (B, S, H, D), k, v, dk, dv (B, T, KH, D), lse and delta (B, S, H)
// float32 — contiguous and 16-byte aligned, D a multiple of 8 up to 256.
// All arithmetic is float32; dq, dk, dv are written once in the input
// type.
//
// What bounds it on the H100: the work is about 5 * S * T * D flops per
// (b, h) (halved by causality) against about 4 (S + T) H D elements
// moved, so on tensor cores it would be compute bound.  This first
// version uses no tensor cores (no wgmma, no TMA): its products are
// float32 FMAs out of shared memory, bound by the shared-memory load rate
// and the float32 issue rate, far above the card's bound.  What the
// design does:
//   * three kernels on the caller's stream: a prologue writes delta; a
//     dK/dV kernel, one block per (kv tile of 64 rows, KV head, batch),
//     loops over the G query heads of its KV head and over the q tiles
//     that can see its kv tile, recomputing P from lse, and keeps dK and
//     dV in registers until one final write; a dQ kernel, one block per
//     (q tile of 32 rows, head, batch), loops over the kv tiles its rows
//     can see.  No atomics: every sum runs in a fixed order, so the
//     result is the same bit for bit from run to run;
//   * tiles that the causal or window mask rules out entirely are never
//     visited (loop bounds), as the forward skips them;
//   * tiles live in shared memory as float32 rows padded to D + 4, so the
//     inner products read 16 bytes (four dims) per load and the eight
//     rows a quarter-warp reads fall in distinct banks;
//   * the heaviest blocks (the first kv tiles, the last q tiles under a
//     causal mask) are issued first.
#include "common.cuh"

namespace {

using repro::NEG_INF;

constexpr int BQ = 32;         // query rows per tile
constexpr int BK = 64;         // kv rows per tile
constexpr int THREADS = 256;
constexpr int CPT = BK / 8;    // score columns per thread (8 threads a row)

// bytes of dynamic shared memory of the dK/dV (n_ptiles = 2) and dQ
// (n_ptiles = 1) kernels at head dim d
__host__ __device__ constexpr size_t smem_bytes(int d, int n_ptiles) {
    return sizeof(float) * (size_t)(2 * BK * (d + 4) + 2 * BQ * (d + 4) +
                                    n_ptiles * BQ * (BK + 1) + 2 * BQ);
}

// rows [row0, row0 + rows) of a (.., D) slab with row stride `stride`
// elements into shared memory as float32 rows of DP; rows at or past
// `limit` are zero
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int rows, int limit, size_t stride,
                                      int D, int DP) {
    const int DV = D / 8;
    for (int idx = threadIdx.x; idx < rows * DV; idx += THREADS) {
        const int rr = idx / DV, d = (idx - rr * DV) * 8;
        float x[8];
        if (row0 + rr < limit) repro::load8(src + (row0 + rr) * stride + d, x);
        else repro::zero8(x);
        float4* o = reinterpret_cast<float4*>(dst + rr * DP + d);
        o[0] = make_float4(x[0], x[1], x[2], x[3]);
        o[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
    acc.x += s * x.x; acc.y += s * x.y; acc.z += s * x.z; acc.w += s * x.w;
}

__device__ __forceinline__ bool live(int qpos, int kpos, int Tlen,
                                     int causal, int window) {
    bool ok = kpos < Tlen;
    if (causal) ok = ok && qpos >= kpos;
    if (window > 0) ok = ok && qpos - kpos < window;
    return ok;
}

// S = scale * Q K^T and dP = dO V^T for one (q tile, kv tile) pair, then
// P and dS: thread (r = tid / 8, cg = tid % 8) owns row r, columns
// cg + 8 c.  Rows at or past S and masked pairs get P = dS = 0.
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* Ls, const float* Dl,
                                       int D, int DP, float scale, int s,
                                       int S, int qpos, int k0, int Tlen,
                                       int causal, int window, float* p,
                                       float* ds) {
    const int r = threadIdx.x >> 3, cg = threadIdx.x & 7;
    float sacc[CPT], pacc[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) sacc[c] = pacc[c] = 0.f;
    const float* qrow = Qs + r * DP;
    const float* orow = dOs + r * DP;
    for (int d = 0; d < D; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
        const float4 ov = *reinterpret_cast<const float4*>(orow + d);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
            const int at = (cg + 8 * c) * DP + d;
            const float4 kv = *reinterpret_cast<const float4*>(Ks + at);
            const float4 vv = *reinterpret_cast<const float4*>(Vs + at);
            sacc[c] += dot4(qv, kv);
            pacc[c] += dot4(ov, vv);
        }
    }
    const float lse = Ls[r], delta = Dl[r];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
        const bool ok = s < S && live(qpos, k0 + cg + 8 * c, Tlen, causal,
                                      window);
        const float pv = ok ? expf(sacc[c] * scale - lse) : 0.f;
        p[c] = pv;
        ds[c] = pv * (pacc[c] - delta);
    }
}

// delta[row] = sum_d dO[row, d] * O[row, d], one warp per (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(THREADS)
delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
             float* __restrict__ delta, int rows, int D) {
    const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    float acc = 0.f;
    for (int d = lane * 8; d < D; d += 32 * 8) {
        float o[8], g[8];
        repro::load8(out + (size_t)row * D + d, o);
        repro::load8(dout + (size_t)row * D + d, g);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += o[e] * g[e];
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) delta[row] = acc;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int S, int Tlen, int H,
            int KH, int D, float scale, int causal, int window,
            int q_offset) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int DP = D + 4;
    float* Ks = smem;               // BK x DP
    float* Vs = Ks + BK * DP;       // BK x DP
    float* Qs = Vs + BK * DP;       // BQ x DP
    float* dOs = Qs + BQ * DP;      // BQ x DP
    float* Ps = dOs + BQ * DP;      // BQ x (BK + 1)
    float* dSs = Ps + BQ * (BK + 1);  // BQ x (BK + 1)
    float* Ls = dSs + BQ * (BK + 1);  // BQ
    float* Dl = Ls + BQ;              // BQ

    const int tid = threadIdx.x;
    const int k0 = blockIdx.x * BK;
    const int kh = blockIdx.y;
    const int b = blockIdx.z;
    const int G = H / KH;
    const size_t kstride = (size_t)KH * D, qstride = (size_t)H * D;
    const T* kb = k + ((size_t)b * Tlen * KH + kh) * D;
    const T* vb = v + ((size_t)b * Tlen * KH + kh) * D;
    stage(Ks, kb, k0, BK, Tlen, kstride, D, DP);
    stage(Vs, vb, k0, BK, Tlen, kstride, D, DP);

    // the query rows that can see a key of this tile: [s_lo, s_hi)
    const int kmax = min(k0 + BK, Tlen) - 1;
    int s_lo = 0, s_hi = S;
    if (causal) s_lo = max(0, k0 - q_offset);
    if (window > 0) s_hi = min(S, kmax + window - q_offset);
    s_lo = (s_lo / BQ) * BQ;

    // accumulation: thread (j = tid / 4, sub = tid % 4) owns kv row j and
    // the float4 chunks sub + 4 i of its dK and dV rows
    const int j = tid >> 2, sub = tid & 3;
    constexpr int NC = DMAX / 16;
    float4 dk_acc[NC], dv_acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i)
        dk_acc[i] = dv_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

    const int r = tid >> 3, cg = tid & 7;
    for (int g = 0; g < G; ++g) {
        const int h = kh * G + g;
        const T* qb = q + ((size_t)b * S * H + h) * D;
        const T* ob = dout + ((size_t)b * S * H + h) * D;
        for (int q0 = s_lo; q0 < s_hi; q0 += BQ) {
            __syncthreads();  // the previous tile's Q, dO, P, dS consumed
            stage(Qs, qb, q0, BQ, S, qstride, D, DP);
            stage(dOs, ob, q0, BQ, S, qstride, D, DP);
            if (tid < BQ) {
                const int s = q0 + tid;
                const size_t at = ((size_t)b * S + s) * H + h;
                Ls[tid] = s < S ? lse[at] : 0.f;
                Dl[tid] = s < S ? delta[at] : 0.f;
            }
            __syncthreads();
            float p[CPT], ds[CPT];
            const int s = q0 + r;
            scores(Qs, dOs, Ks, Vs, Ls, Dl, D, DP, scale, s, S, q_offset + s,
                   k0, Tlen, causal, window, p, ds);
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                Ps[r * (BK + 1) + cg + 8 * c] = p[c];
                dSs[r * (BK + 1) + cg + 8 * c] = ds[c];
            }
            __syncthreads();
            const int rows = min(BQ, S - q0);
            for (int rr = 0; rr < rows; ++rr) {
                const float pv = Ps[rr * (BK + 1) + j];
                const float dsv = dSs[rr * (BK + 1) + j];
#pragma unroll
                for (int i = 0; i < NC; ++i) {
                    const int d = 4 * (sub + 4 * i);
                    if (d < D) {
                        fma4(dv_acc[i], pv, *reinterpret_cast<const float4*>(
                            dOs + rr * DP + d));
                        fma4(dk_acc[i], dsv, *reinterpret_cast<const float4*>(
                            Qs + rr * DP + d));
                    }
                }
            }
        }
    }

    const int kpos = k0 + j;
    if (kpos < Tlen) {
        const size_t row = ((size_t)b * Tlen + kpos) * KH + kh;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
            const int d = 4 * (sub + 4 * i);
            if (d < D) {
                T* kr = dk + row * D + d;
                T* vr = dv + row * D + d;
                repro::store(kr + 0, dk_acc[i].x * scale);
                repro::store(kr + 1, dk_acc[i].y * scale);
                repro::store(kr + 2, dk_acc[i].z * scale);
                repro::store(kr + 3, dk_acc[i].w * scale);
                repro::store(vr + 0, dv_acc[i].x);
                repro::store(vr + 1, dv_acc[i].y);
                repro::store(vr + 2, dv_acc[i].z);
                repro::store(vr + 3, dv_acc[i].w);
            }
        }
    }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int S, int Tlen, int H, int KH, int D,
          float scale, int causal, int window, int q_offset) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int DP = D + 4;
    float* Ks = smem;                 // BK x DP
    float* Vs = Ks + BK * DP;         // BK x DP
    float* Qs = Vs + BK * DP;         // BQ x DP
    float* dOs = Qs + BQ * DP;        // BQ x DP
    float* dSs = dOs + BQ * DP;       // BQ x (BK + 1)
    float* Ls = dSs + BQ * (BK + 1);  // BQ
    float* Dl = Ls + BQ;              // BQ

    const int tid = threadIdx.x;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest first
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / KH);
    const size_t kstride = (size_t)KH * D, qstride = (size_t)H * D;
    stage(Qs, q + ((size_t)b * S * H + h) * D, q0, BQ, S, qstride, D, DP);
    stage(dOs, dout + ((size_t)b * S * H + h) * D, q0, BQ, S, qstride, D, DP);
    if (tid < BQ) {
        const int s = q0 + tid;
        const size_t at = ((size_t)b * S + s) * H + h;
        Ls[tid] = s < S ? lse[at] : 0.f;
        Dl[tid] = s < S ? delta[at] : 0.f;
    }

    // kv range these rows can see: [lo, hi), as in the forward
    const int qpos_first = q_offset + q0;
    const int qpos_last = q_offset + min(q0 + BQ, S) - 1;
    int hi = Tlen;
    if (causal) hi = min(hi, qpos_last + 1);
    int lo = 0;
    if (window > 0) lo = max(0, qpos_first - window + 1);
    lo = (lo / BK) * BK;

    // thread (r = tid / 8, cg = tid % 8) owns row r of dQ, float4 chunks
    // cg + 8 i; the dS row it reads is written by the same eight threads
    const int r = tid >> 3, cg = tid & 7;
    constexpr int NC = DMAX / 32;
    float4 acc[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int s = q0 + r;
    const T* kb = k + ((size_t)b * Tlen * KH + kh) * D;
    const T* vb = v + ((size_t)b * Tlen * KH + kh) * D;

    for (int k0 = lo; k0 < hi; k0 += BK) {
        __syncthreads();  // the previous tile consumed (and Q, dO staged)
        stage(Ks, kb, k0, BK, Tlen, kstride, D, DP);
        stage(Vs, vb, k0, BK, Tlen, kstride, D, DP);
        __syncthreads();
        float p[CPT], ds[CPT];
        scores(Qs, dOs, Ks, Vs, Ls, Dl, D, DP, scale, s, S, q_offset + s, k0,
               Tlen, causal, window, p, ds);
#pragma unroll
        for (int c = 0; c < CPT; ++c) dSs[r * (BK + 1) + cg + 8 * c] = ds[c];
        __syncwarp();  // row r's dS comes from its own eight lanes
        const float* dsrow = dSs + r * (BK + 1);
        for (int jj = 0; jj < BK; ++jj) {
            const float dsv = dsrow[jj];
            const float* krow = Ks + jj * DP;
#pragma unroll
            for (int i = 0; i < NC; ++i) {
                const int d = 4 * (cg + 8 * i);
                if (d < D)
                    fma4(acc[i], dsv,
                         *reinterpret_cast<const float4*>(krow + d));
            }
        }
    }

    if (s < S) {
        T* row = dq + (((size_t)b * S + s) * H + h) * D;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
            const int d = 4 * (cg + 8 * i);
            if (d < D) {
                repro::store(row + d + 0, acc[i].x * scale);
                repro::store(row + d + 1, acc[i].y * scale);
                repro::store(row + d + 2, acc[i].z * scale);
                repro::store(row + d + 3, acc[i].w * scale);
            }
        }
    }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int Tlen, int H, int KH, int D, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream) {
    auto dkdv = dkdv_kernel<T, DMAX>;
    auto dqk = dq_kernel<T, DMAX>;
    // allow the largest D of this instance once (not per launch, so that
    // launches can be captured in a CUDA graph)
    static cudaError_t attr1 = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(DMAX, 2));
    static cudaError_t attr2 = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(DMAX, 1));
    if (attr1 != cudaSuccess) return attr1;
    if (attr2 != cudaSuccess) return attr2;
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dot = static_cast<const T*>(dout);
    const int rows = B * S * H;
    delta_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                      stream>>>(static_cast<const T*>(out), dot, delta, rows,
                                D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dkdv<<<dim3((Tlen + BK - 1) / BK, KH, B), THREADS, smem_bytes(D, 2),
           stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                     static_cast<T*>(dv), S, Tlen, H, KH, D, scale, causal,
                     window, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dqk<<<dim3((S + BQ - 1) / BQ, H, B), THREADS, smem_bytes(D, 1),
          stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), S,
                    Tlen, H, KH, D, scale, causal, window, q_offset);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* out, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int S, int Tlen, int H, int KH, int D, float scale,
                       int causal, int window, int q_offset,
                       cudaStream_t st) {
    if (D <= 64)
        return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B,
                             S, Tlen, H, KH, D, scale, causal, window,
                             q_offset, st);
    if (D <= 128)
        return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B,
                              S, Tlen, H, KH, D, scale, causal, window,
                              q_offset, st);
    return launch<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                          Tlen, H, KH, D, scale, causal, window, q_offset,
                          st);
}

}  // namespace

// Bytes of dynamic shared memory the larger (dK/dV) kernel needs at head
// dim D; the wrapper refuses a layout over the 227 KB a block may use.
extern "C" int repro_flash_attention_bwd_smem(int D) {
    return (int)smem_bytes(D, 2);
}

// dtype: 0 = float32, 1 = bfloat16.  delta is float32 scratch of B*S*H.
// Returns a cudaError_t (0 = success).
extern "C" int repro_flash_attention_bwd(
        const void* q, const void* k, const void* v, const void* out,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int B, int S, int Tlen, int H, int KH, int D, float scale,
        int causal, int window, int q_offset, int dtype, void* stream) {
    if (B < 1 || S < 1 || Tlen < 1 || KH < 1 || H % KH != 0 || D < 8 ||
        D > 256 || D % 8 != 0 || (dtype != 0 && dtype != 1) ||
        smem_bytes(D, 2) > 232448)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)dispatch_d<float>(q, k, v, out, dout, lse, delta, dq, dk,
                                      dv, B, S, Tlen, H, KH, D, scale, causal,
                                      window, q_offset, st);
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq,
                                          dk, dv, B, S, Tlen, H, KH, D, scale,
                                          causal, window, q_offset, st);
}
