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
// Sums are float32; dq, dk, dv are written once in the input type.
//
// What bounds it on the H100: the work is about 5 * 2 * S * T * D flops
// per (b, h) (halved by causality) against about 4 (S + T) H D elements
// moved, so it is bound by the tensor cores' bf16 rate.  Three kernels on
// the caller's stream whatever the path: a prologue writes delta; a
// dK/dV kernel keeps a kv tile's dK and dV in registers while it loops
// over the G query heads of its KV head and the q tiles that can see the
// tile, recomputing P from lse, and writes them once; a dQ kernel loops
// over the kv tiles its q tile can see.  No atomics: every sum runs in a
// fixed order, so the result is the same bit for bit from run to run.
// Tiles that the causal or window mask rules out entirely are never
// visited, and the heaviest blocks are issued first.  Two paths, chosen
// by `repro_flash_attention_tensor_cores` (flash_attention.cu), as K1's:
//
// The tensor-core path (bf16, D a multiple of 16 in [64, 128]):
// `dkdv_tc_kernel` and `dq_tc_kernel`, built from hopper_common.cuh, each
// with two consumer warpgroups of 64 rows and one producer warp (its
// warpgroup hands its registers to the consumers), every product a wgmma
// with float32 sums, the transposed operands read through the transpose
// bit (MN-major):
//   * dK/dV: one block per (kv tile of 128 rows, KV head, batch); K and V
//     arrive once by TMA, Q and dO tiles of 64 rows by TMA into a 2-stage
//     ring, with their 64 lse and delta values (strided in (B, S, H), so
//     loaded by the producer warp's lanes onto the same barrier).  Per q
//     tile: S^T = K Q^T and dP^T = V dO^T from shared memory; P^T =
//     exp(scale S^T - lse) and dS^T = P^T (dP^T - delta) in registers;
//     dV += P^T dO and dK += dS^T Q with bf16 P^T and dS^T as the register
//     A operand.  dK is scaled once at the end;
//   * dQ: one block per (q tile of 128 rows, head, batch); Q and dO arrive
//     once, K and V tiles of 64 rows through the ring; S = Q K^T and
//     dP = dO V^T recompute P and dS, and dQ += dS K with bf16 dS.
// P^T, dS^T and dS are rounded to bf16 before their products, where the
// plain version keeps float32.
//
// The FMA path (float32, and other head dims): `dkdv_kernel` and
// `dq_kernel`, float32 FMAs out of shared memory (no tensor cores):
//   * dK/dV one block per (kv tile of 64 rows, KV head, batch), dQ one
//     block per (q tile of 32 rows, head, batch);
//   * tiles live in shared memory as float32 rows padded to D + 4, so the
//     inner products read 16 bytes (four dims) per load and the eight
//     rows a quarter-warp reads fall in distinct banks;
//   * the heaviest blocks (the first kv tiles, the last q tiles under a
//     causal mask) are issued first.
#include "common.cuh"
#include "hopper_common.cuh"

namespace {

using repro::live;
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
                   int window, int q_offset, cudaStream_t stream,
                   int& step) {
    auto dkdv = dkdv_kernel<T, DMAX>;
    auto dqk = dq_kernel<T, DMAX>;
    // allow the largest D of this instance
    step = repro::STEP_ATTRIBUTE;
    cudaError_t err = repro::allow_smem<dkdv_kernel<T, DMAX>>(
        (int)smem_bytes(DMAX, 2));
    if (err == cudaSuccess)
        err = repro::allow_smem<dq_kernel<T, DMAX>>(
            (int)smem_bytes(DMAX, 1));
    if (err != cudaSuccess) return err;
    step = repro::STEP_LAUNCH;
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dot = static_cast<const T*>(dout);
    const int rows = B * S * H;
    delta_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
                      stream>>>(static_cast<const T*>(out), dot, delta, rows,
                                D);
    err = cudaGetLastError();
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
                       cudaStream_t st, int& step) {
    if (D <= 64)
        return launch<T, 64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B,
                             S, Tlen, H, KH, D, scale, causal, window,
                             q_offset, st, step);
    if (D <= 128)
        return launch<T, 128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B,
                              S, Tlen, H, KH, D, scale, causal, window,
                              q_offset, st, step);
    return launch<T, 256>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                          Tlen, H, KH, D, scale, causal, window, q_offset,
                          st, step);
}

// ---------------------------------------------------------------------------
// The tensor-core path
namespace tc {

using namespace repro::hopper;

constexpr int BM = 64;       // q rows a ring stage of the dK/dV kernel
constexpr int BN = 128;      // kv rows a block of the dK/dV kernel
constexpr int QM = 128;      // q rows a block of the dQ kernel
constexpr int KN = 64;       // kv rows a ring stage of the dQ kernel
constexpr int STAGES = 2;
constexpr int BOX = 64;      // rows of one TMA box (every tensor map)
constexpr int TC_THREADS = 384;  // two consumer warpgroups, the producer's
using repro::LOG2E;

// shared memory, P panels of 64 columns: 1 KB of alignment slack, the
// tiles, then lse and delta (dK/dV) and the barriers
template <int P>
struct DkDv {
    static constexpr int KV_BYTES = BN * 128 * P;  // K or V of the block
    static constexpr int QT_BYTES = BM * 128 * P;  // Q or dO of a stage
    static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * QT_BYTES +
                                2 * STAGES * BM * 4 + 8 * (2 * STAGES + 1);
};

template <int P>
struct Dq {
    static constexpr int Q_BYTES = QM * 128 * P;   // Q or dO of the block
    static constexpr int KV_BYTES = KN * 128 * P;  // K or V of a stage
    static constexpr int SMEM =
        1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (2 * STAGES + 1);
};

template <int P>
__global__ void __launch_bounds__(TC_THREADS, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tdo,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int S, int Tlen, int H, int KH, int D, float scale, int causal,
               int window, int q_offset) {
    using C = DkDv<P>;
    extern __shared__ __align__(16) uint8_t tc_smem[];
    uint8_t* Ks = align_1024(tc_smem);
    uint8_t* Vs = Ks + C::KV_BYTES;
    uint8_t* Qs = Vs + C::KV_BYTES;             // stage s at s * QT_BYTES
    uint8_t* Os = Qs + STAGES * C::QT_BYTES;    // dO, likewise
    float* Ls = reinterpret_cast<float*>(Os + STAGES * C::QT_BYTES);
    float* Dl = Ls + STAGES * BM;               // lse * log2(e), delta
    uint64_t* full = reinterpret_cast<uint64_t*>(Dl + STAGES * BM);
    uint64_t* empty = full + STAGES;
    uint64_t* kvbar = empty + STAGES;

    const int k0 = blockIdx.x * BN, kh = blockIdx.y, b = blockIdx.z;
    const int G = H / KH;
    // the query rows that can see a key of this tile: [s_lo, s_hi)
    const int kmax = min(k0 + BN, Tlen) - 1;
    int s_lo = 0, s_hi = S;
    if (causal) s_lo = max(0, k0 - q_offset);
    if (window > 0) s_hi = min(S, kmax + window - q_offset);
    s_lo = (s_lo / BM) * BM;
    const int n_q = s_hi > s_lo ? (s_hi - s_lo + BM - 1) / BM : 0;
    const int n_iter = G * n_q;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 32);  // the producer warp's lanes
            mbar_init(&empty[s], 256);
        }
        mbar_init(kvbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {  // the producer: its first warp issues every copy
        setmaxnreg_dec<24>();
        if (threadIdx.x / 32 != 8) return;
        const int lane = threadIdx.x % 32;
        if (lane == 0) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tdo);
            mbar_arrive_expect_tx(kvbar, 2 * C::KV_BYTES);
            for (int p = 0; p < P; ++p)
                for (int r = 0; r < BN; r += BOX) {
                    const int at = (p * BN + r) * 128;
                    tma_load_4d(Ks + at, &tk, kvbar, 64 * p, kh, k0 + r, b);
                    tma_load_4d(Vs + at, &tv, kvbar, 64 * p, kh, k0 + r, b);
                }
        }
        for (int i = 0; i < n_iter; ++i) {
            const int s = i % STAGES;
            const int h = kh * G + i / n_q, q0 = s_lo + (i % n_q) * BM;
            mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
            for (int r = lane; r < BM; r += 32) {
                const int srow = q0 + r;
                const size_t at = ((size_t)b * S + srow) * H + h;
                Ls[s * BM + r] = srow < S ? lse[at] * LOG2E : 0.f;
                Dl[s * BM + r] = srow < S ? delta[at] : 0.f;
            }
            if (lane == 0) {
                mbar_arrive_expect_tx(&full[s], 2 * C::QT_BYTES);
                for (int p = 0; p < P; ++p) {
                    const int at = s * C::QT_BYTES + p * BM * 128;
                    tma_load_4d(Qs + at, &tq, &full[s], 64 * p, h, q0, b);
                    tma_load_4d(Os + at, &tdo, &full[s], 64 * p, h, q0, b);
                }
            } else {
                mbar_arrive(&full[s]);
            }
        }
        return;
    }

    // a consumer warpgroup: 64 kv rows
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int kpos0 = k0 + wg * 64 + (t / 32) * 16 + lane / 4;  // and + 8
    const int c2 = 2 * (lane % 4);
    const float sl2 = scale * LOG2E;
    float dka[32 * P], dva[32 * P];
#pragma unroll
    for (int j = 0; j < 32 * P; ++j) dka[j] = dva[j] = 0.f;
    const uint8_t* ka = Ks + wg * 64 * 128;  // this warpgroup's rows
    const uint8_t* va = Vs + wg * 64 * 128;
    mbar_wait(kvbar, 0);

    for (int i = 0; i < n_iter; ++i) {
        const int s = i % STAGES, q0 = s_lo + (i % n_q) * BM;
        const uint8_t* qst = Qs + s * C::QT_BYTES;
        const uint8_t* ost = Os + s * C::QT_BYTES;
        mbar_wait(&full[s], (i / STAGES) & 1);

        float st[32], dpt[32];  // S^T = K Q^T and dP^T = V dO^T, 64 x 64
#pragma unroll
        for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * P; ++kk) {
            const int at = (kk % 4) * 32;  // 16 columns a step in a panel
            wgmma_ss<0>(st, desc_k_major(ka + (kk / 4) * BN * 128 + at),
                        desc_k_major(qst + (kk / 4) * BM * 128 + at), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < 4 * P; ++kk) {
            const int at = (kk % 4) * 32;
            wgmma_ss<0>(dpt, desc_k_major(va + (kk / 4) * BN * 128 + at),
                        desc_k_major(ost + (kk / 4) * BM * 128 + at), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P^T and dS^T; element j is kv row kpos0 + 8 ((j / 2) % 2), q
        // row q0 + col
        const float* ls = Ls + s * BM;
        const float* dl = Dl + s * BM;
        const bool edge = q0 + BM > S || k0 + BN > Tlen ||
                          (causal && k0 + BN - 1 > q_offset + q0) ||
                          (window > 0 && q_offset + q0 + BM - 1 - k0 >= window);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int col = 8 * (j / 4) + c2 + (j % 2);
            float p = exp2f(st[j] * sl2 - ls[col]);
            if (edge && !(q0 + col < S &&
                          live(q_offset + q0 + col, kpos0 + 8 * ((j / 2) % 2),
                               Tlen, causal, window)))
                p = 0.f;
            st[j] = p;
            dpt[j] = p * (dpt[j] - dl[col]);
        }
        uint32_t pa[4][4], da[4][4];  // bf16 P^T and dS^T, A operands
        acc_to_a(st, pa);
        acc_to_a(dpt, da);
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<1>(dva, pa[kk],
                        desc_mn_major(ost + kk * 16 * 128, BM * 128), 1);
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk)
            wgmma_rs<1>(dka, da[kk],
                        desc_mn_major(qst + kk * 16 * 128, BM * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int kpos = kpos0 + 8 * r;
        if (kpos >= Tlen) continue;
        const size_t row = ((size_t)b * Tlen + kpos) * KH + kh;
#pragma unroll
        for (int i = 0; i < 8 * P; ++i) {
            const int d = 8 * i + c2;
            if (d < D) {
                const int j = 4 * i + 2 * r;
                *reinterpret_cast<__nv_bfloat162*>(dk + row * D + d) =
                    __floats2bfloat162_rn(dka[j] * scale, dka[j + 1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(dv + row * D + d) =
                    __floats2bfloat162_rn(dva[j], dva[j + 1]);
            }
        }
    }
}

template <int P>
__global__ void __launch_bounds__(TC_THREADS, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tdo,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int S, int Tlen, int H, int KH,
             int D, float scale, int causal, int window, int q_offset) {
    using C = Dq<P>;
    extern __shared__ __align__(16) uint8_t tc_smem[];
    uint8_t* Qs = align_1024(tc_smem);
    uint8_t* Os = Qs + C::Q_BYTES;
    uint8_t* Ks = Os + C::Q_BYTES;              // stage s at s * KV_BYTES
    uint8_t* Vs = Ks + STAGES * C::KV_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_BYTES);
    uint64_t* empty = full + STAGES;
    uint64_t* qbar = empty + STAGES;

    const int q0 = (gridDim.x - 1 - blockIdx.x) * QM;  // heaviest first
    const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
    // the kv range these rows can see: [lo, hi), as in the forward
    const int qpos_first = q_offset + q0;
    const int qpos_last = q_offset + min(q0 + QM, S) - 1;
    int hi = Tlen;
    if (causal) hi = min(hi, qpos_last + 1);
    int lo = 0;
    if (window > 0) lo = max(0, qpos_first - window + 1);
    lo = (lo / KN) * KN;
    const int n_tiles = hi > lo ? (hi - lo + KN - 1) / KN : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 256);
        }
        mbar_init(qbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {  // the producer: one thread issues every copy
        setmaxnreg_dec<24>();
        if (threadIdx.x % 128 != 0) return;
        tma_prefetch_map(&tk);
        tma_prefetch_map(&tv);
        mbar_arrive_expect_tx(qbar, 2 * C::Q_BYTES);
        for (int p = 0; p < P; ++p)
            for (int r = 0; r < QM; r += BOX) {
                const int at = (p * QM + r) * 128;
                tma_load_4d(Qs + at, &tq, qbar, 64 * p, h, q0 + r, b);
                tma_load_4d(Os + at, &tdo, qbar, 64 * p, h, q0 + r, b);
            }
        for (int i = 0; i < n_tiles; ++i) {
            const int s = i % STAGES, k0 = lo + i * KN;
            mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
            for (int p = 0; p < P; ++p) {
                const int at = s * C::KV_BYTES + p * KN * 128;
                tma_load_4d(Ks + at, &tk, &full[s], 64 * p, kh, k0, b);
                tma_load_4d(Vs + at, &tv, &full[s], 64 * p, kh, k0, b);
            }
        }
        return;
    }

    // a consumer warpgroup: 64 query rows
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rw = wg * 64 + (t / 32) * 16 + lane / 4;  // and rw + 8
    const int c2 = 2 * (lane % 4);
    const float sl2 = scale * LOG2E;
    float ls[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int srow = q0 + rw + 8 * r;
        const size_t at = ((size_t)b * S + srow) * H + h;
        ls[r] = srow < S ? lse[at] * LOG2E : 0.f;
        dl[r] = srow < S ? delta[at] : 0.f;
    }
    float dqa[32 * P];
#pragma unroll
    for (int j = 0; j < 32 * P; ++j) dqa[j] = 0.f;
    const uint8_t* qa = Qs + wg * 64 * 128;  // this warpgroup's rows
    const uint8_t* oa = Os + wg * 64 * 128;
    mbar_wait(qbar, 0);

    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = lo + i * KN;
        const uint8_t* kst = Ks + s * C::KV_BYTES;
        const uint8_t* vst = Vs + s * C::KV_BYTES;
        mbar_wait(&full[s], (i / STAGES) & 1);

        float sc[32], dp[32];  // S = Q K^T and dP = dO V^T, 64 x 64
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * P; ++kk) {
            const int at = (kk % 4) * 32;  // 16 columns a step in a panel
            wgmma_ss<0>(sc, desc_k_major(qa + (kk / 4) * QM * 128 + at),
                        desc_k_major(kst + (kk / 4) * KN * 128 + at), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < 4 * P; ++kk) {
            const int at = (kk % 4) * 32;
            wgmma_ss<0>(dp, desc_k_major(oa + (kk / 4) * QM * 128 + at),
                        desc_k_major(vst + (kk / 4) * KN * 128 + at), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        const bool edge = k0 + KN > Tlen ||
                          (causal && k0 + KN - 1 > qpos_first) ||
                          (window > 0 && qpos_first + QM - 1 - k0 >= window);
#pragma unroll
        for (int j = 0; j < 32; ++j) {
            const int r = (j / 2) % 2;
            float p = exp2f(sc[j] * sl2 - ls[r]);
            if (edge && !live(q_offset + q0 + rw + 8 * r,
                              k0 + 8 * (j / 4) + c2 + (j % 2), Tlen, causal,
                              window))
                p = 0.f;
            dp[j] = p * (dp[j] - dl[r]);
        }
        uint32_t da[4][4];  // bf16 dS, the A operand of dQ += dS K
        acc_to_a(dp, da);
        fence_regs(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk)
            wgmma_rs<1>(dqa, da[kk],
                        desc_mn_major(kst + kk * 16 * 128, KN * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int srow = q0 + rw + 8 * r;
        if (srow >= S) continue;
        __nv_bfloat16* row = dq + (((size_t)b * S + srow) * H + h) * D;
#pragma unroll
        for (int i = 0; i < 8 * P; ++i) {
            const int d = 8 * i + c2;
            if (d < D)
                *reinterpret_cast<__nv_bfloat162*>(row + d) =
                    __floats2bfloat162_rn(dqa[4 * i + 2 * r] * scale,
                                          dqa[4 * i + 2 * r + 1] * scale);
        }
    }
}

template <int P>
cudaError_t launch_inst(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, const CUtensorMap& tdo,
                        const float* lse, const float* delta, void* dq,
                        void* dk, void* dv, int B, int S, int Tlen, int H,
                        int KH, int D, float scale, int causal, int window,
                        int q_offset, cudaStream_t stream,
                        int& step) {
    auto dkdv = dkdv_tc_kernel<P>;
    auto dqk = dq_tc_kernel<P>;
    step = repro::STEP_ATTRIBUTE;
    cudaError_t err = repro::allow_smem<dkdv_tc_kernel<P>>(DkDv<P>::SMEM);
    if (err == cudaSuccess)
        err = repro::allow_smem<dq_tc_kernel<P>>(Dq<P>::SMEM);
    if (err != cudaSuccess) return err;
    step = repro::STEP_LAUNCH;
    dkdv<<<dim3((Tlen + BN - 1) / BN, KH, B), TC_THREADS, DkDv<P>::SMEM,
           stream>>>(tq, tk, tv, tdo, lse, delta,
                     static_cast<__nv_bfloat16*>(dk),
                     static_cast<__nv_bfloat16*>(dv), S, Tlen, H, KH, D,
                     scale, causal, window, q_offset);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dqk<<<dim3((S + QM - 1) / QM, H, B), TC_THREADS, Dq<P>::SMEM, stream>>>(
        tq, tk, tv, tdo, lse, delta, static_cast<__nv_bfloat16*>(dq), S, Tlen,
        H, KH, D, scale, causal, window, q_offset);
    return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int Tlen, int H, int KH, int D, float scale, int causal,
                   int window, int q_offset, cudaStream_t stream,
                   int& step) {
    step = repro::STEP_TENSOR_MAP;
    CUtensorMap tq, tk, tv, tdo;
    cudaError_t err = make_map_bf16(&tq, q, B, S, H, D, BOX);
    if (err == cudaSuccess) err = make_map_bf16(&tk, k, B, Tlen, KH, D, BOX);
    if (err == cudaSuccess) err = make_map_bf16(&tv, v, B, Tlen, KH, D, BOX);
    if (err == cudaSuccess) err = make_map_bf16(&tdo, dout, B, S, H, D, BOX);
    if (err != cudaSuccess) return err;
    step = repro::STEP_LAUNCH;
    const int rows = B * S * H;
    delta_kernel<__nv_bfloat16>
        <<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0,
           stream>>>(static_cast<const __nv_bfloat16*>(out),
                     static_cast<const __nv_bfloat16*>(dout), delta, rows, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (D <= 64)
        return launch_inst<1>(tq, tk, tv, tdo, lse, delta, dq, dk, dv, B, S,
                              Tlen, H, KH, D, scale, causal, window, q_offset,
                              stream, step);
    return launch_inst<2>(tq, tk, tv, tdo, lse, delta, dq, dk, dv, B, S, Tlen,
                          H, KH, D, scale, causal, window, q_offset, stream,
                          step);
}

}  // namespace tc

}  // namespace

// the path rule, flash_attention.cu's (the kernels link into one library)
extern "C" int repro_flash_attention_tensor_cores(int D, int dtype);

// Bytes of dynamic shared memory the larger (dK/dV) kernel needs at head
// dim D; the wrapper refuses a layout over the 227 KB a block may use.
extern "C" int repro_flash_attention_bwd_smem(int D) {
    return (int)smem_bytes(D, 2);
}

// dtype: 0 = float32, 1 = bfloat16.  delta is float32 scratch of B*S*H.
// Returns a cudaError_t (0 = success); on a failure `failed_step` (a host
// int, or null) gets the step that failed: a LaunchStep of common.cuh
// (the shared-memory allowance, a tensor map, or a launch).
extern "C" int repro_flash_attention_bwd(
        const void* q, const void* k, const void* v, const void* out,
        const void* dout, const float* lse, float* delta, void* dq, void* dk,
        void* dv, int B, int S, int Tlen, int H, int KH, int D, float scale,
        int causal, int window, int q_offset, int dtype, void* stream,
        int* failed_step) {
    if (B < 1 || S < 1 || Tlen < 1 || KH < 1 || H % KH != 0 || D < 8 ||
        D > 256 || D % 8 != 0 || (dtype != 0 && dtype != 1) ||
        smem_bytes(D, 2) > 232448)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int step = repro::STEP_NONE;
    cudaError_t err;
    if (repro_flash_attention_tensor_cores(D, dtype))
        err = tc::launch(q, k, v, out, dout, lse, delta, dq, dk, dv, B, S,
                         Tlen, H, KH, D, scale, causal, window, q_offset, st,
                         step);
    else if (dtype == 0)
        err = dispatch_d<float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B,
                                S, Tlen, H, KH, D, scale, causal, window,
                                q_offset, st, step);
    else
        err = dispatch_d<__nv_bfloat16>(q, k, v, out, dout, lse, delta, dq,
                                        dk, dv, B, S, Tlen, H, KH, D, scale,
                                        causal, window, q_offset, st, step);
    if (err != cudaSuccess && failed_step != nullptr) *failed_step = step;
    return (int)err;
}
