// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `flash_attention_bhsd` / `_flash_kernel` of
// src/repro/kernels/flash_attention.py: online-softmax attention with GQA
// (query head h reads KV head h / (H / KH)), causal and sliding-window
// masks, an absolute query offset, and a ragged S / T (no padding by the
// caller).  Scores, softmax and the accumulator are float32 whatever the
// element type; the denominator is clamped at 1e-30 as on the TPU.
// Inputs and output keep the reference layout: q, out (B, S, H, D),
// k, v (B, T, KH, D), all contiguous and 16-byte aligned, D a multiple of
// 8.  For training, an optional float32 lse (B, S, H) receives each row's
// natural-log log-sum-exp m + log(max(l, 1e-30)) of the scaled, masked
// scores, which the backward kernels (flash_attention_bwd.cu) recompute P
// from; serving passes none.  The kernels launch on the caller's stream,
// allocate nothing and do not synchronise.
//
// What bounds it on the H100: 4 * S * T * D flops per (b, h) (about half
// under a causal mask) against (S + 2 T) * D elements read, so at prefill
// lengths it is bound by the tensor cores' bf16 rate.  Two paths, chosen
// by `repro_flash_attention_tensor_cores` (the wrapper asks the same rule):
//
// The tensor-core path (bf16, D a multiple of 16 in [64, 128]):
// `flash_fwd_tc_kernel`, built from hopper_common.cuh.
//   * one block per (q tile of 128 rows, head, batch), the heaviest tiles
//     first under a causal mask; two consumer warpgroups of 64 query rows
//     each and one producer warp (its warpgroup hands its registers to the
//     consumers).  When S <= 64 the tile is 64 rows with one consumer
//     warpgroup, so a short prefill does not run half-empty tiles;
//   * the producer loads the Q tile once and keeps a 2-stage ring of K/V
//     tiles of 128 rows full with TMA (4-D tensor maps (D, heads, length,
//     batch), so rows past a ragged T arrive as zeros and are masked);
//     mbarriers signal arrival and release.  kv tiles that the causal or
//     window mask rules out entirely are never loaded;
//   * S = Q K^T runs by wgmma from shared memory (K read as stored, K-major);
//     the scale is applied to S in float32 (a pre-scaled bf16 Q would be
//     rounded again);
//   * the online softmax runs in registers with exp2f on log2(e)-scaled
//     scores; a row's max reduces over its quad by two shuffles, and its
//     sum stays per thread until the end;
//   * P is rounded to bf16 in registers and feeds O += P V as wgmma's
//     register A operand; V is read as stored through the B transpose
//     bit (MN-major);
//   * head dims under 128 pad to 64-column panels: TMA fills the columns
//     past D with zeros, which add nothing to S, and O's are not written.
// The FMA path (float32, and D outside that set, e.g. 40): `flash_fwd_kernel`,
// float32 FMAs out of shared memory (no tensor cores; TF32 would break the
// float32 bounds the card checks hold):
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
#include "common.cuh"
#include "hopper_common.cuh"

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

// ---------------------------------------------------------------------------
// The tensor-core path
namespace tc {

using namespace repro::hopper;

constexpr int BN = 128;      // kv rows a ring stage (D <= 128)
constexpr int STAGES = 2;
constexpr int BOX = 64;      // rows of one TMA box (every tensor map)
constexpr float LN2 = 0.6931471805599453f;
using repro::LOG2E;
using repro::live;

// NWG consumer warpgroups of 64 query rows; P panels of 64 columns
template <int NWG, int P>
struct Fwd {
    static constexpr int BM = 64 * NWG;
    static constexpr int THREADS = 128 * (NWG + 1);
    static constexpr int Q_BYTES = BM * 128 * P;
    static constexpr int KV_BYTES = BN * 128 * P;  // one of K or V a stage
    // 1 KB of slack to align the tiles, then Q, the K and V stages, and
    // the barriers (full and empty a stage, and Q's)
    static constexpr int SMEM =
        1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (2 * STAGES + 1);
};

template <int NWG, int P>
__global__ void __launch_bounds__(Fwd<NWG, P>::THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                    int S, int Tlen, int H, int KH, int D, float scale,
                    int causal, int window, int q_offset) {
    using C = Fwd<NWG, P>;
    extern __shared__ __align__(16) uint8_t tc_smem[];
    uint8_t* Qs = align_1024(tc_smem);
    uint8_t* Ks = Qs + C::Q_BYTES;            // stage s at s * KV_BYTES
    uint8_t* Vs = Ks + STAGES * C::KV_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * C::KV_BYTES);
    uint64_t* empty = full + STAGES;
    uint64_t* qbar = empty + STAGES;

    const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * C::BM;
    const int h = blockIdx.y, b = blockIdx.z, kh = h / (H / KH);
    // the kv range the tile's rows can see: [lo, hi), lo on a tile edge
    const int qpos_first = q_offset + q0;
    const int qpos_last = q_offset + min(q0 + C::BM, S) - 1;
    int hi = Tlen;
    if (causal) hi = min(hi, qpos_last + 1);
    int lo = 0;
    if (window > 0) lo = max(0, qpos_first - window + 1);
    lo = (lo / BN) * BN;
    const int n_tiles = hi > lo ? (hi - lo + BN - 1) / BN : 0;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], NWG * 128);
        }
        mbar_init(qbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == NWG) {  // the producer: one thread issues every copy
        if constexpr (NWG == 2) setmaxnreg_dec<24>();
        if (threadIdx.x % 128 == 0) {
            tma_prefetch_map(&tq);
            tma_prefetch_map(&tk);
            tma_prefetch_map(&tv);
            mbar_arrive_expect_tx(qbar, C::Q_BYTES);
            for (int p = 0; p < P; ++p)
                for (int r = 0; r < C::BM; r += BOX)
                    tma_load_4d(Qs + (p * C::BM + r) * 128, &tq, qbar, 64 * p,
                                h, q0 + r, b);
            for (int i = 0; i < n_tiles; ++i) {
                const int s = i % STAGES, k0 = lo + i * BN;
                mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
                mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
                uint8_t* kst = Ks + s * C::KV_BYTES;
                uint8_t* vst = Vs + s * C::KV_BYTES;
                for (int p = 0; p < P; ++p)
                    for (int r = 0; r < BN; r += BOX) {
                        const int at = (p * BN + r) * 128;
                        tma_load_4d(kst + at, &tk, &full[s], 64 * p, kh,
                                    k0 + r, b);
                        tma_load_4d(vst + at, &tv, &full[s], 64 * p, kh,
                                    k0 + r, b);
                    }
            }
        }
        return;
    }

    // a consumer warpgroup: 64 query rows
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, lane = t % 32;
    const int rw = wg * 64 + (t / 32) * 16 + lane / 4;  // and rw + 8
    const int c2 = 2 * (lane % 4);
    const float sl2 = scale * LOG2E;
    float o[32 * P];
#pragma unroll
    for (int i = 0; i < 32 * P; ++i) o[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const uint8_t* qa = Qs + wg * 64 * 128;  // this warpgroup's rows
    mbar_wait(qbar, 0);

    for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES, k0 = lo + i * BN;
        const uint8_t* kst = Ks + s * C::KV_BYTES;
        const uint8_t* vst = Vs + s * C::KV_BYTES;
        mbar_wait(&full[s], (i / STAGES) & 1);

        float sc[64];  // S = Q K^T, 64 x 128
#pragma unroll
        for (int j = 0; j < 64; ++j) sc[j] = 0.f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4 * P; ++kk) {
            const int at = (kk % 4) * 32;  // 16 columns a step in a panel
            wgmma_ss<0>(sc,
                        desc_k_major(qa + (kk / 4) * C::BM * 128 + at),
                        desc_k_major(kst + (kk / 4) * BN * 128 + at), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // the mask, where the tile is not live throughout
        const bool edge = k0 + BN > Tlen ||
                          (causal && k0 + BN - 1 > qpos_first) ||
                          (window > 0 && qpos_first + C::BM - 1 - k0 >= window);
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < 64; ++j) {
            float x = sc[j] * sl2;
            if (edge) {
                const int kpos = k0 + 8 * (j / 4) + c2 + (j % 2);
                const int qpos = q_offset + q0 + rw + 8 * ((j / 2) % 2);
                if (!live(qpos, kpos, Tlen, causal, window)) x = NEG_INF;
            }
            sc[j] = x;
            mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], x);
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            alpha[r] = exp2f(m[r] - mx[r]);
            m[r] = mx[r];
            l[r] *= alpha[r];
        }
#pragma unroll
        for (int j = 0; j < 64; ++j) {
            const int r = (j / 2) % 2;
            const float p = exp2f(sc[j] - m[r]);
            l[r] += p;
            sc[j] = p;
        }
#pragma unroll
        for (int j = 0; j < 32 * P; ++j) o[j] *= alpha[(j / 2) % 2];

        uint32_t pa[8][4];  // P in bf16, the A operand of O += P V
        acc_to_a(sc, pa);
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
            wgmma_rs<1>(o, pa[kk], desc_mn_major(vst + kk * 16 * 128, BN * 128),
                        1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int srow = q0 + rw + 8 * r;
        if (srow >= S) continue;
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow = out + ((size_t)(b * S + srow) * H + h) * D;
#pragma unroll
        for (int i = 0; i < 8 * P; ++i) {
            const int d = 8 * i + c2;
            if (d < D)
                *reinterpret_cast<__nv_bfloat162*>(orow + d) =
                    __floats2bfloat162_rn(o[4 * i + 2 * r] * inv,
                                          o[4 * i + 2 * r + 1] * inv);
        }
        if (lse != nullptr && lane % 4 == 0)
            lse[(size_t)(b * S + srow) * H + h] =
                m[r] * LN2 + logf(fmaxf(l[r], 1e-30f));
    }
}

template <int NWG, int P>
cudaError_t launch_inst(const CUtensorMap& tq, const CUtensorMap& tk,
                        const CUtensorMap& tv, void* out, float* lse, int B,
                        int S, int Tlen, int H, int KH, int D, float scale,
                        int causal, int window, int q_offset,
                        cudaStream_t stream) {
    using C = Fwd<NWG, P>;
    auto kernel = flash_fwd_tc_kernel<NWG, P>;
    // once per instance (not per launch, so launches stay capturable in a
    // CUDA graph)
    static cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (attr != cudaSuccess) return attr;
    dim3 grid((S + C::BM - 1) / C::BM, H, B);
    kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
        tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, Tlen, H, KH, D,
        scale, causal, window, q_offset);
    return cudaGetLastError();
}

cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int Tlen, int H, int KH, int D,
                   float scale, int causal, int window, int q_offset,
                   cudaStream_t stream) {
    CUtensorMap tq, tk, tv;
    cudaError_t err = make_map_bf16(&tq, q, B, S, H, D, BOX);
    if (err == cudaSuccess) err = make_map_bf16(&tk, k, B, Tlen, KH, D, BOX);
    if (err == cudaSuccess) err = make_map_bf16(&tv, v, B, Tlen, KH, D, BOX);
    if (err != cudaSuccess) return err;
#define REPRO_FWD_TC(NWG, P)                                                  \
    return launch_inst<NWG, P>(tq, tk, tv, out, lse, B, S, Tlen, H, KH, D,   \
                               scale, causal, window, q_offset, stream)
    if (S <= 64) {  // a short prefill: 64-row tiles, one consumer warpgroup
        if (D <= 64) REPRO_FWD_TC(1, 1);
        REPRO_FWD_TC(1, 2);
    }
    if (D <= 64) REPRO_FWD_TC(2, 1);
    REPRO_FWD_TC(2, 2);
#undef REPRO_FWD_TC
}

}  // namespace tc

}  // namespace

// 1 when K1 and K1-bwd run on the tensor cores for this head dim and dtype
// (0 = float32, 1 = bfloat16): bf16, D a multiple of 16 in [64, 128].
// The wrappers ask this before they launch, and count by it.
extern "C" int repro_flash_attention_tensor_cores(int D, int dtype) {
    return dtype == 1 && D % 16 == 0 && D >= 64 && D <= 128;
}

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
    if (repro_flash_attention_tensor_cores(D, dtype))
        return (int)tc::launch(q, k, v, out, lse, B, S, Tlen, H, KH, D, scale,
                               causal, window, q_offset, st);
    if (dtype == 0)
        return (int)dispatch_d<float>(q, k, v, out, lse, B, S, Tlen, H, KH,
                                      D, scale, causal, window, q_offset, st);
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, out, lse, B, S, Tlen, H,
                                          KH, D, scale, causal, window,
                                          q_offset, st);
}
