// Chunkwise mLSTM backward (K6-bwd) for Hopper (sm_90a), hand-written CUDA
// C++.
//
// The training counterpart of K6 (mlstm_scan.cu).  The reference cannot
// differentiate its TPU kernel; it trains the mLSTM by autodiff through
// the sequential oracle `mlstm_scan` (src/repro/kernels/ref.py).  This
// computes the same gradients chunk by chunk.  The stabiliser m is held
// constant: h does not depend on it (any sequence of m gives the same h),
// so its gradient path adds nothing.  With v' = [v, 1] and C' = [C, n] the
// numerator and the normaliser are one product, and the backward is that
// of a decayed linear attention with pairwise weights W[t, j] =
// exp(B_t - B_j + log i_j - m_t) (B the cumulative log-forget):
//   dO_t = dh_t / den_t,  dqn_t = -(dh_t . h_t) / den_t * sign(qn_t) where
//   |qn_t| wins den_t = max(|qn_t|, e^{-m_t}), else 0;
//   dS[t, j] = dO_t . v_j + dqn_t within a chunk;
//   dq_t = iw_t (C' dO'_t) + sum_j dS W k_j          (forward walk, C')
//   dk_j = wk_j (dC' v'_j) + sum_t dS W q_t          (reverse walk, dC')
//   dv_j = wk_j (k_j dC) + sum_t S[t, j] dO_t        (reverse walk, dC)
//   d log i_j = k_j . dk_j,  d B_t = q_t . dq_t - k_t . dk_t,
//   d log f = reverse cumsum of d B,  d f_pre = d log f * sigmoid(-f_pre).
// Inputs: q, k, v, h, dh in float32 or bfloat16, the gates float32, the
// forward's per-row m and qn (float32).  Outputs dq, dk, dv in the input
// type, d i_pre and d f_pre float32.
//
// What bounds it on the H100: at the training shape (B = 8, H = 4,
// S = 4096, D = DV = 384, bf16) it reads q, k, v, h, dh and writes dq, dk,
// dv, about 806 MB (0.24 ms at 3.35 TB/s); its products, 2 L (3 D +
// 2 DV) + 10 D DV flops a row, are 209 GFLOP at L = 32 (0.21 ms on the
// tensor cores).  Kernels on the caller's stream: a prologue writes each row's 1 / den and dqn (one warp a row, dh . h over
// DV); the walks: dv, one block per (DV tile of 64, head, batch), walks
// the chunks in reverse carrying its 64 columns of dC (K6's walk, with the
// roles of q and k swapped); dq and dk, one block per (D tile of 64 rows,
// head, batch) and direction, carry 64 rows of C (forward) or dC
// (reverse) with their slice of n or dn, so that dq and dk are whole in
// their block and need no sum over tiles; an epilogue, one block per
// (batch, head), sums the walks' per-tile partials of q . dq and k . dk in
// a fixed order and takes the reverse cumulative sum.  The walks take one
// of two paths, chosen by `repro_mlstm_scan_tensor_cores` (mlstm_scan.cu);
// the prologue and the epilogue are the same on both (0.13 ms of the
// backward at the training shape):
//
// The tensor-core path (bf16, D and DV multiples of 64 in [64, 384]):
// `mlstm_dv_tc_kernel`, `mlstm_dq_tc_kernel` and `mlstm_dk_tc_kernel`, one
// after the other, 192 blocks each at the training shape (a (head, batch)
// gets DV/64 dv blocks and D/64 dq and dk blocks), the walk of
// mlstm_tc.cuh in its DV, DQ and DK modes, each compiled for its number of
// 64-column panels (D/64 for dv, DV/64 for dq and dk): chunks of 64 rows,
// every product on wgmma, the block's slice of the state in float32
// registers, the operands streamed by TMA; dS = dO v^T + dqn and its
// product with W in float32, going to the tensor cores (like the state's
// copy and Z) as a hi/lo pair of bf16.  The partials of q . dq and k . dk
// come from the float32 accumulators before dq and dk are rounded.
//
// The FMA path (float32, and bf16 at other widths): `mlstm_dv_kernel` and
// `mlstm_dqdk_kernel`, float32 FMAs out of shared memory over chunks of 32
// rows.
//
// On both paths:
//   * the states are recomputed, not saved: the forward writes only each
//     row's m and qn (two floats), and every walk recomputes its chunk's
//     weights from the gates and the saved m at the chunk's start, with
//     the forward's own code, so they agree bit for bit;
//   * no atomics: every output is written by one thread, every sum runs in
//     a fixed order, so the result is the same bit for bit from run to run
//     (exact resume needs that).
#include "mlstm_common.cuh"
#include "mlstm_tc.cuh"

namespace {

using namespace repro::mlstm;
using repro::NEG_INF;

// rden = 1 / den and dqn per row (b, h, t), one warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_prep_kernel(const T* __restrict__ h, const T* __restrict__ dh,
                  const float* __restrict__ m, const float* __restrict__ qn,
                  float* __restrict__ rden, float* __restrict__ dqn, int rows,
                  int DV) {
    const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    float acc = 0.f;
    for (int d = lane * 8; d < DV; d += 32 * 8) {
        float a[8], b[8];
        repro::load8(h + (size_t)row * DV + d, a);
        repro::load8(dh + (size_t)row * DV + d, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += a[e] * b[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
        const float x = qn[row], floor_ = expf(-m[row]);
        const float den = fmaxf(fabsf(x), floor_);
        const float sgn = fabsf(x) > floor_
                              ? (x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f))
                              : 0.f;
        dqn[row] = -acc / den * sgn;
        rden[row] = 1.f / den;
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_dv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ dh, const float* __restrict__ ip,
                const float* __restrict__ fp, const float* __restrict__ m,
                const float* __restrict__ rden, T* __restrict__ dv, int S,
                int D, int DV, float scale) {
    extern __shared__ float4 smem4[];
    vtile_walk<T, true>(reinterpret_cast<float*>(smem4), q, k, dh, ip, fp, m,
                        rden, dv, nullptr, nullptr, FinalState{}, S, D,
                        DV, scale);
}

// The dq walk (blockIdx.x < ntd: forward, carrying C' rows [d0, d0 + 64))
// and the dk walk (the next ntd blocks: reverse, carrying dC' rows).
// Each also writes its tile's part of q . dq (dq walk) or k . dk (dk walk)
// for every row, at [row * ntd + tile].
template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_dqdk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dh,
                  const float* __restrict__ ip, const float* __restrict__ fp,
                  const float* __restrict__ m, const float* __restrict__ rden,
                  const float* __restrict__ dqn, T* __restrict__ dq,
                  T* __restrict__ dk, float* __restrict__ qdq,
                  float* __restrict__ kdk, int S, int D, int DV, float scale,
                  int ntd) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int DVP = DV + 4, TP = TILE + 4;
    float* Cs = smem;              // TILE x DVP: rows of C (dq) or dC (dk)
    float* ns = Cs + TILE * DVP;   // TILE: n or dn
    float* Vs = ns + TILE;         // L x DVP: v rows
    float* Os = Vs + L * DVP;      // L x DVP: dO rows
    float* Zs = Os + L * DVP;      // L x TP: k tile (dq) or q tile (dk)
    float* Ws = Zs + L * TP;       // L x TP: q tile (dq) or k tile (dk)
    float* Ps = Ws + L * TP;       // L x (L + 1): dS * W
    Gates g(Ps + L * (L + 1));

    const int tid = threadIdx.x, warp = tid >> 5;
    const bool rev = blockIdx.x >= ntd;
    const int td = rev ? blockIdx.x - ntd : blockIdx.x;
    const int d0 = td * TILE;
    const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
    const T* qb = q + bh * S * D;
    const T* kb = k + bh * S * D;
    const T* vb = v + bh * S * DV;
    const T* gb = dh + bh * S * DV;
    const float* ib = ip + bh * S;
    const float* fb = fp + bh * S;
    const float* rb = rden + bh * S;
    T* ob = (rev ? dk : dq) + bh * S * D;
    float* part = (rev ? kdk : qdq) + bh * S * ntd;

    for (int i = tid; i < TILE * DVP; i += THREADS) Cs[i] = 0.f;
    for (int i = tid; i < TILE; i += THREADS) ns[i] = 0.f;

    const int nchunks = (S + L - 1) / L;
    const int t = tid >> 3, dg = tid & 7;  // output row, row group
    for (int ci = 0; ci < nchunks; ++ci) {
        const int c = rev ? nchunks - 1 - ci : ci;
        const int c0 = c * L;
        __syncthreads();  // the previous chunk's reads are done
        stage(Vs, DVP, vb, DV, S, c0, 0, DV, 1.f, nullptr);
        stage(Os, DVP, gb, DV, S, c0, 0, DV, 1.f, rb);
        stage(Zs, TP, rev ? qb : kb, D, S, c0, d0, TILE, rev ? scale : 1.f,
              nullptr);
        stage(Ws, TP, rev ? kb : qb, D, S, c0, d0, TILE, rev ? 1.f : scale,
              nullptr);
        if (warp == 0) {
            const float m_prev = c0 ? m[bh * S + c0 - 1] : NEG_INF;
            chunk_gates(ib, fb, c0, S, m_prev, g);
            const int lane = tid & 31;
            g.row[lane] = c0 + lane < S ? dqn[bh * S + c0 + lane] : 0.f;
        }
        __syncthreads();

        // P[r, j] = (dO_r . v_j + dqn_r) W[r, j] for j <= r
        {
            float acc[4];
            pair_dots(Os, Vs, DVP, DV, acc);
            const int r = tid >> 3, cg = tid & 7;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const int j = cg + 8 * cc;
                Ps[r * (L + 1) + j] =
                    j <= r ? (acc[cc] + g.row[r]) * g.w(r, j) : 0.f;
            }
        }
        __syncthreads();

        // row t, tile rows dg + 8 i:
        //   dq  iw_t (C dO_t + n dqn_t) + sum_j P[t, j] k_j
        //   dk  wk_t (dC v_t + dn) + sum_r P[r, t] q_r
        float inter[8], intra[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) inter[i] = intra[i] = 0.f;
        const float* xrow = (rev ? Vs : Os) + t * DVP;
        for (int vv = 0; vv < DV; vv += 4) {
            const float4 x = ld4(xrow + vv);
#pragma unroll
            for (int i = 0; i < 8; ++i)
                inter[i] += dot4(ld4(Cs + (dg + 8 * i) * DVP + vv), x);
        }
        for (int j = 0; j < L; ++j) {
            const float p = rev ? Ps[j * (L + 1) + t] : Ps[t * (L + 1) + j];
#pragma unroll
            for (int i = 0; i < 8; ++i) intra[i] += p * Zs[j * TP + dg + 8 * i];
        }
        const float coef = rev ? g.wk[t] : g.iw[t];
        const float nmul = rev ? 1.f : g.row[t];
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int dl = dg + 8 * i;
            const float val = coef * (inter[i] + ns[dl] * nmul) + intra[i];
            dot += Ws[t * TP + dl] * val;
            if (c0 + t < S && d0 + dl < D)
                repro::store(ob + (size_t)(c0 + t) * D + d0 + dl,
                             rev ? val : val * scale);
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (dg == 0 && c0 + t < S) part[(size_t)(c0 + t) * ntd + td] = dot;
        __syncthreads();  // every read of C, n and Z done

        // the update's left operand in place: dq k * wk, dk q * iw
        const float* zcoef = rev ? g.iw : g.wk;
        for (int i = tid; i < L * TILE; i += THREADS) {
            const int r = i / TILE, d = i - r * TILE;
            Zs[r * TP + d] *= zcoef[r];
        }
        __syncthreads();
        // C[d, :] = c_decay C[d, :] + sum_r Z[r, d] U[r, :]  (U: v or dO)
        const float c_decay = g.sc[0];
        const float* Us = rev ? Os : Vs;
        for (int d = tid >> 3; d < TILE; d += THREADS / 8) {
            for (int vv = 4 * (tid & 7); vv < DV; vv += 32) {
                float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
                for (int r = 0; r < L; ++r)
                    fma4(acc, Zs[r * TP + d], ld4(Us + r * DVP + vv));
                float* cp = Cs + d * DVP + vv;
                float4 cv = ld4(cp);
                cv.x = c_decay * cv.x + acc.x;
                cv.y = c_decay * cv.y + acc.y;
                cv.z = c_decay * cv.z + acc.z;
                cv.w = c_decay * cv.w + acc.w;
                st4(cp, cv);
            }
        }
        for (int d = tid; d < TILE; d += THREADS) {
            float acc = 0.f;
            for (int r = 0; r < L; ++r)
                acc += rev ? Zs[r * TP + d] * g.row[r] : Zs[r * TP + d];
            ns[d] = c_decay * ns[d] + acc;
        }
    }
}

// d i_pre = k . dk and d f_pre = (reverse cumsum of q . dq - k . dk) *
// sigmoid(-f_pre), one block per (batch, head): each thread takes a
// contiguous segment of rows; segment sums, their suffix sums (one thread,
// in order), then each segment walked backwards.
__global__ void __launch_bounds__(THREADS)
mlstm_gates_kernel(const float* __restrict__ fp, const float* __restrict__ qdq,
                   const float* __restrict__ kdk, float* __restrict__ di,
                   float* __restrict__ df, int S, int ntd) {
    __shared__ float tot[THREADS];
    const int tid = threadIdx.x;
    const size_t bh = blockIdx.x;
    const int seg = (S + THREADS - 1) / THREADS;
    const int lo = min(S, tid * seg), hi = min(S, lo + seg);
    const float* qb = qdq + bh * S * ntd;
    const float* kb = kdk + bh * S * ntd;
    float sum = 0.f;
    for (int t = hi - 1; t >= lo; --t) {
        float a = 0.f, b = 0.f;
        for (int i = 0; i < ntd; ++i) {
            a += qb[(size_t)t * ntd + i];
            b += kb[(size_t)t * ntd + i];
        }
        sum += a - b;
    }
    tot[tid] = sum;
    __syncthreads();
    if (tid == 0) {  // tot[i] = the sum of the segments after i
        float run = 0.f;
        for (int i = THREADS - 1; i >= 0; --i) {
            const float x = tot[i];
            tot[i] = run;
            run += x;
        }
    }
    __syncthreads();
    float acc = tot[tid];
    for (int t = hi - 1; t >= lo; --t) {
        float a = 0.f, b = 0.f;
        for (int i = 0; i < ntd; ++i) {
            a += qb[(size_t)t * ntd + i];
            b += kb[(size_t)t * ntd + i];
        }
        acc += a - b;
        di[bh * S + t] = b;
        df[bh * S + t] = acc / (1.f + expf(fp[bh * S + t]));
    }
}

// the tensor-core walks, one kernel each (a dq walk beside a dk walk on
// the card ran its chunks 1.6x slower than beside another dq walk), each
// over P panels: dv one block per DV tile, dq and dk one per D tile
template <int P>
__global__ void __launch_bounds__(tc::THREADS, 1)
mlstm_dv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mdh,
                   const tc::Params p) {
    extern __shared__ __align__(16) uint8_t tc_smem[];
    tc::walk<tc::DV, P>(tc_smem, &mk, &mq, &mdh, p, blockIdx.x);
}

template <int P>
__global__ void __launch_bounds__(tc::THREADS, 1)
mlstm_dq_tc_kernel(const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mdh,
                   const tc::Params p) {
    extern __shared__ __align__(16) uint8_t tc_smem[];
    tc::walk<tc::DQ, P>(tc_smem, &mdh, &mv, &mk, p, blockIdx.x);
}

template <int P>
__global__ void __launch_bounds__(tc::THREADS, 1)
mlstm_dk_tc_kernel(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mdh,
                   const tc::Params p) {
    extern __shared__ __align__(16) uint8_t tc_smem[];
    tc::walk<tc::DK, P>(tc_smem, &mv, &mdh, &mq, p, blockIdx.x);
}

// one walk's launch: `kern` over (tiles, H, B) with three tensor maps
template <typename Kernel>
cudaError_t launch_walk(Kernel kern, const CUtensorMap& m0,
                        const CUtensorMap& m1, const CUtensorMap& m2,
                        const tc::Params& p, int tiles, int H, int B,
                        cudaStream_t stream) {
    kern<<<dim3(tiles, H, B), tc::THREADS, tc::SMEM, stream>>>(m0, m1, m2, p);
    return cudaGetLastError();
}

// the three walks at P panels for dv (P = D / 64) or for dq and dk (P =
// DV / 64): `which` 0 launches dv, 1 dq and dk
template <int P>
cudaError_t launch_walks_p(int which, const CUtensorMap& mq,
                           const CUtensorMap& mk, const CUtensorMap& mv,
                           const CUtensorMap& mdh, const tc::Params& pdv,
                           const tc::Params& pdq, const tc::Params& pdk,
                           int B, int H, int D, int DV, cudaStream_t stream) {
    const cudaError_t attr[3] = {
        repro::allow_smem<mlstm_dv_tc_kernel<P>>(tc::SMEM),
        repro::allow_smem<mlstm_dq_tc_kernel<P>>(tc::SMEM),
        repro::allow_smem<mlstm_dk_tc_kernel<P>>(tc::SMEM)};
    for (const cudaError_t e : attr)
        if (e != cudaSuccess) return e;
    if (which == 0)
        return launch_walk(mlstm_dv_tc_kernel<P>, mq, mk, mdh, pdv, DV / 64,
                           H, B, stream);
    cudaError_t err = launch_walk(mlstm_dq_tc_kernel<P>, mk, mv, mdh, pdq,
                                  D / 64, H, B, stream);
    if (err != cudaSuccess) return err;
    return launch_walk(mlstm_dk_tc_kernel<P>, mq, mv, mdh, pdk, D / 64, H, B,
                       stream);
}

cudaError_t launch_walks(int which, int P, const CUtensorMap& mq,
                         const CUtensorMap& mk, const CUtensorMap& mv,
                         const CUtensorMap& mdh, const tc::Params& pdv,
                         const tc::Params& pdq, const tc::Params& pdk, int B,
                         int H, int D, int DV, cudaStream_t stream) {
    switch (P) {
        case 1: return launch_walks_p<1>(which, mq, mk, mv, mdh, pdv, pdq,
                                         pdk, B, H, D, DV, stream);
        case 2: return launch_walks_p<2>(which, mq, mk, mv, mdh, pdv, pdq,
                                         pdk, B, H, D, DV, stream);
        case 3: return launch_walks_p<3>(which, mq, mk, mv, mdh, pdv, pdq,
                                         pdk, B, H, D, DV, stream);
        case 4: return launch_walks_p<4>(which, mq, mk, mv, mdh, pdv, pdq,
                                         pdk, B, H, D, DV, stream);
        case 5: return launch_walks_p<5>(which, mq, mk, mv, mdh, pdv, pdq,
                                         pdk, B, H, D, DV, stream);
        default: return launch_walks_p<6>(which, mq, mk, mv, mdh, pdv, pdq,
                                          pdk, B, H, D, DV, stream);
    }
}

cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* ip, const float* fp, const void* h,
                      const float* m, const float* qn, const void* dh,
                      float* rden, float* dqn, float* qdq, float* kdk,
                      void* dq, void* dk, void* dv, float* di, float* df,
                      int B, int H, int S, int D, int DV, float scale,
                      cudaStream_t stream) {
    using repro::hopper::make_map_bf16_rows;
    using bf16 = __nv_bfloat16;
    CUtensorMap mq, mk, mv, mdh;
    cudaError_t err = make_map_bf16_rows(&mq, q, B, H, S, D, tc::L);
    if (err == cudaSuccess) err = make_map_bf16_rows(&mk, k, B, H, S, D, tc::L);
    if (err == cudaSuccess) err = make_map_bf16_rows(&mv, v, B, H, S, DV, tc::L);
    if (err == cudaSuccess)
        err = make_map_bf16_rows(&mdh, dh, B, H, S, DV, tc::L);
    if (err != cudaSuccess) return err;
    const int rows = B * H * S;
    mlstm_prep_kernel<bf16><<<(rows + THREADS / 32 - 1) / (THREADS / 32),
                              THREADS, 0, stream>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(dh), m, qn,
        rden, dqn, rows, DV);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int ntd = D / 64;
    const tc::Params base{ip, fp, m, rden, dqn, nullptr, nullptr, nullptr,
                          nullptr, nullptr, S, 0, ntd, scale};
    tc::Params pdv = base, pdq = base, pdk = base;
    pdv.out = static_cast<bf16*>(dv);
    pdv.Wout = DV;
    pdq.out = static_cast<bf16*>(dq);
    pdq.part = qdq;
    pdq.u = static_cast<const bf16*>(q);
    pdq.Wout = D;
    pdk.out = static_cast<bf16*>(dk);
    pdk.part = kdk;
    pdk.u = static_cast<const bf16*>(k);
    pdk.Wout = D;
    // dv over q's and k's D / 64 panels, then dq and dk over dh's and v's
    // DV / 64
    err = launch_walks(0, D / 64, mq, mk, mv, mdh, pdv, pdq, pdk, B, H, D, DV,
                       stream);
    if (err != cudaSuccess) return err;
    err = launch_walks(1, DV / 64, mq, mk, mv, mdh, pdv, pdq, pdk, B, H, D,
                       DV, stream);
    if (err != cudaSuccess) return err;
    mlstm_gates_kernel<<<B * H, THREADS, 0, stream>>>(fp, qdq, kdk, di, df, S,
                                                     ntd);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ip, const float* fp, const void* h,
                   const float* m, const float* qn, const void* dh,
                   float* rden, float* dqn, float* qdq, float* kdk, void* dq,
                   void* dk, void* dv, float* di, float* df, int B, int H,
                   int S, int D, int DV, float scale, cudaStream_t stream) {
    auto dvk = mlstm_dv_kernel<T>;
    auto dqdk = mlstm_dqdk_kernel<T>;
    // allow the largest layouts
    cudaError_t attr = repro::allow_smem<mlstm_dv_kernel<T>>(
        (int)(sizeof(float) * vtile_floats(MAXDIM)));
    if (attr == cudaSuccess)
        attr = repro::allow_smem<mlstm_dqdk_kernel<T>>(
            (int)(sizeof(float) * dtile_floats(MAXDIM)));
    if (attr != cudaSuccess) return attr;
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const T* dht = static_cast<const T*>(dh);
    const int rows = B * H * S;
    mlstm_prep_kernel<T><<<(rows + THREADS / 32 - 1) / (THREADS / 32),
                           THREADS, 0, stream>>>(
        static_cast<const T*>(h), dht, m, qn, rden, dqn, rows, DV);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dvk<<<dim3((DV + TILE - 1) / TILE, H, B), THREADS,
          sizeof(float) * vtile_floats(D), stream>>>(
        qt, kt, dht, ip, fp, m, rden, static_cast<T*>(dv), S, D, DV, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int ntd = (D + TILE - 1) / TILE;
    dqdk<<<dim3(2 * ntd, H, B), THREADS, sizeof(float) * dtile_floats(DV),
           stream>>>(qt, kt, vt, dht, ip, fp, m, rden, dqn,
                     static_cast<T*>(dq), static_cast<T*>(dk), qdq, kdk, S, D,
                     DV, scale, ntd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    mlstm_gates_kernel<<<B * H, THREADS, 0, stream>>>(fp, qdq, kdk, di, df, S,
                                                     ntd);
    return cudaGetLastError();
}

}  // namespace

// the path rule, mlstm_scan.cu's (the kernels link into one library)
extern "C" int repro_mlstm_scan_tensor_cores(int D, int DV, int dtype);

// Bytes of dynamic shared memory the larger of K6-bwd's FMA walks needs.
extern "C" int repro_mlstm_scan_bwd_smem(int D, int DV) {
    const int a = vtile_floats(D), b = dtile_floats(DV);
    return (int)(sizeof(float) * (a > b ? a : b));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, h, dh, dq, dk, dv); gates,
// m, qn, di, df float32.  Scratch (float32): rden and dqn (B, H, S), qdq
// and kdk (B, H, S, ceil(D / 64)).  scale = D^-0.5.  *tensor_cores (host
// memory) gets 1 when the tensor-core walks were launched, 0 when the FMA
// walks were.  Returns a cudaError_t.
extern "C" int repro_mlstm_scan_bwd(
        const void* q, const void* k, const void* v, const float* ip,
        const float* fp, const void* h, const float* m, const float* qn,
        const void* dh, float* rden, float* dqn, float* qdq, float* kdk,
        void* dq, void* dk, void* dv, float* di, float* df, int B, int H,
        int S, int D, int DV, float scale, int dtype, void* stream,
        int* tensor_cores) {
    if (B < 1 || H < 1 || S < 1 || D < 8 || D > MAXDIM || D % 8 != 0 ||
        DV < 8 || DV > MAXDIM || DV % 8 != 0 || (dtype != 0 && dtype != 1) ||
        tensor_cores == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    *tensor_cores = repro_mlstm_scan_tensor_cores(D, DV, dtype);
    if (*tensor_cores)
        return (int)launch_tc(q, k, v, ip, fp, h, m, qn, dh, rden, dqn, qdq,
                              kdk, dq, dk, dv, di, df, B, H, S, D, DV, scale,
                              st);
    if (dtype == 0)
        return (int)launch<float>(q, k, v, ip, fp, h, m, qn, dh, rden, dqn,
                                  qdq, kdk, dq, dk, dv, di, df, B, H, S, D,
                                  DV, scale, st);
    return (int)launch<__nv_bfloat16>(q, k, v, ip, fp, h, m, qn, dh, rden, dqn,
                                      qdq, kdk, dq, dk, dv, di, df, B, H, S,
                                      D, DV, scale, st);
}
