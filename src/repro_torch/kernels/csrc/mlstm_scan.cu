// Chunkwise mLSTM forward (K6) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `mlstm_scan_bhsd` of the reference package
// (src/repro/kernels/mlstm_scan.py, body `_mlstm_kernel`): the stabilised
// xLSTM matrix-memory recurrence
//   m_t = max(log f_t + m_{t-1}, log i_t),
//   C_t = e^{log f_t + m_{t-1} - m_t} C_{t-1} + e^{log i_t - m_t} k_t v_t^T,
//   n_t = (the same with k_t),
//   h_t = (q_t C_t) / max(|q_t . n_t|, e^{-m_t}) / sqrt(D),
// evaluated a chunk of rows at a time: the pairs inside a chunk are a
// masked square product, the (C, n, m) carry crosses chunk boundaries.
// q, k (B, H, S, D) and v (B, H, S, DV) in float32 or bfloat16, the gate
// pre-activations (B, H, S) float32; h (B, H, S, DV) in the input type.
// For training it also writes each row's stabiliser m and normaliser qn
// (float32), what K6-bwd needs.  For serving it can write the final
// float32 state instead, C (B, H, D, DV), n (B, H, D) and m (B, H), the
// state the xLSTM's prefill hands to decode (the reference gets it from
// its sequential oracle, src/repro/models/lm.py, _mlstm_prefill_layer):
// each block its DV tile of C as the walk leaves it, tile 0 n and the last
// row's m.  The chunkwise m is the oracle's (both are the max over j of
// log i_j plus the log forgets after j), so the state is the oracle's,
// not one rescaled by another stabiliser.
//
// What bounds it on the H100: at the training shape (B = 8, H = 4,
// S = 4096, D = DV = 384, bf16) it reads q, k, v and writes h, about
// 403 MB (0.12 ms at 3.35 TB/s), and its chunkwise products are
// 2 L (D + DV) + 4 D DV flops a row, 84 GFLOP at L = 32 (0.085 ms on the
// tensor cores).  Two paths, chosen by `repro_mlstm_scan_tensor_cores`:
//
// The tensor-core path (bf16, D and DV multiples of 64 in [64, 384]):
// `mlstm_fwd_tc_kernel<D / 64>`, the walk of mlstm_tc.cuh in its FWD
// mode.  One block per (DV tile of 64, head, batch), 192 blocks at the
// training shape; chunks of 64 rows (one wgmma M); every product on wgmma
// with float32 sums: per chunk q k^T and q C^T over D in panels of 64,
// P v, and the state's update C^T += (wk v)^T k, the state (the block's
// 64 columns of C, all D) kept in float32 registers of two consumer
// warpgroups (96 floats a thread at D = 384) and never rounded.  P, the
// state's copy (the operand of the next chunk's q C^T) and wk v go to the
// tensor cores as hi/lo pairs of bf16 (one bf16 rounding would not hold
// h to its bound where den is small).  q and k stream through a 3-stage
// TMA ring of 64-column panels across chunk boundaries, so the next
// chunk's loads overlap this chunk's products; a gate warp computes each
// chunk's gates and weights a chunk ahead of the consumers.  n and q . n,
// the row sums of P, the gates and the 1/sqrt(D) scale stay in float32,
// so the denominator is the float32 one.  64 DV columns a block (not 96,
// one wave of 128 blocks), because at 96 the state takes 144 registers a
// thread, over what a consumer can hold beside its accumulator; the 1.45
// waves at 64 are a known loss.  What bounds it at the training shape is
// the chunk walk's latency, not the card's rates: 64 chunks in sequence
// a block, each a chain of products, handovers between the warpgroups and
// the epilogue (PERF.md).
//
// The FMA path (float32, and bf16 at other widths): `mlstm_fwd_kernel`,
// float32 FMAs out of shared memory:
//   * the TPU's sequential chunk axis is a loop inside the block; the
//     grid is (DV tile of 64 columns, head, batch), 192 blocks at the
//     training shape;
//   * the TPU kernel holds the whole (D, DV) float32 state in VMEM, 576 KB
//     at D = DV = 384, over the 227 KB of a Hopper block: each block keeps
//     its (D, 64) slice of C (96 KB) in shared memory for the whole walk,
//     and recomputes the chunk's scores q k^T and the normaliser state n,
//     which every tile needs and which cost little beside C;
//   * the chunk is 32 rows, so that the q and k rows (float32, padded to
//     D + 4 for conflict-free 16-byte reads), the slice of C, the v tile
//     and the 32 x 32 scores fit in 212 KB at D = 384;
//   * a ragged S is masked in the kernel (input gate -> -inf, forget gate
//     keeps the state), which is what the reference's wrapper gets by
//     padding (src/repro/kernels/ops.py, mlstm_scan);
//   * warp 0 computes the chunk's cumulative log-forget, running max and
//     weights with warp shuffles; the other products are spread over the
//     block's 256 threads.
#include "mlstm_common.cuh"
#include "mlstm_tc.cuh"

namespace {

using namespace repro::mlstm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ip,
                 const float* __restrict__ fp, T* __restrict__ h,
                 float* __restrict__ m_out, float* __restrict__ qn_out,
                 FinalState fin, int S, int D, int DV, float scale) {
    extern __shared__ float4 smem4[];
    vtile_walk<T, false>(reinterpret_cast<float*>(smem4), q, k, v, ip, fp,
                         nullptr, nullptr, h, m_out, qn_out, fin, S, D, DV,
                         scale);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ip, const float* fp, void* h, float* m_out,
                   float* qn_out, FinalState fin, int B, int H, int S, int D,
                   int DV, float scale, cudaStream_t stream) {
    auto kern = mlstm_fwd_kernel<T>;
    // allow the largest layout
    const cudaError_t attr = repro::allow_smem<mlstm_fwd_kernel<T>>(
        (int)(sizeof(float) * vtile_floats(MAXDIM)));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((DV + TILE - 1) / TILE, H, B);
    kern<<<grid, THREADS, sizeof(float) * vtile_floats(D), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), ip, fp, static_cast<T*>(h), m_out, qn_out,
        fin, S, D, DV, scale);
    return cudaGetLastError();
}

template <int P>
__global__ void __launch_bounds__(tc::THREADS, 1)
mlstm_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                    const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const tc::Params p) {
    extern __shared__ __align__(16) uint8_t tc_smem[];
    tc::walk<tc::FWD, P>(tc_smem, &mq, &mk, &mv, p, blockIdx.x);
}

template <int P>
cudaError_t launch_tc_p(const CUtensorMap& mq, const CUtensorMap& mk,
                        const CUtensorMap& mv, const tc::Params& p, int B,
                        int H, int DV, cudaStream_t stream) {
    auto kern = mlstm_fwd_tc_kernel<P>;
    const cudaError_t attr =
        repro::allow_smem<mlstm_fwd_tc_kernel<P>>(tc::SMEM);
    if (attr != cudaSuccess) return attr;
    kern<<<dim3(DV / 64, H, B), tc::THREADS, tc::SMEM, stream>>>(mq, mk, mv,
                                                                 p);
    return cudaGetLastError();
}

cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* ip, const float* fp, void* h,
                      float* m_out, float* qn_out, FinalState fin, int B,
                      int H, int S, int D, int DV, float scale,
                      cudaStream_t stream) {
    using repro::hopper::make_map_bf16_rows;
    CUtensorMap mq, mk, mv;
    cudaError_t err = make_map_bf16_rows(&mq, q, B, H, S, D, tc::L);
    if (err == cudaSuccess) err = make_map_bf16_rows(&mk, k, B, H, S, D, tc::L);
    if (err == cudaSuccess) err = make_map_bf16_rows(&mv, v, B, H, S, DV, tc::L);
    if (err != cudaSuccess) return err;
    const tc::Params p{ip, fp, nullptr, nullptr, nullptr,
                       static_cast<__nv_bfloat16*>(h), m_out, qn_out,
                       nullptr, nullptr, S, DV, 0, scale, fin};
    switch (D / 64) {  // the panels of q and k: the walk's P
        case 1: return launch_tc_p<1>(mq, mk, mv, p, B, H, DV, stream);
        case 2: return launch_tc_p<2>(mq, mk, mv, p, B, H, DV, stream);
        case 3: return launch_tc_p<3>(mq, mk, mv, p, B, H, DV, stream);
        case 4: return launch_tc_p<4>(mq, mk, mv, p, B, H, DV, stream);
        case 5: return launch_tc_p<5>(mq, mk, mv, p, B, H, DV, stream);
        default: return launch_tc_p<6>(mq, mk, mv, p, B, H, DV, stream);
    }
}

}  // namespace

// 1 when K6 and K6-bwd run on the tensor cores: bf16 with D and DV
// multiples of 64 in [64, 384]; float32 and other widths take the FMA
// kernels.
extern "C" int repro_mlstm_scan_tensor_cores(int D, int DV, int dtype) {
    return dtype == 1 && D % 64 == 0 && DV % 64 == 0 && D >= 64 &&
           D <= MAXDIM && DV >= 64 && DV <= MAXDIM;
}

// Bytes of dynamic shared memory K6's FMA kernel needs at head dim D.
extern "C" int repro_mlstm_scan_smem(int D) {
    return (int)(sizeof(float) * vtile_floats(D));
}

// Bytes of dynamic shared memory of the tensor-core walks (K6's and
// K6-bwd's, any width the rule takes).
extern "C" int repro_mlstm_scan_tc_smem() { return tc::SMEM; }

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, h); gates float32.  m_out and
// qn_out: both null, or (B, H, S) float32 each.  c_fin, n_fin, m_fin: all
// null, or the final state C (B, H, D, DV), n (B, H, D) and m (B, H),
// float32.  scale = D^-0.5.
// *tensor_cores (host memory) gets 1 when the tensor-core kernel was
// launched, 0 when the FMA kernel was.  Returns a cudaError_t.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const float* ip, const float* fp, void* h,
                                float* m_out, float* qn_out, float* c_fin,
                                float* n_fin, float* m_fin, int B, int H,
                                int S, int D, int DV, float scale,
                                int dtype, void* stream, int* tensor_cores) {
    if (B < 1 || H < 1 || S < 1 || D < 8 || D > MAXDIM || D % 8 != 0 ||
        DV < 8 || DV > MAXDIM || DV % 8 != 0 || (dtype != 0 && dtype != 1) ||
        (m_out == nullptr) != (qn_out == nullptr) ||
        (c_fin == nullptr) != (n_fin == nullptr) ||
        (c_fin == nullptr) != (m_fin == nullptr) || tensor_cores == nullptr)
        return (int)cudaErrorInvalidValue;
    const FinalState fin{c_fin, n_fin, m_fin};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    *tensor_cores = repro_mlstm_scan_tensor_cores(D, DV, dtype);
    if (*tensor_cores)
        return (int)launch_tc(q, k, v, ip, fp, h, m_out, qn_out, fin, B, H, S,
                              D, DV, scale, st);
    if (dtype == 0)
        return (int)launch<float>(q, k, v, ip, fp, h, m_out, qn_out, fin, B, H,
                                  S, D, DV, scale, st);
    return (int)launch<__nv_bfloat16>(q, k, v, ip, fp, h, m_out, qn_out, fin,
                                      B, H, S, D, DV, scale, st);
}
