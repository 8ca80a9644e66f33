// Chunkwise mLSTM forward (K6) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `mlstm_scan_bhsd` of the reference package
// (src/repro/kernels/mlstm_scan.py, body `_mlstm_kernel`): the stabilised
// xLSTM matrix-memory recurrence
//   m_t = max(log f_t + m_{t-1}, log i_t),
//   C_t = e^{log f_t + m_{t-1} - m_t} C_{t-1} + e^{log i_t - m_t} k_t v_t^T,
//   n_t = (the same with k_t),
//   h_t = (q_t C_t) / max(|q_t . n_t|, e^{-m_t}) / sqrt(D),
// evaluated a chunk of L = 32 rows at a time: the pairs inside a chunk are
// a masked L x L product, the (C, n, m) carry crosses chunk boundaries.
// q, k (B, H, S, D) and v (B, H, S, DV) in float32 or bfloat16, the gate
// pre-activations (B, H, S) float32; h (B, H, S, DV) in the input type.
// For training it also writes each row's stabiliser m and normaliser qn
// (float32), what K6-bwd needs; serving-style callers pass none.
//
// What bounds it on the H100: at the training shape (B = 8, H = 4,
// S = 4096, D = DV = 384, bf16) it reads q, k, v and writes h, about
// 403 MB (0.12 ms at 3.35 TB/s), and its chunkwise products are
// 2 L (D + DV) + 4 D DV flops a row, 84 GFLOP (0.085 ms on the tensor
// cores).
// This first version uses no tensor cores: its products are float32 FMAs
// out of shared memory, far above that bound.  What the design does:
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

namespace {

using namespace repro::mlstm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
mlstm_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ ip,
                 const float* __restrict__ fp, T* __restrict__ h,
                 float* __restrict__ m_out, float* __restrict__ qn_out, int S,
                 int D, int DV, float scale) {
    extern __shared__ float4 smem4[];
    vtile_walk<T, false>(reinterpret_cast<float*>(smem4), q, k, v, ip, fp,
                         nullptr, nullptr, h, m_out, qn_out, S, D, DV, scale);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ip, const float* fp, void* h, float* m_out,
                   float* qn_out, int B, int H, int S, int D, int DV,
                   float scale, cudaStream_t stream) {
    auto kern = mlstm_fwd_kernel<T>;
    // allow the largest layout once (not per launch, so that launches can
    // be captured in a CUDA graph)
    static cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * vtile_floats(MAXDIM)));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((DV + TILE - 1) / TILE, H, B);
    kern<<<grid, THREADS, sizeof(float) * vtile_floats(D), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), ip, fp, static_cast<T*>(h), m_out, qn_out,
        S, D, DV, scale);
    return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory K6 needs at head dim D.
extern "C" int repro_mlstm_scan_smem(int D) {
    return (int)(sizeof(float) * vtile_floats(D));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, h); gates float32.  m_out and
// qn_out: both null, or (B, H, S) float32 each.  scale = D^-0.5.  Returns a
// cudaError_t.
extern "C" int repro_mlstm_scan(const void* q, const void* k, const void* v,
                                const float* ip, const float* fp, void* h,
                                float* m_out, float* qn_out, int B, int H,
                                int S, int D, int DV, float scale,
                                int dtype, void* stream) {
    if (B < 1 || H < 1 || S < 1 || D < 8 || D > MAXDIM || D % 8 != 0 ||
        DV < 8 || DV > MAXDIM || DV % 8 != 0 || (dtype != 0 && dtype != 1) ||
        (m_out == nullptr) != (qn_out == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch<float>(q, k, v, ip, fp, h, m_out, qn_out, B, H, S,
                                  D, DV, scale, st);
    return (int)launch<__nv_bfloat16>(q, k, v, ip, fp, h, m_out, qn_out, B, H,
                                      S, D, DV, scale, st);
}
