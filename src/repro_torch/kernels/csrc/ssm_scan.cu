// Selective-scan forward (K5) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `ssm_scan_bsd` of the reference package
// (src/repro/kernels/ssm_scan.py, body `_ssm_kernel`): the Mamba scan
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t + D x_t
// with x, dt (B, S, Din) in float32 or bfloat16, A (Din, N), B and C
// (B, S, N), D (Din,) float32, N = 16 (hymba's state); y (B, S, Din) in
// x's type.  It follows the reference's oracle (src/repro/kernels/ref.py,
// ssm_scan) in its rounding: D x is added in float32 before the one cast
// to x's type.  For training it
// also writes the float32 state at the start of every CHUNK-step chunk,
// (S / CHUNK, B, Din, N), which K5-bwd recomputes each chunk from (the
// reference's checkpointed adjoint, src/repro/kernels/ssm_vjp.py).
//
// What bounds it on the H100: at hymba-1.5b's training shape (B = 1,
// S = 4096, Din = 3200, N = 16, bf16) it reads x and dt (26 MB each) and B,
// C (0.5 MB), writes y (26 MB) and the checkpoints (26 MB at CHUNK = 32):
// about 0.03 ms at 3.35 TB/s.  It takes B S Din N = 210 M exponentials,
// which the special-function units (16 a clock an SM) need about 0.05 ms
// for: the bound is the exponentials.  What the design does:
//   * the TPU's sequential chunk axis is a loop inside the block; the grid
//     is (Din / 16 channel blocks, batch), 200 blocks of 256 threads at
//     hymba's shape, one thread per (channel, n), so the state
//     lives in registers for the whole walk (the TPU kernel keeps its
//     (block_d, N) slab in VMEM) and the card has 1600 warps in flight,
//     not the 100 a thread per channel would give;
//   * each chunk's x and dt rows for the block's channels, and its B and C
//     rows, are staged in shared memory with loads coalesced along the
//     channel axis; y is summed over n with 16-lane shuffles, collected in
//     shared memory and written back coalesced;
//   * a ragged S (the last chunk) and a ragged Din (the last block) are
//     masked in the kernel: masked channels compute on zeros and store
//     nothing, so the wrapper pads nothing;
//   * CHUNK = 32: the checkpoints cost 4 N Din B bytes a chunk (26 MB a
//     layer at hymba's shape), and K5-bwd keeps a chunk's 33 states per
//     thread in shared memory (34 KB a block), so 32 keeps two of its
//     blocks on an SM.
#include "ssm_common.cuh"

namespace {

using namespace repro::ssm;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ Dv,
               T* __restrict__ y, float* __restrict__ ckpt, int Bsz, int S,
               int Din) {
    __shared__ float sx[CHUNK * CPB], sdt[CHUNK * CPB], sy[CHUNK * CPB];
    __shared__ float sB[CHUNK * NS], sC[CHUNK * NS];
    const int tid = threadIdx.x;
    const int cl = tid / NS, n = tid % NS;
    const int c0 = blockIdx.x * CPB, c = c0 + cl;
    const int b = blockIdx.y;
    const bool valid = c < Din;
    const float a_cn = valid ? A[(size_t)c * NS + n] : 0.f;
    float h = 0.f;
    const int nc = (S + CHUNK - 1) / CHUNK;
    for (int k = 0; k < nc; ++k) {
        const int t0 = k * CHUNK;
        const int len = min(CHUNK, S - t0);
        if (ckpt != nullptr && valid)
            ckpt[(((size_t)k * Bsz + b) * Din + c) * NS + n] = h;
        stage<T, CPB>(sx, x, b, S, Din, t0, len, c0);
        stage<T, CPB>(sdt, dt, b, S, Din, t0, len, c0);
        stage<float, NS>(sB, Bm, b, S, NS, t0, len, 0);
        stage<float, NS>(sC, Cm, b, S, NS, t0, len, 0);
        __syncthreads();
        for (int t = 0; t < len; ++t) {
            const float dtv = sdt[t * CPB + cl];
            h = advance(h, decay(dtv, a_cn), dtv, sx[t * CPB + cl],
                        sB[t * NS + n]);
            const float p = sum_states(h * sC[t * NS + n]);
            if (n == 0) sy[t * CPB + cl] = p;
        }
        __syncthreads();
        for (int i = tid; i < len * CPB; i += THREADS) {
            const int t = i / CPB, j = i % CPB;
            if (c0 + j < Din)
                repro::store(&y[((size_t)b * S + t0 + t) * Din + c0 + j],
                             sy[i] + Dv[c0 + j] * sx[i]);
        }
        __syncthreads();  // the next chunk's staging overwrites sx
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* Bm, const float* Cm, const float* Dv, void* y,
                   float* ckpt, int Bsz, int S, int Din,
                   cudaStream_t stream) {
    const dim3 grid((Din + CPB - 1) / CPB, Bsz);
    ssm_fwd_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt), A, Bm, Cm, Dv,
        static_cast<T*>(y), ckpt, Bsz, S, Din);
    return cudaGetLastError();
}

}  // namespace

// The chunk length (steps between checkpoints) of K5 and K5-bwd.
extern "C" int repro_ssm_scan_chunk() { return CHUNK; }

// Channels a block of K5 and K5-bwd covers (the leading dimension of
// K5-bwd's dB/dC partials is ceil(Din / this)).
extern "C" int repro_ssm_scan_channels_per_block() { return CPB; }

// dtype: 0 = float32, 1 = bfloat16 (x, dt, y); A, B, C, D float32; N must
// be 16.  ckpt: null, or (ceil(S / CHUNK), B, Din, N) float32.  Returns a
// cudaError_t.
extern "C" int repro_ssm_scan(const void* x, const void* dt, const float* A,
                              const float* Bm, const float* Cm,
                              const float* Dv, void* y, float* ckpt, int B,
                              int S, int Din, int N, int dtype,
                              void* stream) {
    if (B < 1 || S < 1 || Din < 1 || N != NS || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch<float>(x, dt, A, Bm, Cm, Dv, y, ckpt, B, S, Din,
                                  st);
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, y, ckpt, B, S,
                                      Din, st);
}
