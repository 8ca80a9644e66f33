// Selective-scan backward (K5-bwd) for Hopper (sm_90a), hand-written CUDA
// C++.
//
// The TPU path has no backward kernel for K5: the reference trains its scan
// either by autodiff through the oracle's lax.scan or, under the planner's
// optimised profile, through the checkpointed-adjoint custom VJP of
// src/repro/kernels/ssm_vjp.py (`_bwd_vjp`).  K5-bwd is that VJP: from the
// float32 state K5 saved at each chunk start, it walks the chunks in
// reverse, recomputes the chunk's states forward (it never inverts
// h_{t-1} = (h_t - u_t) / a_t: a_t can be tiny) and runs the adjoint
//   dh_t = dy_t C_t + a_{t+1} dh_{t+1},   da_t = dh_t h_{t-1},
// giving dx and ddt (B, S, Din) in x's type, and dB, dC (B, S, N), dA
// (Din, N), dD (Din,) in float32.
//
// What bounds it on the H100: at hymba-1.5b's training shape (B = 1,
// S = 4096, Din = 3200, N = 16, bf16) it reads x, dt and dy (26 MB each),
// B, C and the checkpoints (27 MB) and writes dx and ddt (26 MB each):
// about 0.05 ms at 3.35 TB/s.  The a_t it needs are B S Din N = 210 M
// exponentials, about 0.05 ms on the special-function units; this version
// takes each twice (the chunk's forward recomputation and the reverse
// walk).  What the design does:
//   * the map is K5's: one thread per (channel, n), 16 channels a block,
//     a grid of (channel blocks, batch); the block walks its chunks
//     in reverse, each thread keeping its chunk's 33 states in shared
//     memory (34 KB a block) and its dh, dA and dD sums in registers;
//   * dx and ddt are sums over n (16-lane shuffles), written coalesced from
//     shared memory after each chunk;
//   * dB and dC are sums over all Din channels: each warp sums its own
//     channels with shuffles into a per-warp row of shared memory, the
//     block adds its warps in order after each chunk and writes one
//     partial row per block, (channel blocks, B, S, N); an epilogue kernel
//     adds the blocks' partials in block order.  dA (a sum over the batch)
//     and dD (over batch and time) get per-batch partials the same way.
//     No atomics: two launches give the same bits;
//   * a ragged S and a ragged Din are masked as in K5.
#include "ssm_common.cuh"

namespace {

using namespace repro::ssm;

// Dynamic shared memory of the walk, in floats: the chunk's states
// ((CHUNK + 1) per thread), its x, dt, dy, dx and ddt rows for the block's
// channels, its B and C rows, and the warps' dB and dC rows (80.9 KB).
constexpr int BWD_FLOATS = (CHUNK + 1) * THREADS + 5 * CHUNK * CPB +
                           2 * CHUNK * NS + 2 * WARPS * CHUNK * NS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ ckpt, const T* __restrict__ dy,
               T* __restrict__ dx, T* __restrict__ ddt,
               float* __restrict__ part_dB, float* __restrict__ part_dC,
               float* __restrict__ part_dA, float* __restrict__ part_dD,
               int Bsz, int S, int Din) {
    extern __shared__ float4 smem4[];
    float* hs = reinterpret_cast<float*>(smem4);
    float* sx = hs + (CHUNK + 1) * THREADS;
    float* sdt = sx + CHUNK * CPB;
    float* sdy = sdt + CHUNK * CPB;
    float* sdx = sdy + CHUNK * CPB;
    float* sddt = sdx + CHUNK * CPB;
    float* sB = sddt + CHUNK * CPB;
    float* sC = sB + CHUNK * NS;
    float* wdB = sC + CHUNK * NS;      // [WARPS][CHUNK][NS]
    float* wdC = wdB + WARPS * CHUNK * NS;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int cl = tid / NS, n = tid % NS;
    const int c0 = blockIdx.x * CPB, c = c0 + cl;
    const int b = blockIdx.y;
    const bool valid = c < Din;
    const float a_cn = valid ? A[(size_t)c * NS + n] : 0.f;
    const float d_c = valid ? Dv[c] : 0.f;
    float dh = 0.f, dA_acc = 0.f, dD_acc = 0.f;
    const int nc = (S + CHUNK - 1) / CHUNK;
    for (int k = nc - 1; k >= 0; --k) {
        const int t0 = k * CHUNK;
        const int len = min(CHUNK, S - t0);
        stage<T, CPB>(sx, x, b, S, Din, t0, len, c0);
        stage<T, CPB>(sdt, dt, b, S, Din, t0, len, c0);
        stage<T, CPB>(sdy, dy, b, S, Din, t0, len, c0);
        stage<float, NS>(sB, Bm, b, S, NS, t0, len, 0);
        stage<float, NS>(sC, Cm, b, S, NS, t0, len, 0);
        __syncthreads();
        // the chunk's states, from its checkpoint: hs[t + 1] = h_t
        float h = valid ? ckpt[(((size_t)k * Bsz + b) * Din + c) * NS + n]
                        : 0.f;
        hs[tid] = h;
        for (int t = 0; t < len; ++t) {
            const float dtv = sdt[t * CPB + cl];
            h = advance(h, decay(dtv, a_cn), dtv, sx[t * CPB + cl],
                        sB[t * NS + n]);
            hs[(t + 1) * THREADS + tid] = h;
        }
        // the adjoint walk, in reverse (the order of ssm_vjp._bwd_vjp)
        for (int t = len - 1; t >= 0; --t) {
            const float h_t = hs[(t + 1) * THREADS + tid];
            const float h_prev = hs[t * THREADS + tid];
            const float dyv = sdy[t * CPB + cl];
            const float dtv = sdt[t * CPB + cl];
            const float xv = sx[t * CPB + cl];
            const float pc = sum_warp_channels(dyv * h_t);
            dh += dyv * sC[t * NS + n];
            const float a = decay(dtv, a_cn);
            const float da = dh * h_prev;
            dA_acc += da * dtv * a;
            const float ddt_t = sum_states(da * a_cn * a);
            const float ddtx = sum_states(dh * sB[t * NS + n]);
            const float pb = sum_warp_channels(dh * (dtv * xv));
            if (lane < NS) {
                wdC[(warp * CHUNK + t) * NS + n] = pc;
                wdB[(warp * CHUNK + t) * NS + n] = pb;
            }
            if (n == 0) {
                sdx[t * CPB + cl] = ddtx * dtv + dyv * d_c;
                sddt[t * CPB + cl] = ddt_t + ddtx * xv;
                dD_acc += dyv * xv;
            }
            dh = a * dh;
        }
        __syncthreads();
        for (int i = tid; i < len * CPB; i += THREADS) {
            const int t = i / CPB, j = i % CPB;
            if (c0 + j < Din) {
                const size_t off = ((size_t)b * S + t0 + t) * Din + c0 + j;
                repro::store(&dx[off], sdx[i]);
                repro::store(&ddt[off], sddt[i]);
            }
        }
        for (int i = tid; i < len * NS; i += THREADS) {
            float sb = 0.f, sc = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) {
                sb += wdB[w * CHUNK * NS + i];
                sc += wdC[w * CHUNK * NS + i];
            }
            const size_t off =
                (((size_t)blockIdx.x * Bsz + b) * S + t0) * NS + i;
            part_dB[off] = sb;
            part_dC[off] = sc;
        }
        __syncthreads();  // the next chunk's staging overwrites the rows
    }
    if (valid) {
        part_dA[((size_t)b * Din + c) * NS + n] = dA_acc;
        if (n == 0) part_dD[(size_t)b * Din + c] = dD_acc;
    }
}

// out[i] = sum over p < P, in order, of part[p * M + i].
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int P, size_t M) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= M) return;
    float s = 0.f;
    for (int p = 0; p < P; ++p) s += part[(size_t)p * M + i];
    out[i] = s;
}

cudaError_t sum_partials(const float* part, float* out, int P, size_t M,
                         cudaStream_t stream) {
    const int threads = 256;
    sum_partials_kernel<<<(unsigned)((M + threads - 1) / threads), threads, 0,
                          stream>>>(part, out, P, M);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* Bm, const float* Cm, const float* Dv,
                   const float* ckpt, const void* dy, void* dx, void* ddt,
                   float* part_dB, float* part_dC, float* part_dA,
                   float* part_dD, float* dB, float* dC, float* dA, float* dD,
                   int Bsz, int S, int Din, cudaStream_t stream) {
    constexpr int smem = (int)sizeof(float) * BWD_FLOATS;
    auto kern = ssm_bwd_kernel<T>;
    // set once (not per launch, so that launches can be captured in a CUDA
    // graph)
    static cudaError_t attr = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    const int blocks = (Din + CPB - 1) / CPB;
    kern<<<dim3(blocks, Bsz), THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt), A, Bm, Cm, Dv,
        ckpt, static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<T*>(ddt), part_dB, part_dC, part_dA, part_dD, Bsz, S, Din);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t rows = (size_t)Bsz * S * NS;
    if ((err = sum_partials(part_dB, dB, blocks, rows, stream)) != cudaSuccess)
        return err;
    if ((err = sum_partials(part_dC, dC, blocks, rows, stream)) != cudaSuccess)
        return err;
    if ((err = sum_partials(part_dA, dA, Bsz, (size_t)Din * NS, stream)) !=
        cudaSuccess)
        return err;
    return sum_partials(part_dD, dD, Bsz, (size_t)Din, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, dy, dx, ddt); everything else
// float32; N must be 16.  ckpt: K5's checkpoints, (ceil(S / CHUNK), B, Din,
// N).  Scratch: part_dB and part_dC (ceil(Din / 16), B, S, N), part_dA (B,
// Din, N), part_dD (B, Din).  Outputs dB, dC (B, S, N), dA (Din, N), dD
// (Din,).  Returns a cudaError_t.
extern "C" int repro_ssm_scan_bwd(
    const void* x, const void* dt, const float* A, const float* Bm,
    const float* Cm, const float* Dv, const float* ckpt, const void* dy,
    void* dx, void* ddt, float* part_dB, float* part_dC, float* part_dA,
    float* part_dD, float* dB, float* dC, float* dA, float* dD, int B, int S,
    int Din, int N, int dtype, void* stream) {
    if (B < 1 || S < 1 || Din < 1 || N != NS || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch<float>(x, dt, A, Bm, Cm, Dv, ckpt, dy, dx, ddt,
                                  part_dB, part_dC, part_dA, part_dD, dB, dC,
                                  dA, dD, B, S, Din, st);
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, ckpt, dy, dx, ddt,
                                      part_dB, part_dC, part_dA, part_dD, dB,
                                      dC, dA, dD, B, S, Din, st);
}
