// Shared pieces of K5 (csrc/ssm_scan.cu) and K5-bwd (csrc/ssm_scan_bwd.cu):
// the selective scan
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t + D x_t
// mapped one thread per (channel, state n): a block of 256 threads holds
// CPB = 16 channels of N = 16 states, the 16 lanes of a channel sit side
// by side in one warp (sums over n are 16-lane shuffles), and the block
// walks the sequence in chunks of CHUNK steps staged in shared memory.
#pragma once

#include "common.cuh"

namespace repro {
namespace ssm {

constexpr int THREADS = 256;
constexpr int NS = 16;             // the state size N the kernels take
constexpr int CPB = THREADS / NS;  // channels a block
constexpr int CHUNK = 32;          // steps a chunk; the checkpoint interval
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// One step of the recurrence for one (channel, n): the same expression in
// the forward and in the backward's recomputation, so both give the same
// states.
__device__ __forceinline__ float decay(float dtv, float a_cn) {
    return expf(dtv * a_cn);
}
__device__ __forceinline__ float advance(float h, float a, float dtv,
                                         float xv, float bv) {
    return a * h + (dtv * xv) * bv;
}

// Sum of v over the NS lanes of a channel (a butterfly: every lane gets
// the sum, in the same order).
__device__ __forceinline__ float sum_states(float v) {
#pragma unroll
    for (int off = NS / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Sum of v over the channels that share a warp (lanes n, n + NS, ...).
__device__ __forceinline__ float sum_warp_channels(float v) {
#pragma unroll
    for (int off = NS; off < 32; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Stage rows [t0, t0 + len) of a (B, S, W) tensor's columns [w0, w0 + P)
// into dst[CHUNK][P] as float32, coalesced along W; rows past len and
// columns past W are zero.
template <typename T, int P>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int S, int W, int t0, int len,
                                      int w0) {
    for (int i = threadIdx.x; i < CHUNK * P; i += THREADS) {
        const int t = i / P, j = i % P;
        float v = 0.f;
        if (t < len && w0 + j < W)
            v = to_f(src[((size_t)b * S + t0 + t) * W + w0 + j]);
        dst[i] = v;
    }
}

}  // namespace ssm
}  // namespace repro
