// Helpers shared by the port's kernels: the attention mask, element-type
// conversion to and from float32, 16-byte vector loads of 8 elements, and
// on the host the one-time shared-memory allowance of a kernel and the
// steps a C entry reports when a launch fails.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace repro {

constexpr float NEG_INF = -1e30f;  // masked score, as in the reference
constexpr float LOG2E = 1.4426950408889634f;

// whether query position qpos sees key position kpos under the masks
__device__ __forceinline__ bool live(int qpos, int kpos, int Tlen, int causal,
                                     int window) {
    bool ok = kpos < Tlen;
    if (causal) ok = ok && qpos >= kpos;
    if (window > 0) ok = ok && qpos - kpos < window;
    return ok;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

// 8 consecutive elements at p (16-byte aligned for bf16, 32 for float32)
// into out[0..7] as float32
__device__ __forceinline__ void load8(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void zero8(float* out) {
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = 0.f;
}

// --- host ---------------------------------------------------------------
// The step of a launch that failed, as a C entry with a `failed_step` out
// parameter reports it.
enum LaunchStep : int {
    STEP_NONE = 0,
    STEP_ATTRIBUTE = 1,   // cudaFuncSetAttribute (the shared-memory allowance)
    STEP_TENSOR_MAP = 2,  // encoding a TMA tensor map
    STEP_LAUNCH = 3,      // a kernel launch
};

// Allow kernel K `bytes` of dynamic shared memory.  Only a success is
// remembered (the largest allowance so far, per kernel): a failed call is
// made again at the next launch instead of failing every later launch of
// the process, and once allowed no call is made, so that launches can be
// captured in a CUDA graph.
template <auto K>
cudaError_t allow_smem(int bytes) {
    static std::atomic<int> allowed{0};
    if (bytes <= allowed.load(std::memory_order_acquire)) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        K, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
        int seen = allowed.load(std::memory_order_relaxed);
        while (seen < bytes && !allowed.compare_exchange_weak(seen, bytes)) {
        }
    }
    return err;
}

}  // namespace repro
