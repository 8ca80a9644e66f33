// Building blocks of the port's Hopper (sm_90a) kernels that run on the
// tensor cores: `wgmma` (bf16 inputs, float32 sums) with its shared-memory
// matrix descriptors for 128-byte-swizzled tiles, `mbarrier` waits and
// arrivals, TMA tile loads and stores (with their bulk-group waits, the
// proxy fence and named barriers a store needs), the register hand-over
// between a producer and its consumer warpgroups, and the host-side
// encoding of a tensor map.
// Raw PTX through inline asm; nothing is linked beyond the CUDA runtime.
// The wgmma forms: m64n64k16 and m64n128k16 with A from shared memory (SS)
// or registers (RS), and m64n256k16 SS (K4's 64 x 256 warpgroup tile), each
// with the trans-b bit as a template argument; m64n64k16 SS also with the
// trans-a bit.  K1, K1-bwd, K4, K6 and K6-bwd include this header.
//
// The tile layout every user of this header shares: a tile of R rows of a
// bf16 matrix with 64-column panels, each panel R rows of 128 bytes, as TMA
// writes a box of 64 x R elements with CU_TENSOR_MAP_SWIZZLE_128B (the
// 16-byte chunks of row r XOR-ed with r % 8).  Panels start on 1024-byte
// boundaries, so the swizzle's phase is 0 at every panel start.  Such a
// tile is read by `wgmma` in two ways:
//   * K-major (the contraction runs along a row): an operand of 64 rows
//     (A) or N rows (B, trans-b 0) starts at its first row; 8-row groups
//     lie 1024 bytes apart (the stride byte offset); the 16 columns of
//     one instruction are 32 bytes further per step inside a panel, and
//     the next panel starts the next 64 columns;
//   * MN-major (trans-b 1: the contraction runs down the rows, the N
//     columns along a row): 16 rows a step, 2048 bytes; 8-row groups 1024
//     bytes apart (stride byte offset); the next 64 columns of N one
//     panel further (leading byte offset = the panel's size).
#pragma once

// cuda.h for CUtensorMap and its enums only: the encoder comes through the
// runtime
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `p` rounded up to the next 1024-byte boundary (a swizzled tile's start)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// --- mbarriers --------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and to
// the other threads; follow with a __syncthreads()
__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more from asynchronous copies in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed.  A phase that
// never completes (a fault in the kernel's bookkeeping) traps after about
// 2^35 clocks (over 15 s), so the launch fails with an error the wrapper
// raises instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    long long start = 0;
    while (true) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
        if (done) return;
        if (start == 0) start = clock64();
        else if (clock64() - start > (1LL << 35)) __trap();
    }
}

// --- TMA --------------------------------------------------------------------
// one box of a 4-D tensor map into shared memory at `dst` (1024-byte
// aligned for the 128-byte swizzle); completion is counted in bytes on
// `bar`.  Elements outside the tensor arrive as zeros and still count.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// one box of shared memory at `src` (1024-byte aligned, laid out as a load
// of the same box would lay it) out to a 4-D tensor map; the elements
// outside the tensor are not written.  Asynchronous: commit with
// bulk_commit, and wait with bulk_wait_read before `src` is written again.
// The generic-proxy writes that filled `src` must be made visible to the
// copy first (fence_proxy_async, then a barrier of the writing threads).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
        "[%0, {%2, %3, %4, %5}], [%1];"
        :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// wait until at most N committed groups of stores still read their
// shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// wait until at most N committed groups of stores are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
    asm volatile("cp.async.bulk.wait_group %0;" :: "n"(N) : "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// asynchronous-proxy accesses (a TMA store, a wgmma read)
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// a barrier of `threads` threads (a multiple of 32) on hardware barrier
// `id` (1-15: 0 is __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// arrive at named barrier `id` without waiting: the producer's half of a
// hand-over whose consumers wait with named_barrier(id, threads)
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// byte offset of element (r, c) of a 64-column bf16 panel in the 128-byte
// swizzle (the 16-byte chunks of row r XOR-ed with r % 8), for threads
// that read or write such a tile themselves
__device__ __forceinline__ uint32_t sw128(int r, int c) {
    return (uint32_t)(r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1));
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
    asm volatile("prefetch.tensormap [%0];"
                 :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// --- warpgroup register hand-over -------------------------------------------
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(R));
}

// --- wgmma ------------------------------------------------------------------
// descriptor of a 128-byte-swizzled operand starting at `p` (shared
// memory); byte offsets as the header comment says
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4)
           | (uint64_t)((lbo >> 4) & 0x3FFF) << 16
           | (uint64_t)((sbo >> 4) & 0x3FFF) << 32
           | (uint64_t)1 << 62;
}

// K-major operand: 8-row groups 1024 bytes apart (the leading offset is
// not read under this swizzle)
__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
    return desc_sw128(p, 16, 1024);
}

// MN-major operand: 8-row groups 1024 bytes apart, 64-column panels
// `panel_bytes` apart
__device__ __forceinline__ uint64_t desc_mn_major(const void* p,
                                                  uint32_t panel_bytes) {
    return desc_sw128(p, panel_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (before the issue, after the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// two floats as a bf16 pair, `lo` in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The fragments, for thread t of a warpgroup (warp w = t / 32, lane l):
//   * a float32 accumulator of 64 x N holds N / 2 values: d[4 i + e] is
//     row 16 w + l / 4 + 8 (e / 2), column 8 i + 2 (l % 4) + (e % 2);
//   * a bf16 A operand of 64 x 16 in registers is 4 pairs: a[j] holds
//     row 16 w + l / 4 + 8 (j % 2), columns 8 (j / 2) + 2 (l % 4) + {0, 1}.
// So columns 16 s .. 16 s + 15 of an accumulator, rounded to bf16, are the
// A operand of step s: a[j] = pack(d[8 s + 2 j], d[8 s + 2 j + 1]).
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N],
                                         uint32_t (&a)[N / 8][4]) {
#pragma unroll
    for (int s = 0; s < N / 8; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            a[s][j] = pack_bf16(d[8 * s + 2 * j], d[8 * s + 2 * j + 1]);
}

// D (64 x 64, float32) += A (64 x 16) * B (16 x 64), A and B from shared
// memory through their descriptors.  TRANS_A 1 reads A MN-major (the M
// rows run along a row of the tile, the 16 k of a step down 16 of its
// rows), by the same layout rule as an MN-major B
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31 "
        "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B),
          "n"(TRANS_A));
}

// D (64 x 64, float32) += A (64 x 16, bf16 in registers) * B (16 x 64)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31 "
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d), "n"(TRANS_B));
}

// D (64 x 128, float32) += A (64 x 16) * B (16 x 128), A and B from shared
// memory through their descriptors
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63 "
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D (64 x 128, float32) += A (64 x 16, bf16 in registers) * B (16 x 128)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63 "
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
          "r"(scale_d), "n"(TRANS_B));
}

// D (64 x 256, float32) += A (64 x 16) * B (16 x 256), A and B from shared
// memory through their descriptors (an MN-major B spans four 64-column
// panels, a K-major B 256 rows)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
        "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
        "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
        "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
        "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
        "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127 "
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        :
          "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// --- host: tensor maps ------------------------------------------------------
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// A `cu*` function of libcuda, looked up through the runtime (the library
// is built by plain nvcc and loaded with ctypes: no -lcuda); nullptr if
// there is none.
static inline void* cu_entry(const char* name) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000,
                                                       cudaEnableDefault,
                                                       &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? p
               : nullptr;
}

// `name`'s entry point, kept in `cache` once found; a failed lookup is not
// kept, so it is tried again at the next call
static inline void* cached_entry(std::atomic<void*>& cache, const char* name) {
    void* p = cache.load(std::memory_order_acquire);
    if (p == nullptr) {
        p = cu_entry(name);
        if (p != nullptr) cache.store(p, std::memory_order_release);
    }
    return p;
}

static inline EncodeTiledFn encode_tiled() {
    static std::atomic<void*> fn{nullptr};
    return reinterpret_cast<EncodeTiledFn>(
        cached_entry(fn, "cuTensorMapEncodeTiled"));
}

// Make sure the calling thread has a current CUDA context before a `cu*`
// call that needs one (cuTensorMapEncodeTiled fails without one).  A
// thread whose CUDA work so far was PyTorch's may have none: autograd's
// device thread for the current device never calls cudaSetDevice, so a
// backward's first launch there found no context, and its tensor maps
// failed to encode.  Where there is none, the context of the device that
// holds `ptr` is made current; where there is one (any later launch on
// the thread, and under CUDA-graph capture) this is one cuCtxGetCurrent.
static inline cudaError_t ensure_context(const void* ptr) {
    using CtxGetCurrentFn = CUresult (*)(CUcontext*);
    static std::atomic<void*> fn{nullptr};
    const auto get = reinterpret_cast<CtxGetCurrentFn>(
        cached_entry(fn, "cuCtxGetCurrent"));
    CUcontext ctx = nullptr;
    if (get != nullptr && get(&ctx) == CUDA_SUCCESS && ctx != nullptr)
        return cudaSuccess;
    cudaPointerAttributes attr;
    const cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
    if (err != cudaSuccess) return err;
    return cudaSetDevice(attr.device);
}

// A contiguous bf16 tensor (n3, n2, n1, n0) — n0 innermost, 16-byte
// aligned, n0 a multiple of 8 — as a 4-D map read in boxes of 64 x box1 x
// box2 x 1 elements with the 128-byte swizzle.  Box elements past an edge
// arrive as zeros.
static inline cudaError_t make_map_bf16_box(CUtensorMap* map,
                                            const void* base, int n3,
                                            int n2, int n1, int n0,
                                            int box1, int box2) {
    const cudaError_t ctx = ensure_context(base);
    if (ctx != cudaSuccess) return ctx;
    const EncodeTiledFn enc = encode_tiled();
    if (enc == nullptr) return cudaErrorNotSupported;
    const cuuint64_t e = sizeof(__nv_bfloat16);
    const cuuint64_t dims[4] = {(cuuint64_t)n0, (cuuint64_t)n1,
                                (cuuint64_t)n2, (cuuint64_t)n3};
    const cuuint64_t strides[3] = {e * n0, e * n0 * n1, e * n0 * n1 * n2};
    const cuuint32_t box[4] = {64, (cuuint32_t)box1, (cuuint32_t)box2, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                           const_cast<void*>(base), dims, strides, box, step,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// boxes of 64 x 1 x `rows` x 1 (64 columns of `rows` along n2: the
// (B, S, H, D) layout read a tile of S at a time for one head); a box past
// the head dim or a ragged length reads zeros
static inline cudaError_t make_map_bf16(CUtensorMap* map, const void* base,
                                        int n3, int n2, int n1, int n0,
                                        int rows) {
    return make_map_bf16_box(map, base, n3, n2, n1, n0, 1, rows);
}

// boxes of 64 x `rows` x 1 x 1 (64 columns of `rows` along n1: the
// (B, H, S, W) layout read a chunk of S at a time); a box past a ragged
// length reads zeros
static inline cudaError_t make_map_bf16_rows(CUtensorMap* map,
                                             const void* base, int n3,
                                             int n2, int n1, int n0,
                                             int rows) {
    return make_map_bf16_box(map, base, n3, n2, n1, n0, rows, 1);
}

}  // namespace hopper
}  // namespace repro
