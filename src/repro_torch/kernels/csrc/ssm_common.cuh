// Shared pieces of K5 (csrc/ssm_scan.cu) and K5-bwd (csrc/ssm_scan_bwd.cu):
// the selective scan
//   h_t = a_t h_{t-1} + b_t,   a_t = exp(dt_t A),   b_t = (dt_t x_t) B_t,
//   y_t = h_t . C_t + D x_t
// run as a scan over time.  The steps compose associatively as (a, b)
// pairs: (a1, b1) then (a2, b2) is (a1 a2, a2 b1 + b2).  The map:
//   * a warp owns one (batch, channel), a block NW channels of one batch
//     row, which share the B and C rows;
//   * lane l owns RUN consecutive steps of a pass of PASS = 32 RUN steps:
//     it composes its run's pairs in order, the warp scans the 32
//     composites with shuffles, and the lane walks its run again from the
//     state the scan hands it.  The thread loops over the N states, one
//     state in a register at a time, so N is a runtime value (1..MAX_N);
//     sums over n (y, and K5-bwd's dx and ddt) stay in the thread;
//   * a pass's per-channel rows (x, dt, dy, y, ...) sit in shared memory
//     as float32 in a [channel][PASS] tile laid out so that a lane reads or
//     writes its run with RUN / 4 16-byte accesses, consecutive lanes on
//     consecutive 16 bytes (`tile_at`).  They arrive by 16-byte cp.async
//     into a raw [PASS][NW] copy of the rows, one pass ahead, and each
//     thread moves its own item of the copy into the tiles;
//   * B and C arrive by 4-byte cp.async in stages of NG states of a pass,
//     [NG][PASS + 4] floats each in `tile_at` order (the 4 floats of
//     padding put the 8 states of one step in different banks), two
//     stages in flight: the next stage lands while the block scans this
//     one.
#pragma once

#include "common.cuh"

namespace repro {
namespace ssm {

constexpr int RUN = 8;            // consecutive steps a lane owns
constexpr int PASS = 32 * RUN;    // steps a warp covers at once
constexpr int CHUNK = 32;         // steps between checkpoints
constexpr int MAX_N = 64;         // the largest state size the kernels take
constexpr int SEG = 8;            // channels a thread moves to or from a row
constexpr int NG = 8;             // states a B/C stage holds
constexpr int BC_ROW = PASS + 4;  // floats a state's row takes in a stage
constexpr int BC_STAGE = 2 * NG * BC_ROW;  // floats of a stage (B and C)
constexpr unsigned FULL = 0xffffffffu;
static_assert(RUN == 8 && CHUNK % RUN == 0 && 32 * RUN >= CHUNK,
              "a chunk starts at a lane's run");

// 2^x on the special-function unit: a_t = ex2(dt_t (A log2 e)), one
// special-function op per exponential
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Offset of step t (< PASS) in a PASS-float row: step i of lane l's run
// lies at (i / 4) * 128 + 4 l + i % 4
__device__ __forceinline__ int tile_at(int t) {
    return ((t % RUN) / 4) * 128 + (t / RUN) * 4 + t % 4;
}

__device__ __forceinline__ void read_run(const float* row, int lane,
                                         float (&v)[RUN]) {
#pragma unroll
    for (int q = 0; q < RUN / 4; ++q) {
        const float4 f =
            *reinterpret_cast<const float4*>(row + q * 128 + 4 * lane);
        v[4 * q] = f.x;
        v[4 * q + 1] = f.y;
        v[4 * q + 2] = f.z;
        v[4 * q + 3] = f.w;
    }
}

__device__ __forceinline__ void write_run(float* row, int lane,
                                          const float (&v)[RUN]) {
#pragma unroll
    for (int q = 0; q < RUN / 4; ++q)
        *reinterpret_cast<float4*>(row + q * 128 + 4 * lane) =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// v[0..7] to 8 consecutive elements at p (16-byte aligned)
__device__ __forceinline__ void store8(float* p, const float (&v)[SEG]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[SEG]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
}

// Whether a (B, S, W) tensor's rows can be moved SEG elements at a time
// with 16-byte accesses
template <typename T>
__device__ __forceinline__ bool rows_vectorisable(const T* p, int W) {
    return W % SEG == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// --- cp.async ---------------------------------------------------------------
// `ok` false fills the destination with zeros (nothing is read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
    const uint32_t d =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
    const uint32_t d =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

// Close this thread's group of copies issued since the last one (an
// empty group is a group too, so every thread counts its groups alike)
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `PENDING` of this thread's newest groups are in
// flight; a __syncthreads after it makes every thread's finished copies
// visible to the block
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(PENDING) : "memory");
}

// --- a pass's rows ----------------------------------------------------------
// The block's item of a pass's rows: step t of the pass, channels
// [c0 + SEG s, c0 + SEG (s + 1)); one item a thread (THREADS = PASS * NW /
// SEG).  Consecutive threads take a row's consecutive segments, so the
// copies run along the channel axis.
template <int NW>
struct Item {
    int t, s;
    __device__ __forceinline__ Item()
        : t(threadIdx.x / (NW / SEG)), s(threadIdx.x % (NW / SEG)) {}
};

__device__ __forceinline__ uint32_t bits_of(float v) {
    return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
}

// Copy the item of rows [t0, t0 + PASS) of a (B, S, W) tensor's columns
// [c0, c0 + NW) into raw[PASS][NW] (as T): by 16-byte cp.async where the
// rows can be moved so (rows past S as zeros), else element by element
// (columns past W as zeros).  Only this thread reads the item back
// (`raw_to_tile`), after the wait for its group.
template <typename T, int NW>
__device__ __forceinline__ void fetch_rows(T* raw, const T* __restrict__ src,
                                           Item<NW> it, int b, int S, int W,
                                           int t0, int c0, bool vec) {
    constexpr int WORDS = SEG * sizeof(T) / 16;  // 16-byte words an item
    constexpr int PER_WORD = 4 / sizeof(T);      // elements a 32-bit word
    const int t = t0 + it.t, c = c0 + it.s * SEG;
    uint4* dst = reinterpret_cast<uint4*>(raw + it.t * NW + it.s * SEG);
    const T* p = src + ((size_t)b * S + min(t, S - 1)) * W + c;
    if (vec && c + SEG <= W) {
#pragma unroll
        for (int k = 0; k < WORDS; ++k)
            cp_async16(dst + k, reinterpret_cast<const uint4*>(p) + k, t < S);
        return;
    }
    uint32_t u[4 * WORDS];
#pragma unroll
    for (int k = 0; k < 4 * WORDS; ++k) u[k] = 0;
#pragma unroll
    for (int j = 0; j < SEG; ++j)
        if (t < S && c + j < W)
            u[j / PER_WORD] |= bits_of(p[j])
                               << (32 / PER_WORD * (j % PER_WORD));
#pragma unroll
    for (int k = 0; k < WORDS; ++k)
        dst[k] = make_uint4(u[4 * k], u[4 * k + 1], u[4 * k + 2],
                            u[4 * k + 3]);
}

__device__ __forceinline__ void words_to_floats(const uint4* w, float* v,
                                                float) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        v[4 * k] = __uint_as_float(w[k].x);
        v[4 * k + 1] = __uint_as_float(w[k].y);
        v[4 * k + 2] = __uint_as_float(w[k].z);
        v[4 * k + 3] = __uint_as_float(w[k].w);
    }
}
__device__ __forceinline__ void words_to_floats(const uint4* w, float* v,
                                                __nv_bfloat16) {
    const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[2 * k] = __uint_as_float(u[k] << 16);
        v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
}

// This thread's item of raw[PASS][NW] into tile[NW][PASS] as float32
template <typename T, int NW>
__device__ __forceinline__ void raw_to_tile(float* tile, const T* raw,
                                            Item<NW> it) {
    constexpr int WORDS = SEG * sizeof(T) / 16;
    uint4 w[WORDS];
    const uint4* src =
        reinterpret_cast<const uint4*>(raw + it.t * NW + it.s * SEG);
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = src[k];
    float v[SEG];
    words_to_floats(w, v, T());
    const int at = tile_at(it.t);
#pragma unroll
    for (int j = 0; j < SEG; ++j) tile[(it.s * SEG + j) * PASS + at] = v[j];
}

// Store this thread's item of tile[NW][PASS] to row t0 + it.t of a
// (B, S, W) tensor in T, masking rows past S and columns past W.
template <typename T, int NW>
__device__ __forceinline__ void tile_to_row(T* __restrict__ dst,
                                            const float* tile, Item<NW> it,
                                            int b, int S, int W, int t0,
                                            int c0, bool vec) {
    const int c = c0 + it.s * SEG;
    if (t0 + it.t >= S) return;
    const int at = tile_at(it.t);
    float v[SEG];
#pragma unroll
    for (int j = 0; j < SEG; ++j) v[j] = tile[(it.s * SEG + j) * PASS + at];
    T* p = dst + ((size_t)b * S + t0 + it.t) * W + c;
    if (vec && c + SEG <= W) {
        store8(p, v);
    } else {
#pragma unroll
        for (int j = 0; j < SEG; ++j)
            if (c + j < W) store(p + j, v[j]);
    }
}

// --- B and C ----------------------------------------------------------------
// Issue the copies of a stage: states [n0, n0 + NG) of rows [t0, t0 +
// PASS) of B and C ((B, S, N) float32) into stage[2][NG][BC_ROW] (B, then
// C), step t of state n0 + j at j BC_ROW + tile_at(t); rows past S and
// states past N as zeros.  Consecutive threads take consecutive states of
// a row, so the copies run along the rows.
template <int THREADS>
__device__ __forceinline__ void fetch_bc(float* stage,
                                         const float* __restrict__ Bm,
                                         const float* __restrict__ Cm, int b,
                                         int S, int N, int t0, int n0) {
    for (int i = threadIdx.x; i < PASS * NG; i += THREADS) {
        const int t = i / NG, j = i % NG;
        const bool ok = t0 + t < S && n0 + j < N;
        const size_t off = ok ? ((size_t)b * S + t0 + t) * N + n0 + j : 0;
        float* d = stage + j * BC_ROW + tile_at(t);
        cp_async4(d, Bm + off, ok);
        cp_async4(d + NG * BC_ROW, Cm + off, ok);
    }
}

}  // namespace ssm
}  // namespace repro
