// Selective-scan forward (K5) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `ssm_scan_bsd` of the reference package
// (src/repro/kernels/ssm_scan.py, body `_ssm_kernel`): the Mamba scan
//   h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = h_t . C_t + D x_t
// with x, dt (B, S, Din) in float32 or bfloat16, A (Din, N), B and C
// (B, S, N), D (Din,) float32, N from 1 to 64 (hymba's state is 16); y
// (B, S, Din) in x's type.  It follows the reference's oracle
// (src/repro/kernels/ref.py, ssm_scan) in its rounding: D x is added in
// float32 before the one cast to x's type.  For training it also writes
// the float32 state at the start of every CHUNK-step chunk,
// (ceil(S / CHUNK), B, Din, N), which K5-bwd recomputes each chunk from
// (the reference's checkpointed adjoint, src/repro/kernels/ssm_vjp.py).
// For serving it can also write the final float32 state (B, Din, N), the
// state the prefill hands to decode (the reference gets it from its
// sequential oracle, src/repro/kernels/ops.py, ssm_scan_with_state): the
// carry each warp holds after its last pass, which steps past S leave as
// it was.
//
// What bounds it on the H100: at hymba-1.5b's training shape (B = 2,
// S = 4096, Din = 3200, N = 16, bf16) it reads x and dt (52 MB each) and
// B, C (1 MB) and writes y (52 MB) and the checkpoints (52 MB): about
// 0.06 ms at 3.35 TB/s.  It takes B S Din N = 419 M exponentials, which
// the special-function units (16 a clock an SM) need about 0.1 ms for, and
// about 7 float32 operations each beside them: the bound is the
// exponentials.  The TPU kernel walks each channel block's steps in order;
// on the card one thread a (channel, n) walking 4096 steps in order leaves
// a chain of dependent steps and a sum over n on every step.  The design
// (the map in ssm_common.cuh):
//   * a scan over time: a warp owns one (batch, channel), each lane RUN = 8
//     consecutive steps of a 256-step pass; for each n the lane composes
//     its 8 (a, b) pairs in order, the warp scans the 32 composites in 5
//     `__shfl_up_sync` levels (lane 0 folds in the state carried from the
//     last pass, lane 31 keeps the pass's last state for the next), and
//     the lane walks its 8 steps again from the state before its run,
//     adding h_t C_t into its own y_t: no sum across lanes;
//   * each exponential is one `ex2.approx` of dt (A log2 e), taken once;
//   * a block holds NW = 8 channels of one batch row, so its 8 warps share
//     one copy of B and C.  The next pass's x and dt rows are in flight
//     (16-byte cp.async along the channels) while the block scans this
//     one, and B and C come in stages of 8 states, the next stage in
//     flight while the block scans this one; blocks are small (256
//     threads, 59 KB at N = 16 in bf16), three to an SM;
//   * the lanes whose run starts a chunk write its checkpoint, the state
//     the scan hands them; y goes back through the x tile and is stored
//     coalesced, D x added in float32 first;
//   * a ragged S and a ragged Din are masked in the kernel: steps past S
//     have dt = 0 (the state stays) and store nothing, channels past Din
//     compute on zeros and store nothing, so the wrapper pads nothing.
#include "ssm_common.cuh"

namespace {

using namespace repro::ssm;

constexpr int NW = 8;                // channels (warps) a block
constexpr int THREADS = 32 * NW;
static_assert(THREADS == PASS * NW / SEG, "one row item a thread");

// Dynamic shared memory of a block, in bytes: the x (then y) and dt tiles,
// two B/C stages, A log2(e) and the carried states (floats), then the raw
// copies of the next pass's x and dt rows (T)
template <typename T>
__host__ __device__ constexpr int smem_bytes(int N) {
    return (int)sizeof(float) * (2 * NW * PASS + 2 * BC_STAGE + 2 * NW * N) +
           2 * PASS * NW * (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
ssm_scan_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ Dv, T* __restrict__ y,
                    float* __restrict__ ckpt, float* __restrict__ fin,
                    int Bsz, int S, int Din, int N) {
    extern __shared__ float4 smem4[];
    float* sx = reinterpret_cast<float*>(smem4);  // x, then y
    float* sdt = sx + NW * PASS;
    float* stages = sdt + NW * PASS;  // [2][BC_STAGE]
    float* sA2 = stages + 2 * BC_STAGE;  // [NW][N]: A log2(e)
    float* carry = sA2 + NW * N;  // [NW][N]: the state after the last pass
    T* rx = reinterpret_cast<T*>(carry + NW * N);  // [PASS][NW]
    T* rdt = rx + PASS * NW;

    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int c0 = blockIdx.x * NW, c = c0 + w;
    const int b = blockIdx.y;
    const bool valid = c < Din;
    for (int i = tid; i < NW * N; i += THREADS) {
        const int ci = c0 + i / N;
        sA2[i] =
            ci < Din ? A[(size_t)ci * N + i % N] * repro::LOG2E : 0.f;
        carry[i] = 0.f;
    }
    const float d_c = valid ? Dv[c] : 0.f;
    const bool vec = rows_vectorisable(x, Din) &&
                     rows_vectorisable(dt, Din) && rows_vectorisable(y, Din);
    const int nck = (S + CHUNK - 1) / CHUNK;
    const int groups = (N + NG - 1) / NG;  // B/C stages a pass
    float* wcarry = carry + w * N;
    const float* wa2 = sA2 + w * N;
    const Item<NW> it;
    // copy groups, each thread alike: the rows of pass p + 1 at pass p's
    // start, a stage at the one before it
    fetch_rows(rx, x, it, b, S, Din, 0, c0, vec);
    fetch_rows(rdt, dt, it, b, S, Din, 0, c0, vec);
    cp_async_commit();
    fetch_bc<THREADS>(stages, Bm, Cm, b, S, N, 0, 0);
    cp_async_commit();
    int stage = 0;
    for (int t0 = 0; t0 < S; t0 += PASS) {
        cp_async_wait<1>();  // this pass's rows (the next stage may fly)
        __syncthreads();     // the last pass's y is stored: tiles free
        raw_to_tile(sx, rx, it);
        raw_to_tile(sdt, rdt, it);
        if (t0 + PASS < S) {
            fetch_rows(rx, x, it, b, S, Din, t0 + PASS, c0, vec);
            fetch_rows(rdt, dt, it, b, S, Din, t0 + PASS, c0, vec);
        }
        cp_async_commit();
        // the chunk this lane's run starts, if it starts one
        const int k = (t0 + lane * RUN) / CHUNK;
        const bool writes_ckpt = ckpt != nullptr && valid &&
                                 (lane * RUN) % CHUNK == 0 && k < nck;
        float* ck = writes_ckpt
                        ? ckpt + (((size_t)k * Bsz + b) * Din + c) * N
                        : nullptr;
        float dtv[RUN], u[RUN], yv[RUN];
        for (int g = 0; g < groups; ++g, ++stage) {
            if (g == 0)
                cp_async_wait<1>();  // the stage (the next rows may fly)
            else
                cp_async_wait<0>();
            __syncthreads();  // the stage and the tiles are in; the last
                              // stage is read
            const int n0 = g * NG;
            if (g + 1 < groups)
                fetch_bc<THREADS>(stages + (stage + 1) % 2 * BC_STAGE, Bm,
                                  Cm, b, S, N, t0, n0 + NG);
            else if (t0 + PASS < S)
                fetch_bc<THREADS>(stages + (stage + 1) % 2 * BC_STAGE, Bm,
                                  Cm, b, S, N, t0 + PASS, 0);
            cp_async_commit();
            if (g == 0) {
                read_run(sdt + w * PASS, lane, dtv);
                read_run(sx + w * PASS, lane, u);
#pragma unroll
                for (int i = 0; i < RUN; ++i) {
                    u[i] *= dtv[i];
                    yv[i] = 0.f;
                }
            }
            const float* sb = stages + stage % 2 * BC_STAGE;
            for (int j = 0; j < min(NG, N - n0); ++j) {
                const int n = n0 + j;
                const float a2 = wa2[n];
                float a[RUN], bb[RUN], cv[RUN];
                read_run(sb + j * BC_ROW, lane, bb);
                read_run(sb + (NG + j) * BC_ROW, lane, cv);
                float ac = 1.f, bc = 0.f;
#pragma unroll
                for (int i = 0; i < RUN; ++i) {
                    a[i] = ex2(dtv[i] * a2);
                    bb[i] *= u[i];
                    bc = a[i] * bc + bb[i];
                    ac *= a[i];
                }
                // lane 0 starts from the carried state; the scan then
                // gives every lane the state at the end of its run
                const float h_carry = wcarry[n];
                if (lane == 0) bc = ac * h_carry + bc;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const float bp = __shfl_up_sync(FULL, bc, d);
                    // the products are not needed after the last level
                    const float ap =
                        d < 16 ? __shfl_up_sync(FULL, ac, d) : 1.f;
                    if (lane >= d) {
                        bc = ac * bp + bc;
                        ac *= ap;
                    }
                }
                // the state before the run
                float h = __shfl_up_sync(FULL, bc, 1);
                if (lane == 0) h = h_carry;
                if (lane == 31) wcarry[n] = bc;
                if (writes_ckpt) ck[n] = h;
#pragma unroll
                for (int i = 0; i < RUN; ++i) {
                    h = a[i] * h + bb[i];
                    yv[i] += h * cv[i];
                }
            }
        }
        float xv[RUN];
        read_run(sx + w * PASS, lane, xv);
#pragma unroll
        for (int i = 0; i < RUN; ++i) yv[i] += d_c * xv[i];
        write_run(sx + w * PASS, lane, yv);  // each lane its own slots
        __syncthreads();
        tile_to_row(y, sx, it, b, S, Din, t0, c0, vec);
    }
    // the final state: the carry after the last pass (its lane 31 wrote
    // it before the pass's last __syncthreads)
    if (fin != nullptr && valid)
        for (int n = lane; n < N; n += 32)
            fin[((size_t)b * Din + c) * N + n] = wcarry[n];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* Bm, const float* Cm, const float* Dv, void* y,
                   float* ckpt, float* fin, int Bsz, int S, int Din, int N,
                   cudaStream_t stream) {
    const cudaError_t attr =
        repro::allow_smem<ssm_scan_fwd_kernel<T>>(smem_bytes<T>(MAX_N));
    if (attr != cudaSuccess) return attr;
    const dim3 grid((Din + NW - 1) / NW, Bsz);
    ssm_scan_fwd_kernel<T><<<grid, THREADS, smem_bytes<T>(N), stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt), A, Bm, Cm, Dv,
        static_cast<T*>(y), ckpt, fin, Bsz, S, Din, N);
    return cudaGetLastError();
}

}  // namespace

// The chunk length (steps between checkpoints) of K5 and K5-bwd.
extern "C" int repro_ssm_scan_chunk() { return CHUNK; }

// The largest state size N K5 and K5-bwd take.
extern "C" int repro_ssm_scan_max_state() { return MAX_N; }

// dtype: 0 = float32, 1 = bfloat16 (x, dt, y); A, B, C, D float32;
// 1 <= N <= 64.  ckpt: null, or (ceil(S / CHUNK), B, Din, N) float32;
// fin: null, or the final state (B, Din, N) float32.  Returns a
// cudaError_t.
extern "C" int repro_ssm_scan(const void* x, const void* dt, const float* A,
                              const float* Bm, const float* Cm,
                              const float* Dv, void* y, float* ckpt,
                              float* fin, int B, int S, int Din, int N,
                              int dtype, void* stream) {
    if (B < 1 || S < 1 || Din < 1 || N < 1 || N > MAX_N ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch<float>(x, dt, A, Bm, Cm, Dv, y, ckpt, fin, B, S,
                                  Din, N, st);
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, y, ckpt, fin, B,
                                      S, Din, N, st);
}
