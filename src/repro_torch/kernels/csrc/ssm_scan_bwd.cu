// Selective-scan backward (K5-bwd) for Hopper (sm_90a), hand-written CUDA
// C++.
//
// The TPU path has no backward kernel for K5: the reference trains its scan
// either by autodiff through the oracle's lax.scan or, under the planner's
// optimised profile, through the checkpointed-adjoint custom VJP of
// src/repro/kernels/ssm_vjp.py (`_bwd_vjp`).  K5-bwd is that VJP: from the
// float32 state K5 saved at each CHUNK-step chunk start, it walks the
// sequence in reverse, recomputes the states forward from the checkpoints
// (it never inverts h_{t-1} = (h_t - b_t) / a_t: a_t can be tiny) and runs
// the adjoint
//   dh_t = dy_t C_t + a_{t+1} dh_{t+1},   da_t = dh_t h_{t-1},
// giving dx and ddt (B, S, Din) in x's type, and dB, dC (B, S, N), dA
// (Din, N), dD (Din,) in float32.  N from 1 to 64.
//
// What bounds it on the H100: at hymba-1.5b's training shape (B = 2,
// S = 4096, Din = 3200, N = 16, bf16) it reads x, dt and dy (52 MB each),
// B, C and the checkpoints (54 MB) and writes dx and ddt (52 MB each):
// about 0.1 ms at 3.35 TB/s.  The a_t it needs are B S Din N = 419 M
// exponentials, about 0.1 ms on the special-function units, beside about
// 22 float32 operations each: the bound is the operations.  The design
// (the map in ssm_common.cuh, the same as K5's):
//   * a warp owns one (batch, channel), each lane 8 consecutive steps of a
//     256-step pass; the passes are walked in reverse.  For each n a lane
//     takes its 8 exponentials once, recomputes its states from the
//     checkpoint of its chunk (a scan across the 4 lanes of a chunk, 2
//     `__shfl_up_sync` levels, states kept in registers), and runs the
//     adjoint as a reverse scan: e_t = a_t dh_t maps e_{t+1} to
//     e_t = a_t (dy_t C_t + e_{t+1}), the lane composes its 8 maps, the
//     warp scans them in 5 `__shfl_down_sync` levels (lane 31 folds in the
//     e carried from the later pass, lane 0 keeps this pass's first for
//     the earlier one), and the lane walks its steps in reverse;
//   * the sums over n stay in the thread: ddt and dx accumulate in the
//     lane's registers across the n loop; dA's sum over the lane's steps is
//     added over the warp once per (pass, n) and kept in shared memory;
//   * dB and dC are sums over all Din channels: each warp writes its
//     channel's 256 values for the n into a shared-memory slot, the block
//     adds its NW = 16 warps in order (one thread a step) and writes one
//     partial row a block, (2, channel blocks, B, N, S); two slots
//     alternate, so one __syncthreads a (pass, n).  An epilogue kernel adds
//     the blocks' partials in block order, and dA's and dD's per-batch
//     partials likewise.  No atomics: two launches give the same bits;
//   * the earlier pass's x, dt and dy rows are in flight (16-byte
//     cp.async) while the block walks this one, and B and C come in stages
//     of 8 states, the next in flight, as in K5; a block is 512 threads at
//     up to 128 registers (one an SM);
//   * a ragged S and a ragged Din are masked as in K5.
#include <algorithm>

#include "ssm_common.cuh"

namespace {

using namespace repro::ssm;

constexpr int NW = 16;               // channels (warps) a block
constexpr int THREADS = 32 * NW;
constexpr int LANES_A_CHUNK = CHUNK / RUN;
static_assert(THREADS == PASS * NW / SEG, "one row item a thread");

// Dynamic shared memory of a block, in bytes: the pass's x, dt and dy
// tiles (then dx and ddt in the first two), the two dB/dC slots
// ([2][NW][PASS] each), two B/C stages, A log2(e), A, the carried
// adjoints and dA's sums (floats), then the raw copies of the next pass's
// x, dt and dy rows (T)
constexpr int SLOTS = 4 * NW * PASS;
template <typename T>
__host__ __device__ constexpr int smem_bytes(int N) {
    return (int)sizeof(float) *
               (3 * NW * PASS + SLOTS + 2 * BC_STAGE + 4 * NW * N) +
           3 * PASS * NW * (int)sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssm_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm,
                    const float* __restrict__ Dv,
                    const float* __restrict__ ckpt, const T* __restrict__ dy,
                    T* __restrict__ dx, T* __restrict__ ddt,
                    float* __restrict__ part_bc, float* __restrict__ part_dA,
                    float* __restrict__ part_dD, int Bsz, int S, int Din,
                    int N) {
    extern __shared__ float4 smem4[];
    float* sx = reinterpret_cast<float*>(smem4);  // x, then dx
    float* sdt = sx + NW * PASS;                  // dt, then ddt
    float* sdy = sdt + NW * PASS;
    float* slots = sdy + NW * PASS;  // [2][2][NW][PASS]: dB and dC
    float* stages = slots + SLOTS;   // [2][BC_STAGE]
    float* sA2 = stages + 2 * BC_STAGE;  // [NW][N]: A log2(e)
    float* sA = sA2 + NW * N;            // [NW][N]: A
    float* carry = sA + NW * N;  // [NW][N]: e at the later pass's start
    float* sdA = carry + NW * N;  // [NW][N]: dA's sums
    T* rx = reinterpret_cast<T*>(sdA + NW * N);  // [PASS][NW]
    T* rdt = rx + PASS * NW;
    T* rdy = rdt + PASS * NW;

    const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
    const int c0 = blockIdx.x * NW, c = c0 + w;
    const int b = blockIdx.y;
    const bool valid = c < Din;
    for (int i = tid; i < NW * N; i += THREADS) {
        const int ci = c0 + i / N;
        const float a = ci < Din ? A[(size_t)ci * N + i % N] : 0.f;
        sA[i] = a;
        sA2[i] = a * repro::LOG2E;
        carry[i] = 0.f;
        sdA[i] = 0.f;
    }
    const float d_c = valid ? Dv[c] : 0.f;
    const bool vec =
        rows_vectorisable(x, Din) && rows_vectorisable(dt, Din) &&
        rows_vectorisable(dy, Din) && rows_vectorisable(dx, Din) &&
        rows_vectorisable(ddt, Din);
    const int nck = (S + CHUNK - 1) / CHUNK;
    const int groups = (N + NG - 1) / NG;  // B/C stages a pass
    const int g4 = lane % LANES_A_CHUNK;   // the lane's place in its chunk
    const size_t rows = (size_t)gridDim.x * Bsz * N * S;  // a partial tensor
    const Item<NW> it;
    float dD_acc = 0.f;
    // copy groups, each thread alike: the rows of the pass before at a
    // pass's start, a stage at the one before it
    const int last = (S - 1) / PASS * PASS;
    fetch_rows(rx, x, it, b, S, Din, last, c0, vec);
    fetch_rows(rdt, dt, it, b, S, Din, last, c0, vec);
    fetch_rows(rdy, dy, it, b, S, Din, last, c0, vec);
    cp_async_commit();
    fetch_bc<THREADS>(stages, Bm, Cm, b, S, N, last, 0);
    cp_async_commit();
    int stage = 0;
    for (int t0 = last; t0 >= 0; t0 -= PASS) {
        cp_async_wait<1>();  // this pass's rows (the next stage may fly)
        __syncthreads();     // the last pass's dx and ddt are stored
        raw_to_tile(sx, rx, it);
        raw_to_tile(sdt, rdt, it);
        raw_to_tile(sdy, rdy, it);
        if (t0 > 0) {
            fetch_rows(rx, x, it, b, S, Din, t0 - PASS, c0, vec);
            fetch_rows(rdt, dt, it, b, S, Din, t0 - PASS, c0, vec);
            fetch_rows(rdy, dy, it, b, S, Din, t0 - PASS, c0, vec);
        }
        cp_async_commit();
        // the checkpoint of the chunk this lane's run starts, if it does
        const int k = (t0 + lane * RUN) / CHUNK;
        const float* ck = valid && g4 == 0 && k < nck
                              ? ckpt + (((size_t)k * Bsz + b) * Din + c) * N
                              : nullptr;
        float dtv[RUN], dyv[RUN], u[RUN], ddt_acc[RUN], ddtx[RUN];
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
            else if (t0 > 0)
                fetch_bc<THREADS>(stages + (stage + 1) % 2 * BC_STAGE, Bm,
                                  Cm, b, S, N, t0 - PASS, 0);
            cp_async_commit();
            if (g == 0) {
                float xv[RUN];
                read_run(sdt + w * PASS, lane, dtv);
                read_run(sx + w * PASS, lane, xv);
                read_run(sdy + w * PASS, lane, dyv);
#pragma unroll
                for (int i = 0; i < RUN; ++i) {
                    u[i] = dtv[i] * xv[i];
                    dD_acc += dyv[i] * xv[i];
                    ddt_acc[i] = 0.f;
                    ddtx[i] = 0.f;
                }
            }
            const float* sb = stages + stage % 2 * BC_STAGE;
            for (int j = 0; j < min(NG, N - n0); ++j) {
                const int n = n0 + j;
                const float a2 = sA2[w * N + n], an = sA[w * N + n];
                float a[RUN], bv[RUN], hs[RUN], gv[RUN];
                read_run(sb + j * BC_ROW, lane, bv);
                read_run(sb + (NG + j) * BC_ROW, lane, gv);
                // the lane's pairs, composed in order; ar keeps the
                // decays' product for the adjoint's composite
                float ac = 1.f, bc = 0.f;
#pragma unroll
                for (int i = 0; i < RUN; ++i) {
                    a[i] = ex2(dtv[i] * a2);
                    gv[i] *= dyv[i];  // dy_t C_t
                    bc = a[i] * bc + u[i] * bv[i];
                    ac *= a[i];
                }
                const float ar = ac;
                // the states: a scan over the lanes of each chunk, the
                // first starting from the chunk's checkpoint
                const float h0 = ck != nullptr ? ck[n] : 0.f;
                if (g4 == 0) bc = ac * h0 + bc;
#pragma unroll
                for (int d = 1; d < LANES_A_CHUNK; d <<= 1) {
                    const float ap =
                        __shfl_up_sync(FULL, ac, d, LANES_A_CHUNK);
                    const float bp =
                        __shfl_up_sync(FULL, bc, d, LANES_A_CHUNK);
                    if (g4 >= d) {
                        bc = ac * bp + bc;
                        ac *= ap;
                    }
                }
                float h_in = __shfl_up_sync(FULL, bc, 1, LANES_A_CHUNK);
                if (g4 == 0) h_in = h0;
                float h = h_in;
#pragma unroll
                for (int i = 0; i < RUN; ++i) {
                    h = a[i] * h + u[i] * bv[i];
                    hs[i] = h;
                }
                // the adjoint's carry e = a dh: the lane's maps composed
                // from its last step back, then a reverse scan over the
                // warp
                float er = 0.f;
#pragma unroll
                for (int i = RUN - 1; i >= 0; --i) er = a[i] * (gv[i] + er);
                float ea = ar;
                const float e_carry = carry[w * N + n];
                if (lane == 31) er = ea * e_carry + er;
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const float bp = __shfl_down_sync(FULL, er, d);
                    // the products are not needed after the last level
                    const float ap =
                        d < 16 ? __shfl_down_sync(FULL, ea, d) : 1.f;
                    if (lane + d < 32) {
                        er = ea * bp + er;
                        ea *= ap;
                    }
                }
                float e = __shfl_down_sync(FULL, er, 1);  // after the run
                if (lane == 31) e = e_carry;
                if (lane == 0) carry[w * N + n] = er;
                float dA_n = 0.f, dBv[RUN], dCv[RUN];
#pragma unroll
                for (int i = RUN - 1; i >= 0; --i) {
                    const float dh = gv[i] + e;
                    e = a[i] * dh;
                    // q = da_t a_t, da_t = dh_t h_{t-1}
                    const float q = e * (i > 0 ? hs[i - 1] : h_in);
                    dA_n += q * dtv[i];
                    ddt_acc[i] += q * an;
                    ddtx[i] += dh * bv[i];
                    dBv[i] = dh * u[i];
                    dCv[i] = dyv[i] * hs[i];
                }
                float* slot = slots + (n % 2) * 2 * NW * PASS;
                write_run(slot + w * PASS, lane, dBv);
                write_run(slot + (NW + w) * PASS, lane, dCv);
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    dA_n += __shfl_xor_sync(FULL, dA_n, off);
                if (lane == 0) sdA[w * N + n] += dA_n;
                __syncthreads();
                // the block's sums over its channels of each step's dB and
                // dC, in channel order
                for (int o = tid; o < 2 * PASS; o += THREADS) {
                    const int which = o / PASS, t = o % PASS;
                    const float* col = slot + which * NW * PASS + tile_at(t);
                    float sum = 0.f;
#pragma unroll
                    for (int m = 0; m < NW; ++m) sum += col[m * PASS];
                    if (t0 + t < S)
                        part_bc[which * rows +
                                (((size_t)blockIdx.x * Bsz + b) * N + n) * S +
                                t0 + t] = sum;
                }
            }
        }
        // dx and ddt through the x and dt tiles, each lane its own slots
        float xv[RUN], dxv[RUN], ddtv[RUN];
        read_run(sx + w * PASS, lane, xv);
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
            dxv[i] = ddtx[i] * dtv[i] + dyv[i] * d_c;
            ddtv[i] = ddt_acc[i] + ddtx[i] * xv[i];
        }
        write_run(sx + w * PASS, lane, dxv);
        write_run(sdt + w * PASS, lane, ddtv);
        __syncthreads();
        tile_to_row(dx, sx, it, b, S, Din, t0, c0, vec);
        tile_to_row(ddt, sdt, it, b, S, Din, t0, c0, vec);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        dD_acc += __shfl_xor_sync(FULL, dD_acc, off);
    if (valid) {
        for (int n = lane; n < N; n += 32)
            part_dA[((size_t)b * Din + c) * N + n] = sdA[w * N + n];
        if (lane == 0) part_dD[(size_t)b * Din + c] = dD_acc;
    }
}

// The epilogue: blockIdx.y 0 and 1 give dB and dC (B, S, N), the sum over
// the channel blocks of part_bc[y] (blocks, B, N, S); 2 gives dA (Din, N)
// and 3 dD (Din,), the sums over the batch of part_dA (B, Din, N) and
// part_dD (B, Din).  Every sum runs in block (or batch) order.
__global__ void ssm_bwd_sums_kernel(const float* __restrict__ part_bc,
                                    const float* __restrict__ part_dA,
                                    const float* __restrict__ part_dD,
                                    float* __restrict__ dB,
                                    float* __restrict__ dC,
                                    float* __restrict__ dA,
                                    float* __restrict__ dD, int blocks,
                                    int Bsz, int S, int Din, int N) {
    const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int which = blockIdx.y;
    if (which < 2) {
        const size_t M = (size_t)Bsz * N * S;
        if (i >= M) return;
        const float* p = part_bc + which * blocks * M + i;
        float s = 0.f;
        for (int j = 0; j < blocks; ++j) s += p[j * M];
        const size_t t = i % S, bn = i / S;  // i = (b N + n) S + t
        const size_t bb = bn / N, n = bn % N;
        (which == 0 ? dB : dC)[(bb * S + t) * N + n] = s;
        return;
    }
    const size_t M = which == 2 ? (size_t)Din * N : (size_t)Din;
    if (i >= M) return;
    const float* p = which == 2 ? part_dA : part_dD;
    float s = 0.f;
    for (int j = 0; j < Bsz; ++j) s += p[j * M + i];
    (which == 2 ? dA : dD)[i] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const float* A,
                   const float* Bm, const float* Cm, const float* Dv,
                   const float* ckpt, const void* dy, void* dx, void* ddt,
                   float* part_bc, float* part_dA, float* part_dD, float* dB,
                   float* dC, float* dA, float* dD, int Bsz, int S, int Din,
                   int N, cudaStream_t stream) {
    const cudaError_t attr =
        repro::allow_smem<ssm_scan_bwd_kernel<T>>(smem_bytes<T>(MAX_N));
    if (attr != cudaSuccess) return attr;
    const int blocks = (Din + NW - 1) / NW;
    ssm_scan_bwd_kernel<T><<<dim3(blocks, Bsz), THREADS, smem_bytes<T>(N),
                             stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt), A, Bm, Cm, Dv,
        ckpt, static_cast<const T*>(dy), static_cast<T*>(dx),
        static_cast<T*>(ddt), part_bc, part_dA, part_dD, Bsz, S, Din, N);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t most = std::max((size_t)Bsz * N * S, (size_t)Din * N);
    constexpr int SUM_THREADS = 256;
    ssm_bwd_sums_kernel<<<dim3((unsigned)((most + SUM_THREADS - 1) /
                                          SUM_THREADS),
                               4),
                          SUM_THREADS, 0, stream>>>(part_bc, part_dA, part_dD,
                                                    dB, dC, dA, dD, blocks,
                                                    Bsz, S, Din, N);
    return cudaGetLastError();
}

}  // namespace

// Channels a block of K5-bwd covers: the partials of dB and dC are
// (2, ceil(Din / this), B, N, S).
extern "C" int repro_ssm_scan_channels_per_block() { return NW; }

// dtype: 0 = float32, 1 = bfloat16 (x, dt, dy, dx, ddt); everything else
// float32; 1 <= N <= 64.  ckpt: K5's checkpoints, (ceil(S / CHUNK), B,
// Din, N).  Scratch: part_bc (2, ceil(Din / 16), B, N, S), part_dA (B,
// Din, N), part_dD (B, Din).  Outputs dB, dC (B, S, N), dA (Din, N), dD
// (Din,).  Returns a cudaError_t.
extern "C" int repro_ssm_scan_bwd(
    const void* x, const void* dt, const float* A, const float* Bm,
    const float* Cm, const float* Dv, const float* ckpt, const void* dy,
    void* dx, void* ddt, float* part_bc, float* part_dA, float* part_dD,
    float* dB, float* dC, float* dA, float* dD, int B, int S, int Din, int N,
    int dtype, void* stream) {
    if (B < 1 || S < 1 || Din < 1 || N < 1 || N > MAX_N ||
        (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch<float>(x, dt, A, Bm, Cm, Dv, ckpt, dy, dx, ddt,
                                  part_bc, part_dA, part_dD, dB, dC, dA, dD,
                                  B, S, Din, N, st);
    return (int)launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, ckpt, dy, dx, ddt,
                                      part_bc, part_dA, part_dD, dB, dC, dA,
                                      dD, B, S, Din, N, st);
}
