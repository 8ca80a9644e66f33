// The tensor-core chunk walk shared by K6 (mlstm_scan.cu) and K6-bwd
// (mlstm_scan_bwd.cu) in bf16: every product on `wgmma` (bf16 inputs,
// float32 sums), the tiles brought in by TMA, the carried state in float32
// registers.  Built from hopper_common.cuh.
//
// One walk serves four products, because each is the same recurrence with
// other operands.  A block walks the chunks of 64 rows of one (tile of 64
// columns, head, batch), in order or in reverse, and per chunk computes
//   scores = X Y^T                       (64 x 64, over P panels of 64)
//   out    = oc * (X St^T) + ad n^T + P T  (64 x 64; P from the scores)
//   St     = decay * St + Z^T Y          (the state, 64 x 64P, float32)
// with X and Y two chunk operands streamed in 64-column panels, T the
// block's 64-column tile of a third, Z = zc * T, and the row coefficients
// (oc, ad, zc) and the pair weights W from the gates:
//
//   mode  X   Y   T   U   panels  tile  walk     P[a, b]
//   FWD   q   k   v   -   D/64    DV    forward  scale s W[a, b]
//   DV    k   q   dh  -   D/64    DV    reverse  scale s W[b, a] rden_b
//   DQ    dh  v   k   q   DV/64   D     forward  (s rden_a + dqn_a) W[a, b]
//   DK    v   dh  q   k   DV/64   D     reverse  scale (s rden_b + dqn_b) W[b, a]
//
// FWD is K6: St is C^T (the block's DV columns, all D), out = h before the
// division by den = max(|qn|, e^-m), and qn = scale iw (q . n) + the row
// sum of P in float32, with n carried in float32 in shared memory.  DV, DQ
// and DK are K6-bwd's walks, carrying dC^T, C and dC (a 64-row D tile, all
// DV); DQ and DK also carry n or dn (the tile's 64 entries, float32, in
// shared memory) and sum U . out per row for the gate gradients (U = q or
// k, read from memory).
//
// W[t, j] = exp(b_t - m_t + log i_j - b_j) for j <= t (b the cumulative
// log forget gate within the chunk): `chunk_gates64` computes the gate
// arrays of a chunk with one warp, two rows a lane, and is the only code
// that does, so the forward and every backward walk agree bit for bit.
//
// Precision: three float32 operands go to the tensor cores — P, the
// state's copy (the B operand of the next chunk's X St^T) and Z — each as
// a pair of bf16 values, hi = bf16(x) and lo = bf16(x - hi), every product
// with one of them taken twice (hi, then lo) into the same float32 sum:
// about 16 bits of x.  One bf16 rounding would not hold h and the
// gradients to their bf16 bounds where den is small: h is large there, and
// an ulp of a row's largest terms lands on its small entries (the CPU
// emulation in tests/test_torch_mlstm_tc.py shows both).  The state itself
// is carried in float32 registers and never rounded; the gates, n, q . n
// and P's row sums stay in float32.
//
// The block: 384 threads.  Warpgroup 0 ("O") computes out (the first and
// last products) and its epilogue, which leaves through shared memory in
// 16-byte row stores; warpgroup 1 ("S") computes the scores, the weights,
// P, n (float32 FMAs: K6's over Y, DQ's and DK's over T) and K6's qn.
// Each holds every other state tile (St panels 0, 2, 4 and 1, 3, 5), 96
// floats a thread at 6 panels; the walk is compiled for each P, so every
// loop over panels unrolls and no branch separates two wgmma of one
// pipeline stage.  The third warpgroup gives up its registers: its first
// warp keeps a ring of STAGES (X, Y) panel pairs full by TMA across chunk
// boundaries, its second computes each chunk's gates and row coefficients
// a chunk ahead (its inputs loaded a chunk before that), loads T by TMA
// and makes Z.  Per chunk the two consumer warpgroups hand over twice
// through named barriers: O tells S that it has read the state copies, P
// and n (barrier 1); S tells O that P, its state copies, n and K6's den
// are written (barrier 2).  No atomics: every output is written once,
// every sum in a fixed order.
#pragma once

#include "common.cuh"
#include "hopper_common.cuh"
#include "mlstm_common.cuh"

namespace repro {
namespace mlstm {
namespace tc {

using namespace repro::hopper;
using repro::NEG_INF;

constexpr int L = 64;             // rows a chunk: one wgmma M
constexpr int MAXP = 6;           // panels of 64 columns: D, DV <= 384
constexpr int STAGES = 3;         // (X, Y) panel pairs in the ring
constexpr int THREADS = 384;
constexpr int PANEL = 64 * 128;   // bytes of a 64 x 64 bf16 panel
constexpr int NMAX = 64 * MAXP;   // n's entries at most (float32)

enum Mode { FWD = 0, DV = 1, DQ = 2, DK = 3 };

// per-row arrays of a chunk (float32), written by the gate warp
struct Rows {
    float u[L];      // b_t - m_t: row t's part of log W
    float v[L];      // log i_j - b_j: row j's part of log W
    float m[L];      // the stabiliser (K6's stats and den)
    float iw[L];     // weight of the carried state in each row (K6's qn)
    float oc[L];     // out's row coefficient
    float zc[L];     // Z's row coefficient
    float ad[L];     // DQ, DK: coefficient of n or dn in out
    float nc[L];     // DQ, DK: coefficient of T's rows in n's update
    float rden[L];   // backward: 1 / den (0 past S)
    float dqn[L];    // backward: dqn (0 past S)
    float decay;     // the carried state's decay over the chunk
};

// a chunk stage: T, Z hi, Z lo (64 x 64 bf16 each), the row arrays
constexpr int ROWS_BYTES = (int)((sizeof(Rows) + 1023) / 1024 * 1024);
constexpr int CSTAGE = 3 * PANEL + ROWS_BYTES;
// shared memory: alignment slack, the panel ring, two chunk stages, P (hi,
// lo), the state copies (hi, lo), n (K6's D entries, DQ's and DK's 64) and
// the 4 partial sums of its update, q . n (two buffers) and den, the
// barriers
constexpr int SMEM = 1024 + STAGES * 2 * PANEL + 2 * CSTAGE + 2 * PANEL +
                     2 * MAXP * PANEL + 4 * (5 * NMAX + 3 * L) +
                     8 * (2 * STAGES + 6);

// what a walk reads and writes besides its tiles
struct Params {
    const float* ip;        // input gate pre-activations (B, H, S)
    const float* fp;        // forget gate pre-activations (B, H, S)
    const float* m_saved;   // backward: the forward's m (B, H, S)
    const float* rden;      // backward: 1 / den (B, H, S)
    const float* dqn;       // backward: dqn (B, H, S)
    __nv_bfloat16* out;     // (B, H, S, Wout): h, dv, dq or dk
    float* m_out;           // K6: m and qn (B, H, S), or null
    float* qn_out;
    float* part;            // DQ, DK: U . out per row and tile (B, H, S, ntd)
    const __nv_bfloat16* u; // DQ: q, DK: k (B, H, S, Wout)
    int S, Wout, ntd;
    float scale;            // D^-0.5
    FinalState fin;         // K6 for serving: the final state, or nulls
};

// The gate arrays of rows [c0, c0 + 64) from the pre-activations and the
// stabiliser carried in, as the reference's _mlstm_kernel computes them:
// b = cumsum(log f), m_t = max(m_prev + b_t, max_{j<=t}(log i_j - b_j) +
// b_t).  One warp, rows 2 lane and 2 lane + 1; rows at or past S are
// masked (log i = NEG_INF, log f = 0).  The sums and differences run in
// float64: over 64 rows of strong forgetting b reaches hundreds, and m_t
// is the small difference of two such numbers, which float32 would leave
// off by an ulp of b (3e-5 at b = -384).  What leaves is float32: m, the
// weights, and u = b - m, v = log i - b, the two halves of log W.
struct Gates64 {
    float u[2], v[2], m[2], iw[2], wk[2];
    float decay, m_end;
};

// The inputs of one lane's two rows of a chunk, loaded a chunk ahead of
// their use: the gate pre-activations (NEG_INF and 0 past S) and, in the
// backward, the stabiliser carried in, 1 / den and dqn (0 past S).
struct RowIn {
    float ip[2], fp[2], rden[2], dqn[2];
    float m_prev;
};

__device__ __forceinline__ RowIn load_rows(const float* ip, const float* fp,
                                           const float* m_saved,
                                           const float* rden,
                                           const float* dqn, int c0, int S) {
    const int lane = threadIdx.x & 31;
    RowIn in;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int t = c0 + 2 * lane + e;
        const bool live = t < S;
        in.ip[e] = live ? ip[t] : NEG_INF;
        in.fp[e] = live ? fp[t] : 0.f;
        in.rden[e] = live && rden ? rden[t] : 0.f;
        in.dqn[e] = live && dqn ? dqn[t] : 0.f;
    }
    in.m_prev = m_saved && c0 ? m_saved[c0 - 1] : NEG_INF;
    return in;
}

__device__ __forceinline__ Gates64 chunk_gates64(const RowIn& in, int c0,
                                                 int S, float m_prev) {
    const int lane = threadIdx.x & 31;
    Gates64 g;
    double li[2], lf[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const float f = in.fp[e];
        li[e] = in.ip[e];
        // log sigmoid; 0 past S (the state kept)
        lf[e] = c0 + 2 * lane + e < S
            ? fminf(f, 0.f) - log1pf(expf(-fabsf(f))) : 0.f;
    }
    double x = lf[0] + lf[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    double excl = __shfl_up_sync(0xffffffffu, x, 1);
    if (lane == 0) excl = 0.0;
    const double b[2] = {excl + lf[0], x};
    const double c0v = li[0] - b[0];
    double mx = fmax(c0v, li[1] - b[1]);
    const double own = mx;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const double y = __shfl_up_sync(0xffffffffu, mx, o);
        if (lane >= o) mx = fmax(mx, y);
    }
    double exm = __shfl_up_sync(0xffffffffu, mx, 1);
    if (lane == 0) exm = NEG_INF;
    const double cm[2] = {fmax(exm, c0v), fmax(exm, own)};
    double m[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) m[e] = fmax(m_prev + b[e], cm[e] + b[e]);
    const double m_end = __shfl_sync(0xffffffffu, m[1], 31);
    const double b_end = __shfl_sync(0xffffffffu, b[1], 31);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        g.m[e] = (float)m[e];
        g.u[e] = (float)(b[e] - m[e]);
        g.v[e] = (float)(li[e] - b[e]);
        g.iw[e] = expf((float)(m_prev + b[e] - m[e]));
        g.wk[e] = expf((float)(b_end - b[e] + li[e] - m_end));
    }
    g.m_end = (float)m_end;
    g.decay = expf((float)(m_prev + b_end - m_end));
    return g;
}

// two floats as bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// 64 x 64 float32 accumulator -> its hi and lo bf16 panels in the 128-byte
// swizzle (the layout a TMA box or a K-major wgmma operand has): thread t
// of the warpgroup holds rows 16 w + l / 4 (+ 8), columns 8 i + 2 (l % 4)
// (+ 1)
__device__ __forceinline__ void store_pair(uint8_t* hi, uint8_t* lo,
                                           const float (&d)[32], int t) {
    const int r0 = 16 * (t >> 5) + ((t & 31) >> 2), c2 = 2 * (t & 3);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const uint32_t at = sw128(r0 + 8 * r, 8 * i + c2);
            split_bf16(d[4 * i + 2 * r], d[4 * i + 2 * r + 1],
                       *reinterpret_cast<uint32_t*>(hi + at),
                       *reinterpret_cast<uint32_t*>(lo + at));
        }
}

__device__ __forceinline__ void bf16x2_at(const uint8_t* panel, int r, int c,
                                          float& lo, float& hi) {
    const __nv_bfloat162 x =
        *reinterpret_cast<const __nv_bfloat162*>(panel + sw128(r, c));
    lo = __low2float(x);
    hi = __high2float(x);
}

// The block's shared memory, carved from the dynamic allocation.
struct Smem {
    uint8_t* ring;     // STAGES x (X panel, Y panel)
    uint8_t* cst;      // two chunk stages: T, Z hi, Z lo, the row arrays
    uint8_t* Ps;       // P hi, then P lo
    uint8_t* Sc;       // state copies: panel pp's hi at 2 pp, lo at 2 pp + 1
    float* n;          // K6's n (D), DQ's n or DK's dn (the tile's 64)
    float* npart;      // its update's partial sums, one a warp of S: 4 x NMAX
    float* qdn;        // K6's q . n per row, two buffers of L
    float* den;        // K6's den per row
    uint64_t* pfull;   // the panel ring's barriers
    uint64_t* pempty;
    uint64_t* cfull;   // the chunk stages' barriers, and T's arrival
    uint64_t* cempty;
    uint64_t* tbar;

    __device__ explicit Smem(uint8_t* base) {
        ring = align_1024(base);
        cst = ring + STAGES * 2 * PANEL;
        Ps = cst + 2 * CSTAGE;
        Sc = Ps + 2 * PANEL;
        n = reinterpret_cast<float*>(Sc + 2 * MAXP * PANEL);
        npart = n + NMAX;
        qdn = npart + 4 * NMAX;
        den = qdn + 2 * L;
        pfull = reinterpret_cast<uint64_t*>(den + L);
        pempty = pfull + STAGES;
        cfull = pempty + STAGES;
        cempty = cfull + 2;
        tbar = cempty + 2;
    }
    __device__ uint8_t* T(int s) const { return cst + s * CSTAGE; }
    __device__ uint8_t* Z(int s) const { return T(s) + PANEL; }
    __device__ Rows* R(int s) const {
        return reinterpret_cast<Rows*>(T(s) + 3 * PANEL);
    }
};

// first row of the i-th chunk a walk visits
template <int MODE>
__device__ __forceinline__ int chunk_start(int i, int nchunks) {
    return (MODE == DV || MODE == DK ? nchunks - 1 - i : i) * L;
}

// The panel ring's producer: one thread issues every (X, Y) panel pair,
// chunk after chunk, as the consumers free the slots.
template <int MODE, int P>
__device__ __forceinline__ void load_panels(const Smem& sm,
                                            const CUtensorMap* mx,
                                            const CUtensorMap* my,
                                            int nchunks, int h, int b) {
    tma_prefetch_map(mx);
    tma_prefetch_map(my);
    for (int i = 0; i < nchunks; ++i) {
        const int c0 = chunk_start<MODE>(i, nchunks);
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
            const int g = i * P + pp, slot = g % STAGES;
            mbar_wait(&sm.pempty[slot], ((g / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(&sm.pfull[slot], 2 * PANEL);
            uint8_t* dst = sm.ring + slot * 2 * PANEL;
            tma_load_4d(dst, mx, &sm.pfull[slot], 64 * pp, c0, h, b);
            tma_load_4d(dst + PANEL, my, &sm.pfull[slot], 64 * pp, c0, h, b);
        }
    }
}

// The gate warp: per chunk the gates, the row arrays, T by TMA, and Z =
// zc * T as hi and lo.
template <int MODE>
__device__ __forceinline__ void make_chunks(const Smem& sm,
                                            const CUtensorMap* mt,
                                            const Params& p, size_t bh,
                                            int nchunks, int h, int b,
                                            int tile) {
    const int lane = threadIdx.x & 31, S = p.S;
    const float* ip = p.ip + bh * S;
    const float* fp = p.fp + bh * S;
    const float* ms = MODE == FWD ? nullptr : p.m_saved + bh * S;
    const float* rd = MODE == FWD ? nullptr : p.rden + bh * S;
    const float* dq = MODE == FWD ? nullptr : p.dqn + bh * S;
    float m_carry = NEG_INF;
    RowIn in = load_rows(ip, fp, ms, rd, dq, chunk_start<MODE>(0, nchunks),
                         S);
    for (int i = 0; i < nchunks; ++i) {
        const int c0 = chunk_start<MODE>(i, nchunks), s = i & 1;
        // the next chunk's inputs, in flight while this one is made
        const int i1 = i + 1 < nchunks ? i + 1 : i;
        const RowIn next = load_rows(ip, fp, ms, rd, dq,
                                     chunk_start<MODE>(i1, nchunks), S);
        uint8_t* T = sm.T(s);
        uint8_t* Z = sm.Z(s);
        Rows* R = sm.R(s);
        mbar_wait(&sm.cempty[s], ((i >> 1) & 1) ^ 1);
        if (lane == 0) {
            mbar_arrive_expect_tx(&sm.tbar[s], PANEL);
            tma_load_4d(T, mt, &sm.tbar[s], 64 * tile, c0, h, b);
        }
        const Gates64 g = chunk_gates64(in, c0, S,
                                        MODE == FWD ? m_carry : in.m_prev);
        m_carry = g.m_end;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int r = 2 * lane + e;
            const float rden = in.rden[e], dqn = in.dqn[e];
            const float qcoef = p.scale * g.iw[e] * rden;
            R->u[r] = g.u[e];
            R->v[r] = g.v[e];
            R->m[r] = g.m[e];
            R->iw[r] = g.iw[e];
            R->rden[r] = rden;
            R->dqn[r] = dqn;
            R->oc[r] = MODE == FWD ? p.scale * g.iw[e]
                     : MODE == DQ  ? g.iw[e] * rden
                                   : g.wk[e];
            R->zc[r] = (MODE == FWD || MODE == DQ) ? g.wk[e] : qcoef;
            R->ad[r] = MODE == DQ ? g.iw[e] * dqn : g.wk[e];
            R->nc[r] = MODE == DQ ? g.wk[e] : p.scale * g.iw[e] * dqn;
        }
        if (lane == 0) R->decay = g.decay;
        __syncwarp();
        mbar_wait(&sm.tbar[s], (i >> 1) & 1);
        // Z = zc * T as hi and lo, chunk by chunk of 16 bytes (a row's 8
        // chunks are permuted by the swizzle, not moved to other rows)
        for (int idx = lane; idx < PANEL / 16; idx += 32) {
            const float zc = R->zc[idx >> 3];
            const uint4 x = reinterpret_cast<const uint4*>(T)[idx];
            const uint32_t* xs = reinterpret_cast<const uint32_t*>(&x);
            uint4 yh, yl;
            uint32_t* hs = reinterpret_cast<uint32_t*>(&yh);
            uint32_t* ls = reinterpret_cast<uint32_t*>(&yl);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const __nv_bfloat162 pr =
                    *reinterpret_cast<const __nv_bfloat162*>(&xs[j]);
                split_bf16(zc * __low2float(pr), zc * __high2float(pr),
                           hs[j], ls[j]);
            }
            reinterpret_cast<uint4*>(Z)[idx] = yh;
            reinterpret_cast<uint4*>(Z + PANEL)[idx] = yl;
        }
        fence_proxy_async();  // Z, for the consumers' wgmma
        mbar_arrive(&sm.cfull[s]);
        in = next;
    }
    // K6's final m: the stabiliser after the last chunk
    if (MODE == FWD && p.fin.m != nullptr && tile == 0 && lane == 0)
        p.fin.m[bh] = m_carry;
}

// A consumer warpgroup: ROLE 0 is O (out and its epilogue), 1 is S (the
// scores, the weights, P, K6's n and qn).  Each holds the state tiles of
// the panels ROLE, ROLE + 2, ... in float32 registers.
template <int MODE, int P, int ROLE>
__device__ __forceinline__ void consume(const Smem& sm, const Params& p,
                                        size_t bh, int nchunks, int tile) {
    constexpr bool TRANS = MODE == DV || MODE == DK;  // scores [key, query]
    constexpr bool HAS_U = MODE == DQ || MODE == DK;
    constexpr bool IS_S = ROLE == 1;
    constexpr int NT = (P - ROLE + 1) / 2;  // state tiles held
    const int S = p.S;
    const int t = threadIdx.x & 127, lane = t & 31, w = t >> 5;
    const int r0 = 16 * w + (lane >> 2), c2 = 2 * (lane & 3);  // and r0 + 8
    float st[NT > 0 ? NT : 1][32];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) st[j][e] = 0.f;

    for (int i = 0; i < nchunks; ++i) {
        const int c0 = chunk_start<MODE>(i, nchunks), s = i & 1;
        const uint8_t* T = sm.T(s);
        const uint8_t* Z = sm.Z(s);
        const Rows* R = sm.R(s);
        mbar_wait(&sm.cfull[s], (i >> 1) & 1);
        mbar_wait(&sm.tbar[s], (i >> 1) & 1);
        const float decay = R->decay;
        float* qdn = sm.qdn + (i & 1) * L;
        float acc[32];  // S: the scores; O: out
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] = 0.f;
        float qd = 0.f;  // K6, S: q . n of row t / 2, half t % 2
        // K6, S: this thread's part of n's update, columns 2 lane (+ 1) of
        // each panel over rows 16 w .. 16 w + 15
        float nacc[P][2];
#pragma unroll
        for (int pp = 0; pp < P; ++pp) nacc[pp][0] = nacc[pp][1] = 0.f;
        // the state decays over the chunk before any product of the chunk
        // accumulates into it; then no instruction but a wgmma touches an
        // accumulator until the chunk's last wait, so the groups pipeline
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 32; ++e) st[j][e] *= decay;
        fence_regs(acc);
#pragma unroll
        for (int j = 0; j < NT; ++j) fence_regs(st[j]);
#pragma unroll
        for (int pp = 0; pp < P; ++pp) {
            const int g = i * P + pp, slot = g % STAGES;
            mbar_wait(&sm.pfull[slot], (g / STAGES) & 1);
            const uint8_t* X = sm.ring + slot * 2 * PANEL;
            const uint8_t* Y = X + PANEL;
            wgmma_fence();
            if (IS_S) {  // scores += X Y^T
#pragma unroll
                for (int kk = 0; kk < 4; ++kk)
                    wgmma_ss<0>(acc, desc_k_major(X + kk * 32),
                                desc_k_major(Y + kk * 32), 1);
            } else {  // out += X (St hi + St lo)^T
#pragma unroll
                for (int half = 0; half < 2; ++half)
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        wgmma_ss<0>(acc, desc_k_major(X + kk * 32),
                                    desc_k_major(sm.Sc +
                                                 (2 * pp + half) * PANEL +
                                                 kk * 32), 1);
            }
            if ((pp & 1) == ROLE) {  // St += (Z hi + Z lo)^T Y
#pragma unroll
                for (int half = 0; half < 2; ++half)
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        wgmma_ss<1, 1>(
                            st[pp / 2],
                            desc_mn_major(Z + half * PANEL + kk * 16 * 128,
                                          PANEL),
                            desc_mn_major(Y + kk * 16 * 128, PANEL), 1);
            }
            wgmma_commit();
            if (MODE == FWD && IS_S) {
                // q . n over this panel (n before the chunk), and this
                // warp's rows of n's update: sum_r wk_r k_r
                const int row = t >> 1, half = t & 1;
                const float* np = sm.n + 64 * pp;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int ch = 4 * half + k;
                    const uint4 x = *reinterpret_cast<const uint4*>(
                        X + row * 128 + ((ch ^ row) & 7) * 16);
                    const __nv_bfloat162* xs =
                        reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        qd += __low2float(xs[j]) * np[8 * ch + 2 * j];
                        qd += __high2float(xs[j]) * np[8 * ch + 2 * j + 1];
                    }
                }
#pragma unroll
                for (int rr = 0; rr < 16; ++rr) {
                    const int r = 16 * w + rr;
                    float lo, hi;
                    bf16x2_at(Y, r, 2 * lane, lo, hi);
                    nacc[pp][0] += R->zc[r] * lo;
                    nacc[pp][1] += R->zc[r] * hi;
                }
                __syncwarp();
            }
            wgmma_wait<1>();
            if (pp > 0 && lane == 0)
                mbar_arrive(&sm.pempty[(g - 1) % STAGES]);
        }
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int j = 0; j < NT; ++j) fence_regs(st[j]);
        if (lane == 0) mbar_arrive(&sm.pempty[(i * P + P - 1) % STAGES]);

        if (IS_S) {
            // P from the scores: element e is row a = r0 + 8 ((e / 2) % 2),
            // column bcol = 8 (e / 4) + c2 + e % 2
            float rs[2] = {0.f, 0.f};
#pragma unroll
            for (int e = 0; e < 32; ++e) {
                const int a = r0 + 8 * ((e >> 1) & 1);
                const int bcol = 8 * (e >> 2) + c2 + (e & 1);
                const int tq = TRANS ? bcol : a, kj = TRANS ? a : bcol;
                const float wt = kj <= tq ? expf(R->u[tq] + R->v[kj]) : 0.f;
                float x = acc[e];
                if (MODE == FWD) x = x * p.scale * wt;
                if (MODE == DV) x = x * p.scale * wt * R->rden[tq];
                if (MODE == DQ) x = (x * R->rden[tq] + R->dqn[tq]) * wt;
                if (MODE == DK)
                    x = p.scale * (x * R->rden[tq] + R->dqn[tq]) * wt;
                acc[e] = x;
                rs[(e >> 1) & 1] += x;
            }
            if (MODE == FWD) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
                    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
                }
                qd += __shfl_xor_sync(0xffffffffu, qd, 1);
                if ((t & 1) == 0) qdn[t >> 1] = qd;
#pragma unroll
                for (int pp = 0; pp < P; ++pp) {
                    sm.npart[w * NMAX + 64 * pp + 2 * lane] = nacc[pp][0];
                    sm.npart[w * NMAX + 64 * pp + 2 * lane + 1] = nacc[pp][1];
                }
                // q . n of every row and the parts of n written; every
                // read of the old n done
                named_barrier(3, 128);
                for (int d = t; d < 64 * P; d += 128) {
                    const float* pa = sm.npart + d;
                    sm.n[d] = decay * sm.n[d] + ((pa[0] + pa[NMAX]) +
                                                 (pa[2 * NMAX] + pa[3 * NMAX]));
                }
            }
            if (HAS_U) {
                // n's update over T: this warp's rows, columns 2 lane (+ 1)
                float a0 = 0.f, a1 = 0.f;
#pragma unroll
                for (int rr = 0; rr < 16; ++rr) {
                    const int r = 16 * w + rr;
                    float lo, hi;
                    bf16x2_at(T, r, 2 * lane, lo, hi);
                    a0 += R->nc[r] * lo;
                    a1 += R->nc[r] * hi;
                }
                sm.npart[w * NMAX + 2 * lane] = a0;
                sm.npart[w * NMAX + 2 * lane + 1] = a1;
                named_barrier(3, 128);  // the parts of n written
            }
            // O has read the state copies, P and (DQ, DK) n
            named_barrier(1, 256);
            if (HAS_U && t < 64) {
                const float* pa = sm.npart + t;
                sm.n[t] = decay * sm.n[t] + ((pa[0] + pa[NMAX]) +
                                             (pa[2 * NMAX] + pa[3 * NMAX]));
            }
            if (MODE == FWD && (lane & 3) == 0) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    const int a = r0 + 8 * r;
                    const float qn = p.scale * R->iw[a] * qdn[a] + rs[r];
                    sm.den[a] = fmaxf(fabsf(qn), expf(-R->m[a]));
                    if (p.m_out != nullptr && tile == 0 && c0 + a < S) {
                        p.m_out[bh * S + c0 + a] = R->m[a];
                        p.qn_out[bh * S + c0 + a] = qn;
                    }
                }
            }
            store_pair(sm.Ps, sm.Ps + PANEL, acc, t);
#pragma unroll
            for (int j = 0; j < NT; ++j) {
                const int pp = 2 * j + 1;
                store_pair(sm.Sc + 2 * pp * PANEL,
                           sm.Sc + (2 * pp + 1) * PANEL, st[j], t);
            }
            fence_proxy_async();
            named_barrier_arrive(2, 256);
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.cempty[s]);
            continue;
        }

        // O: out's coefficients (with n before S updates it), its state
        // copies, then out += P T
#pragma unroll
        for (int e = 0; e < 32; ++e) {
            const int a = r0 + 8 * ((e >> 1) & 1);
            acc[e] *= R->oc[a];
            if (HAS_U) acc[e] += R->ad[a] * sm.n[8 * (e >> 2) + c2 + (e & 1)];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            const int pp = 2 * j;
            store_pair(sm.Sc + 2 * pp * PANEL, sm.Sc + (2 * pp + 1) * PANEL,
                       st[j], t);
        }
        fence_proxy_async();
        named_barrier_arrive(1, 256);
        named_barrier(2, 256);  // P, S's state copies and den written
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int half = 0; half < 2; ++half)  // out += (P hi + P lo) T
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_ss<1>(acc, desc_k_major(sm.Ps + half * PANEL + kk * 32),
                            desc_mn_major(T + kk * 16 * 128, PANEL), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        // the epilogue: the float32 out tile into P's two panels (read:
        // 64 rows of 256 bytes, 32-byte granules XOR-ed with the row), then
        // row by row: the row's multiplier, DQ's and DK's U . out from the
        // float32 values, and 16-byte stores of bf16
        float* Of = reinterpret_cast<float*>(sm.Ps);
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int a = r0 + 8 * r;
                *reinterpret_cast<float2*>(Of + a * 64 + ((i8 ^ a) & 7) * 8 +
                                           c2) =
                    make_float2(acc[4 * i8 + 2 * r], acc[4 * i8 + 2 * r + 1]);
            }
        named_barrier(4, 128);  // the out tile written
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            // 8 lanes a row (a 16-byte chunk each), 4 rows a warp
            const int idx = t + 128 * k, a = idx >> 3, ch = idx & 7;
            const bool live = c0 + a < S;
            const size_t at = (bh * S + c0 + a) * p.Wout + 64 * tile + 8 * ch;
            const float* src = Of + a * 64 + ((ch ^ a) & 7) * 8;
            const float4 x0 = *reinterpret_cast<const float4*>(src);
            const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
            const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
            if (HAS_U) {
                uint4 u = make_uint4(0u, 0u, 0u, 0u);
                if (live) u = *reinterpret_cast<const uint4*>(p.u + at);
                const __nv_bfloat162* u2 =
                    reinterpret_cast<const __nv_bfloat162*>(&u);
                float dot = 0.f;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    dot += __low2float(u2[j]) * x[2 * j] +
                           __high2float(u2[j]) * x[2 * j + 1];
#pragma unroll
                for (int o = 1; o < 8; o <<= 1)
                    dot += __shfl_xor_sync(0xffffffffu, dot, o);
                if (ch == 0 && live)
                    p.part[(bh * S + c0 + a) * p.ntd + tile] =
                        MODE == DQ ? dot * p.scale : dot;
            }
            const float mul = MODE == FWD ? 1.f / sm.den[a]
                            : MODE == DQ  ? p.scale
                                          : 1.f;
            uint4 y;
            y.x = pack_bf16(x[0] * mul, x[1] * mul);
            y.y = pack_bf16(x[2] * mul, x[3] * mul);
            y.z = pack_bf16(x[4] * mul, x[5] * mul);
            y.w = pack_bf16(x[6] * mul, x[7] * mul);
            if (live) *reinterpret_cast<uint4*>(p.out + at) = y;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&sm.cempty[s]);
    }
    if (MODE == FWD && p.fin.C != nullptr) {
        // K6's final state: this warpgroup's tiles of C^T (rows the DV
        // columns of this block, columns D in panel pp), and, from S, n
        // (each thread the entries it updated last)
        const int D = 64 * P;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 32; ++e) {
                const int a = r0 + 8 * ((e >> 1) & 1);
                const int d = 64 * (2 * j + ROLE) + 8 * (e >> 2) + c2 + (e & 1);
                p.fin.C[(bh * D + d) * p.Wout + 64 * tile + a] = st[j][e];
            }
        if (IS_S && tile == 0)
            for (int d = t; d < D; d += 128) p.fin.n[bh * D + d] = sm.n[d];
    }
}

// The walk of one block (tile `tile` of 64 columns, head blockIdx.y, batch
// blockIdx.z) in mode MODE over P panels; `smem` is the block's dynamic
// shared memory.
template <int MODE, int P>
__device__ __forceinline__ void walk(uint8_t* smem, const CUtensorMap* mx,
                                     const CUtensorMap* my,
                                     const CUtensorMap* mt, const Params& p,
                                     int tile) {
    const Smem sm(smem);
    const int h = blockIdx.y, b = blockIdx.z;
    const size_t bh = (size_t)b * gridDim.y + h;
    const int nchunks = (p.S + L - 1) / L;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&sm.pfull[s], 1);
            mbar_init(&sm.pempty[s], 8);  // the consumers' 8 warps
        }
        for (int s = 0; s < 2; ++s) {
            mbar_init(&sm.cfull[s], 32);  // the gate warp's lanes
            mbar_init(&sm.cempty[s], 8);
            mbar_init(&sm.tbar[s], 1);
        }
        mbar_fence_init();
    }
    // the state copies start at zero (the first chunk's product reads them,
    // times a coefficient that may be 0), as does n
    for (int i = threadIdx.x; i < 2 * P * PANEL / 16; i += THREADS)
        reinterpret_cast<uint4*>(sm.Sc)[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = threadIdx.x; i < NMAX; i += THREADS) sm.n[i] = 0.f;
    fence_proxy_async();  // the zeros, for wgmma
    __syncthreads();

    // the warpgroup, broadcast from lane 0 so that the compiler sees it
    // uniform across the warp
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    if (wg == 2) {
        setmaxnreg_dec<56>();
        const int warp = (threadIdx.x - 256) >> 5;
        if (warp == 0 && (threadIdx.x & 31) == 0)
            load_panels<MODE, P>(sm, mx, my, nchunks, h, b);
        else if (warp == 1)
            make_chunks<MODE>(sm, mt, p, bh, nchunks, h, b, tile);
        return;
    }
    setmaxnreg_inc<224>();
    if (wg == 1)
        consume<MODE, P, 1>(sm, p, bh, nchunks, tile);
    else
        consume<MODE, P, 0>(sm, p, bh, nchunks, tile);
}

}  // namespace tc
}  // namespace mlstm
}  // namespace repro
