// Device code shared by K6 (mlstm_scan.cu) and K6-bwd (mlstm_scan_bwd.cu):
// the chunk length and tiles, the staging of a chunk into shared memory,
// the within-chunk weights computed from the gates, the pairwise dot
// products of a chunk, and the walk over the chunks of a DV tile (the
// forward, and the backward's dv).
//
// Layout (the reference's): q, k (B, H, S, D), v and h (B, H, S, DV), the
// gate pre-activations (B, H, S) as float32, the per-row stats m and qn
// (B, H, S) float32.  D and DV are multiples of 8 up to 384.
#pragma once

#include "common.cuh"

namespace repro {
namespace mlstm {

constexpr int L = 32;         // rows per chunk (one warp lane per row)
constexpr int TILE = 64;      // DV columns (forward, dv) or D rows (dq, dk)
constexpr int THREADS = 256;  // 8 warps
constexpr int MAXDIM = 384;   // largest D and DV taken

// floats of shared memory of the DV-tiled walk (C slice D x TILE, n, the
// q and k rows of a chunk padded to D + 4, the v or dO tile, the chunk's
// scores, the gate arrays and two scalars)
__host__ __device__ constexpr int vtile_floats(int D) {
    return D * TILE + D + 2 * L * (D + 4) + L * TILE + L * (L + 1) + 6 * L + 4;
}

// floats of shared memory of the D-tiled walk (C rows TILE x (DV + 4), n,
// the v and dO rows of a chunk padded to DV + 4, two TILE-wide row tiles,
// the chunk's pair matrix, the gate arrays and two scalars)
__host__ __device__ constexpr int dtile_floats(int DV) {
    return TILE * (DV + 4) + TILE + 2 * L * (DV + 4) + 2 * L * (TILE + 4) +
           L * (L + 1) + 6 * L + 4;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float s, float4 x) {
    acc.x += s * x.x; acc.y += s * x.y; acc.z += s * x.z; acc.w += s * x.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
}

// The gate arrays of one chunk in shared memory.
struct Gates {
    float* li;    // log input gate (NEG_INF past S)
    float* b;     // cumulative log forget gate within the chunk
    float* m;     // stabiliser of each row
    float* iw;    // weight of the carried state in each row
    float* wk;    // weight of each row in the end-of-chunk state
    float* row;   // a per-row value (qn in the forward, dqn in dq/dk)
    float* sc;    // [0] the carried state's decay, [1] the chunk's last m

    __device__ Gates(float* base)
        : li(base), b(base + L), m(base + 2 * L), iw(base + 3 * L),
          wk(base + 4 * L), row(base + 5 * L), sc(base + 6 * L) {}

    // W[t, j] = exp(b_t - b_j + log_i_j - m_t), for j <= t
    __device__ __forceinline__ float w(int t, int j) const {
        return expf(b[t] - b[j] + li[j] - m[t]);
    }
};

// Warp 0 computes the chunk's gate arrays from the pre-activations of
// rows [c0, c0 + L) and the stabiliser m_prev carried into the chunk, as
// the reference's _mlstm_kernel does: b = cumsum(log f), m_t =
// max(m_prev + b_t, max_{j<=t}(log i_j - b_j) + b_t).  Rows at or past S
// are masked: log i = NEG_INF (no contribution), log f = 0 (state kept).
// Returns the chunk's last m (in every lane).
__device__ __forceinline__ float chunk_gates(const float* ip, const float* fp,
                                             int c0, int S, float m_prev,
                                             Gates g) {
    const int lane = threadIdx.x & 31;
    const int t = c0 + lane;
    float li = NEG_INF, lf = 0.f;
    if (t < S) {
        li = ip[t];
        const float f = fp[t];
        lf = fminf(f, 0.f) - log1pf(expf(-fabsf(f)));  // log sigmoid
    }
    float b = lf;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float x = __shfl_up_sync(0xffffffffu, b, o);
        if (lane >= o) b += x;
    }
    float cm = li - b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float x = __shfl_up_sync(0xffffffffu, cm, o);
        if (lane >= o) cm = fmaxf(cm, x);
    }
    const float m = fmaxf(m_prev + b, cm + b);
    const float m_end = __shfl_sync(0xffffffffu, m, 31);
    const float b_end = __shfl_sync(0xffffffffu, b, 31);
    g.li[lane] = li;
    g.b[lane] = b;
    g.m[lane] = m;
    g.iw[lane] = expf(m_prev + b - m);
    g.wk[lane] = expf(b_end - b + li - m_end);
    if (lane == 0) {
        g.sc[0] = expf(m_prev + b_end - m_end);
        g.sc[1] = m_end;
    }
    return m_end;
}

// Rows [c0, c0 + L) of a row-major (S, W) slab, columns [col0, col0 +
// width), into dst (row stride P floats) as float32, times mul and, if
// rowmul is given, times rowmul[row].  Rows at or past S and columns at or
// past W are zero.  width, W and col0 are multiples of 8.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int P, const T* src, int W,
                                      int S, int c0, int col0, int width,
                                      float mul, const float* rowmul) {
    const int groups = width / 8;
    for (int idx = threadIdx.x; idx < L * groups; idx += THREADS) {
        const int r = idx / groups, c = (idx - r * groups) * 8;
        float x[8];
        if (c0 + r < S && col0 + c < W) {
            load8(src + (size_t)(c0 + r) * W + col0 + c, x);
            const float s = rowmul ? mul * rowmul[c0 + r] : mul;
#pragma unroll
            for (int e = 0; e < 8; ++e) x[e] *= s;
        } else {
            zero8(x);
        }
        st4(dst + r * P + c, make_float4(x[0], x[1], x[2], x[3]));
        st4(dst + r * P + c + 4, make_float4(x[4], x[5], x[6], x[7]));
    }
}

// The chunk's pairwise dot products A[r] . B[j] over len (a multiple of 4)
// columns, rows of stride P: thread (r = tid / 8, cg = tid % 8) returns
// those of row r against rows j = cg + 8 c, c = 0..3.
__device__ __forceinline__ void pair_dots(const float* A, const float* B,
                                          int P, int len, float acc[4]) {
    const int r = threadIdx.x >> 3, cg = threadIdx.x & 7;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = 0.f;
    const float* arow = A + r * P;
    for (int d = 0; d < len; d += 4) {
        const float4 a = ld4(arow + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] += dot4(a, ld4(B + (cg + 8 * c) * P + d));
    }
}

// Where K6 writes the final state for serving (all null: not asked for):
// C (B, H, D, DV), n (B, H, D) and m (B, H), float32.
struct FinalState {
    float* C;
    float* n;
    float* m;
};

// The walk over the chunks of one DV tile (columns [v0, v0 + TILE)) of one
// (batch, head), one block of THREADS threads.
//
// Forward (BWD = false), the chunkwise mLSTM: per chunk, S = (q k^T) * W,
// qn_t = iw_t q_t . n + sum_j S[t, j], h_t = (iw_t q_t C + S v) / max(|qn_t|,
// exp(-m_t)); then C = c_decay C + (k * wk)^T v and n likewise.  C's slice
// (D x TILE) and n stay in shared memory for the whole walk; every tile
// recomputes the scores and n, which cost little beside C.  Tile 0 writes
// each row's m and qn when stats are asked for.
//
// With `fin` (forward only), the walk also writes the final state: its
// (D, TILE) slice of C, and (tile 0) n and the last row's m, the
// sequential oracle's (C, n, m) after the last row (the chunkwise m is the
// oracle's: both are max_j (log i_j + the log forgets after j)).
//
// Backward's dv (BWD = true), in reverse chunk order, carrying dC's slice:
// dv_j = sum_t S[t, j] dO_t + wk_j k_j dC, then dC = c_decay dC +
// (q * iw)^T dO, with dO_t = dh_t * rden_t.
template <typename T, bool BWD>
__device__ void vtile_walk(float* smem, const T* __restrict__ q,
                           const T* __restrict__ k, const T* __restrict__ x,
                           const float* __restrict__ ip,
                           const float* __restrict__ fp,
                           const float* __restrict__ m_saved,
                           const float* __restrict__ rden,
                           T* __restrict__ out, float* __restrict__ m_out,
                           float* __restrict__ qn_out, FinalState fin, int S,
                           int D, int DV, float scale) {
    const int DP = D + 4;
    float* Cs = smem;                // D x TILE
    float* ns = Cs + D * TILE;       // D
    float* Qs = ns + D;              // L x DP
    float* Ks = Qs + L * DP;         // L x DP
    float* Xs = Ks + L * DP;         // L x TILE: v (forward) or dO (dv)
    float* Ss = Xs + L * TILE;       // L x (L + 1)
    Gates g(Ss + L * (L + 1));

    const int tid = threadIdx.x, warp = tid >> 5;
    const int v0 = blockIdx.x * TILE;
    const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
    const T* qb = q + bh * S * D;
    const T* kb = k + bh * S * D;
    const T* xb = x + bh * S * DV;
    const float* ib = ip + bh * S;
    const float* fb = fp + bh * S;
    const float* rb = BWD ? rden + bh * S : nullptr;
    T* ob = out + bh * S * DV;

    for (int i = tid; i < D * TILE; i += THREADS) Cs[i] = 0.f;
    for (int i = tid; i < D; i += THREADS) ns[i] = 0.f;
    float m_prev = NEG_INF;  // warp 0's carry (forward)

    const int nchunks = (S + L - 1) / L;
    const int t = tid >> 3, vg = tid & 7;  // output row, column group
    for (int ci = 0; ci < nchunks; ++ci) {
        const int c = BWD ? nchunks - 1 - ci : ci;
        const int c0 = c * L;
        __syncthreads();  // the previous chunk's reads are done
        stage(Qs, DP, qb, D, S, c0, 0, D, scale, nullptr);
        stage(Ks, DP, kb, D, S, c0, 0, D, 1.f, nullptr);
        stage(Xs, TILE, xb, DV, S, c0, v0, TILE, 1.f, rb);
        if (warp == 0) {
            if (BWD) m_prev = c0 ? m_saved[bh * S + c0 - 1] : NEG_INF;
            m_prev = chunk_gates(ib, fb, c0, S, m_prev, g);
        }
        __syncthreads();

        // S[r, j] = (q_r . k_j) W[r, j] for j <= r
        {
            float acc[4];
            pair_dots(Qs, Ks, DP, D, acc);
            const int r = tid >> 3, cg = tid & 7;
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                const int j = cg + 8 * cc;
                Ss[r * (L + 1) + j] = j <= r ? acc[cc] * g.w(r, j) : 0.f;
            }
        }
        __syncthreads();

        if (!BWD) {
            // qn_r = iw_r (q_r . n) + sum_j S[r, j]: warp w, rows 4w..4w+3
            const int lane = tid & 31;
            for (int r = warp * 4; r < warp * 4 + 4; ++r) {
                float a = 0.f;
                for (int d = lane; d < D; d += 32) a += Qs[r * DP + d] * ns[d];
                float s = Ss[r * (L + 1) + lane];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) {
                    a += __shfl_xor_sync(0xffffffffu, a, o);
                    s += __shfl_xor_sync(0xffffffffu, s, o);
                }
                if (lane == 0) {
                    const float qn = g.iw[r] * a + s;
                    g.row[r] = qn;
                    if (m_out && blockIdx.x == 0 && c0 + r < S) {
                        m_out[bh * S + c0 + r] = g.m[r];
                        qn_out[bh * S + c0 + r] = qn;
                    }
                }
            }
        }

        // row t, columns v0 + 4 vg + 32 i (i = 0, 1):
        //   forward  iw_t q_t C + sum_j S[t, j] v_j
        //   dv       wk_t k_t dC + sum_r S[r, t] dO_r
        float4 inter[2], intra[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            inter[i] = make_float4(0.f, 0.f, 0.f, 0.f);
            intra[i] = inter[i];
        }
        const float* arow = (BWD ? Ks : Qs) + t * DP;
        for (int d = 0; d < D; ++d) {
            const float a = arow[d];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                fma4(inter[i], a, ld4(Cs + d * TILE + 4 * vg + 32 * i));
        }
        for (int j = 0; j < L; ++j) {
            const float s = BWD ? Ss[j * (L + 1) + t] : Ss[t * (L + 1) + j];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                fma4(intra[i], s, ld4(Xs + j * TILE + 4 * vg + 32 * i));
        }
        __syncthreads();  // qn written; every read of C done
        const float coef = BWD ? g.wk[t] : g.iw[t];
        const float den = BWD ? 1.f : fmaxf(fabsf(g.row[t]), expf(-g.m[t]));
        if (c0 + t < S) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                const int col = v0 + 4 * vg + 32 * i;
                if (col < DV) {
                    T* o = ob + (size_t)(c0 + t) * DV + col;
                    store(o + 0, (coef * inter[i].x + intra[i].x) / den);
                    store(o + 1, (coef * inter[i].y + intra[i].y) / den);
                    store(o + 2, (coef * inter[i].z + intra[i].z) / den);
                    store(o + 3, (coef * inter[i].w + intra[i].w) / den);
                }
            }
        }

        // the update's left operand: forward k * wk, dv q * iw (in place:
        // neither is read again in this chunk)
        float* Us = BWD ? Qs : Ks;
        const float* ucoef = BWD ? g.iw : g.wk;
        for (int i = tid; i < L * D; i += THREADS) {
            const int r = i / D, d = i - r * D;
            Us[r * DP + d] *= ucoef[r];
        }
        __syncthreads();
        // C[d, cols] = c_decay C[d, cols] + sum_r U[r, d] X[r, cols]
        const float c_decay = g.sc[0];
        for (int d = tid >> 3; d < D; d += THREADS / 8) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
                for (int r = 0; r < L; ++r)
                    fma4(acc, Us[r * DP + d], ld4(Xs + r * TILE + 4 * vg + 32 * i));
                float* cp = Cs + d * TILE + 4 * vg + 32 * i;
                float4 cv = ld4(cp);
                cv.x = c_decay * cv.x + acc.x;
                cv.y = c_decay * cv.y + acc.y;
                cv.z = c_decay * cv.z + acc.z;
                cv.w = c_decay * cv.w + acc.w;
                st4(cp, cv);
            }
        }
        if (!BWD) {
            for (int d = tid; d < D; d += THREADS) {
                float acc = 0.f;
                for (int r = 0; r < L; ++r) acc += Ks[r * DP + d];
                ns[d] = c_decay * ns[d] + acc;
            }
        }
    }
    if (!BWD && fin.C != nullptr) {
        __syncthreads();  // the last chunk's update of C and n
        for (int i = tid; i < D * TILE; i += THREADS) {
            const int d = i / TILE, col = v0 + i % TILE;
            if (col < DV) fin.C[(bh * D + d) * DV + col] = Cs[i];
        }
        if (blockIdx.x == 0) {
            for (int d = tid; d < D; d += THREADS) fin.n[bh * D + d] = ns[d];
            if (tid == 0) fin.m[bh] = g.sc[1];
        }
    }
}

}  // namespace mlstm
}  // namespace repro
