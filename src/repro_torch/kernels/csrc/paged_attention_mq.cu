// Paged multi-query verify attention (K3) for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernel `paged_attention_mq_bkgd` / `_paged_mq_kernel` of
// src/repro/kernels/paged_attention.py: speculative verify scores the
// T = k+1 draft positions of every slot in one pass over that slot's K/V,
// read through the page table.  Query row (t, h) of slot b, with
// h = kh * G + g, sees the kv positions < base_len[b] + t (a causal limit
// per row); the T * G rows of a KV head are packed as row = t * G + g, the
// TPU kernel's packing, read straight from the (B, T, H, D) layout.  The
// page walk is paged_common.cuh's, shared with K2 (K2 is this kernel at
// T = 1, bit for bit under the same split): its header says what bounds it
// on the H100 and what its design does about it.  The rows are tiled over
// blocks: tiles of 64 rows on the tensor cores (glm4-9b's 144 rows at
// spec_k 8 run as 3), and on the FMA walk the fewest balanced tiles that
// fit in one block's shared memory (128 rows at D = 128, 43 at D = 256).
// A tile walks kv positions only up to what its last row sees, so tiles
// re-read the pages their rows share.
#include "paged_common.cuh"

// q (B, T, KH * G, D), pools (KH, P, page, D), page_table (B, max_pages),
// base_len (B,), out like q; dtype 0 = float32, 1 = bfloat16; `splits` and
// `partials` (B * KH * splits * T * G * (D + 2) float32 values when
// splits > 1) as in repro_paged_attention.  Returns a cudaError_t.
extern "C" int repro_paged_attention_mq(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* page_table,
                                        const void* base_len, void* out,
                                        int B, int Tq, int KH, int G, int D,
                                        int P, int page, int max_pages,
                                        float scale, int dtype, void* stream,
                                        int splits, void* partials) {
    return (int)repro::paged::launch(
        q, k_pool, v_pool, page_table, base_len, out, B, Tq, KH, G, D, P,
        page, max_pages, scale, dtype, splits, partials,
        static_cast<cudaStream_t>(stream));
}

// rows of one row tile of a launch for rows = T * G at head dim d, page
// size and dtype (0 = float32, 1 = bfloat16)
extern "C" int repro_paged_attention_mq_tile_rows(int rows, int d, int page,
                                                  int dtype) {
    return repro::paged::tile_rows(rows, d, page, dtype);
}
