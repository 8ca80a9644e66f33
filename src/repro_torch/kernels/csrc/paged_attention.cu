// Paged decode attention (K2) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `paged_attention_bkgd` / `_paged_kernel` of
// src/repro/kernels/paged_attention.py: one decode token per slot attends
// that slot's KV through a page table, masked at kv_len[b] (positions at or
// past it, the tail of the last page included, are masked; pages past it
// are never read).  K2 is K3 (paged_attention_mq.cu) at one draft row, so
// both run the page walk of paged_common.cuh, whose header says what bounds
// it on the H100 and what its design does about it: a split over the
// sequence with a deterministic merge; in bf16 at D 64 or 128 K/V pages
// loaded by TMA through the page table and the products on wgmma; an FMA
// walk otherwise.  kv_len[b] >= 1 in the engine (it decodes at pos + 1); a
// slot with kv_len 0 gets zeros, as the TPU kernel gives.
#include "paged_common.cuh"

// q (B, 1, KH * G, D), pools (KH, P, page, D), page_table (B, max_pages),
// kv_len (B,), out like q; dtype 0 = float32, 1 = bfloat16; `splits` the
// caller's split of the table (repro_paged_split_pages), `partials` a
// float32 scratch of B * KH * splits * G * (D + 2) values when splits > 1.
// Returns a cudaError_t (0 = success).
extern "C" int repro_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool,
                                     const void* page_table,
                                     const void* kv_len, void* out, int B,
                                     int KH, int G, int D, int P, int page,
                                     int max_pages, float scale, int dtype,
                                     void* stream, int splits,
                                     void* partials) {
    return (int)repro::paged::launch(
        q, k_pool, v_pool, page_table, kv_len, out, B, 1, KH, G, D, P, page,
        max_pages, scale, dtype, splits, partials,
        static_cast<cudaStream_t>(stream));
}

// 1 when K2 and K3 walk on the tensor cores for this head dim, page and
// dtype (0 = float32, 1 = bfloat16): bf16, D 64 or 128, a page of 8, 16,
// 32 or 64 rows or a multiple of 64.  The wrappers count by the same rule.
extern "C" int repro_paged_tensor_cores(int D, int page, int dtype) {
    return repro::paged::tensor_cores(D, page, dtype) ? 1 : 0;
}

// pages each of `splits` splits of a table of max_pages entries walks (a
// whole number of pages and of 64-token chunks), or 0 when `splits` does not
// cut it into that many non-empty ranges
extern "C" int repro_paged_split_pages(int max_pages, int page, int splits) {
    return repro::paged::split_pages(max_pages, page, splits);
}
