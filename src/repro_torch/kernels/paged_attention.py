"""K2: paged decode attention, a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel ``paged_attention_bkgd`` of the reference
package (``src/repro/kernels/paged_attention.py``); the CUDA source, with
what bounds it on the H100 and what its design does about it, is
``csrc/paged_attention.cu``.  The plain PyTorch version is
:func:`repro_torch.kernels.ref.paged_attention`.

:func:`paged_attention` chooses by the tensors' device: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel (or raises).
The decode token's queries arrive in the reference layout ``(B, 1, H, D)``
— in memory the TPU kernel's ``(B, KH, G, D)``, since query head
``h = kh * G + g`` — and the pools as ``(KH, P, page, D)``; ``D`` is
unpadded.  K2 is K3 at one draft row: both run the page walk of
``csrc/paged_common.cuh`` (:mod:`.paged_common`), split over the sequence
by a plan that reads no length on the host.  In bf16 at D 64 or 128 (and
a page of 8 to 64 rows or a multiple of 64) the walk runs on the tensor
cores, fed by TMA through the page table; otherwise on FMAs.  Each path
counts its launches (``tc_launches``, ``fma_launches``) beside
``launches``; ``merge_launches`` counts the launches that split the walk
and merged the splits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import paged_common, ref, work

# kernel launches since the last reset (a run resets them to 0 and reads
# them to show that its path went through the kernel), and by path
launches = 0
tc_launches = 0
fma_launches = 0
merge_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 32  # query heads per KV head the wrapper takes

plain = ref.paged_attention


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, page_table: torch.Tensor,
                         kv_len: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.  Raises on anything
    it does not take.  A dry call under a counter (:func:`work.dry`)
    counts and returns the output unlaunched."""
    global launches, tc_launches, fma_launches, merge_launches
    dry = work.dry(q)
    for name, x in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("kv_len", kv_len)):
        if x.device.type != "cuda" and not dry:
            raise ValueError(f"paged_attention_cuda needs CUDA tensors; "
                             f"{name} is on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if not dry and x.data_ptr() % 16 and x.is_floating_point():
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPES:
        raise ValueError(f"dtype {q.dtype} not supported "
                         f"(float32 or bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"pools must match q's dtype {q.dtype}")
    if page_table.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise ValueError("page_table and kv_len must be int32")
    if q.dim() != 4 or q.shape[1] != 1 or k_pool.dim() != 4:
        raise ValueError("q must be (B, 1, H, D) and pools (KH, P, page, D)")
    B, _, H, D = q.shape
    KH, P, page, _ = k_pool.shape
    if H % KH:
        raise ValueError(f"num_heads {H} must be a multiple of kv heads {KH}")
    G = H // KH
    if k_pool.shape != (KH, P, page, D) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be (KH, P, page, D) = ({KH}, P, page, "
                         f"{D}); got {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be ({B}, max_pages)")
    if kv_len.shape != (B,):
        raise ValueError(f"kv_len must be ({B},)")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"head_dim {D} must be a multiple of 8 in [8, 256]")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"group size {G} must be in [1, {MAX_GROUP}]")
    if work.counting():  # the lengths are read only when counting
        work.record("K2", B=B, T=1, H=H, KH=KH, D=D,
                    dtype=work.dtype_name(q.dtype), page=page,
                    max_pages=page_table.shape[1], base=work.lengths(kv_len))
    out, tc, splits = paged_common.launch(
        "repro_paged_attention", q, k_pool, v_pool, page_table, kv_len,
        (B, KH, G, D, P, page, page_table.shape[1]), dry=dry)
    if dry:
        return out
    launches += 1
    if tc:
        tc_launches += 1
    else:
        fma_launches += 1
    merge_launches += splits > 1
    return out


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, page_table: torch.Tensor,
                    kv_len: torch.Tensor) -> torch.Tensor:
    """q ``(B, 1, H, D)``, pools ``(KH, P, page, D)``, page_table
    ``(B, max_pages)`` int32 (-1 = unmapped), kv_len ``(B,)`` int32
    -> ``(B, 1, H, D)``."""
    if work.takes_plain(q):
        return plain(q, k_pool, v_pool, page_table, kv_len)
    return paged_attention_cuda(q, k_pool, v_pool, page_table, kv_len)
