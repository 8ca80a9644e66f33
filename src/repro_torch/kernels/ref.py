"""Plain PyTorch versions of the attention kernels.

These are the reference semantics of the port's CUDA kernels, written
as the reference package's ``kernels/ref.py`` writes them: the same
masks, float32 scores and softmax, ``NEG_INF = -1e30`` for masked
scores, and unmapped (``-1``) pages clamped to pool page 0.  On a CPU
tensor the kernel wrappers return these; ``chip_smoke.py`` holds each
kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KH, D)
    v: torch.Tensor,  # (B, T, KH, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid kv length (decode)
) -> torch.Tensor:
    """Multi-head attention with GQA, causal / sliding-window masking.

    ``q_offset`` is the absolute position of q[0] (prefill continuation /
    decode).  ``kv_len`` masks out cache slots >= kv_len[b]."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float() * (D ** -0.5)
    kf = k.float()
    vf = v.float()
    qf = qf.reshape(B, S, KH, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, kf)  # (B, KH, G, S, T)

    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    mask_b = mask.expand(B, 1, 1, S, T)
    if kv_len is not None:
        mask_b = mask_b & (kpos[None, None, None, None, :]
                           < kv_len[:, None, None, None, None])
    scores = torch.where(mask_b, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vf)
    return out.reshape(B, S, H, D).to(q.dtype)


def paged_attention(
    q: torch.Tensor,           # (B, 1, H, D) — one decode token per slot
    k_pool: torch.Tensor,      # (KH, P, page, D) global page pool
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32; -1 = unmapped
    kv_len: torch.Tensor,      # (B,) live tokens per slot
) -> torch.Tensor:
    """Paged decode attention: gather each slot's pages into a dense
    ``(B, max_pages*page, KH, D)`` view and run the masked dense version.
    Token ``t`` of slot ``b`` lives at
    ``pool[:, page_table[b, t // page], t % page]``; positions at or past
    ``kv_len[b]`` (every dead ``-1`` page included, clamped to page 0) are
    masked out."""
    B = q.shape[0]
    KH, _, page, D = k_pool.shape
    max_pages = page_table.shape[1]
    pt = page_table.long().clamp(min=0)
    # (KH, B, max_pages, page, D) -> (B, T, KH, D)
    k = k_pool[:, pt].permute(1, 2, 3, 0, 4).reshape(B, max_pages * page, KH, D)
    v = v_pool[:, pt].permute(1, 2, 3, 0, 4).reshape(B, max_pages * page, KH, D)
    return attention(q, k, v, causal=False, window=0, kv_len=kv_len)
