"""Plain PyTorch versions of the attention kernels.

These are the reference semantics of the port's CUDA kernels, written
as the reference package's ``kernels/ref.py`` writes them: the same
masks, float32 scores and softmax, ``NEG_INF = -1e30`` for masked
scores, and unmapped (``-1``) pages clamped to pool page 0.  On a CPU
tensor the kernel wrappers return these; ``chip_smoke.py`` holds each
kernel against them on the card.

:func:`attention_fwd` and :func:`attention_bwd` are K1's training pair,
the plain counterparts of ``_fwd``/``_bwd_vjp`` in the reference's
``kernels/flash_xla.py``: the forward also returns the per-row
log-sum-exp, and the backward recomputes the probabilities from it.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _masked_scores(q, k, causal, window, q_offset):
    """float32 scores ``(B, KH, G, S, T)`` of ``q * D**-0.5`` against k,
    ``NEG_INF`` where the causal / window mask rules a pair out."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, S, KH, H // KH, D) * (D ** -0.5)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        mask &= qpos[:, None] - kpos[None, :] < window
    return torch.where(mask, s, NEG_INF)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`attention` that also returns the per-row log-sum-exp of the
    masked float32 scores: ``(out (B, S, H, D), lse (B, S, H) float32)``,
    what the reference's ``flash_xla._fwd`` returns (its lse is
    ``(B, S, KH, G)``, the same numbers with the head split)."""
    B, S, H, D = q.shape
    s = _masked_scores(q, k, causal, window, q_offset)
    lse = torch.logsumexp(s, dim=-1)  # (B, KH, G, S)
    probs = torch.exp(s - lse[..., None])
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    lse = lse.permute(0, 3, 1, 2).reshape(B, S, H).contiguous()
    return out.reshape(B, S, H, D).to(q.dtype), lse


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                  causal: bool = True, window: int = 0, q_offset: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward from the saved ``(q, k, v, out, lse)``, as
    ``flash_xla._bwd_vjp`` computes it: ``delta = sum_d dO * O``,
    ``P = exp(s - lse)``, ``dV = P^T dO``, ``dS = P * (dO V^T - delta)``,
    ``dQ = dS K * scale``, ``dK = dS^T Q * scale``.  dK and dV sum over
    the G query heads of each KV head.  Returns ``(dq, dk, dv)`` in the
    input dtypes."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = D ** -0.5
    s = _masked_scores(q, k, causal, window, q_offset)
    lse5 = lse.float().reshape(B, S, KH, G).permute(0, 2, 3, 1)[..., None]
    p = torch.exp(s - lse5)  # (B, KH, G, S, T)
    dof = do.float().reshape(B, S, KH, G, D)
    delta = (do.float() * out.float()).sum(-1).reshape(B, S, KH, G)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    dp = torch.einsum("bskgd,btkd->bkgst", dof, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.float()) * scale
    qf = q.float().reshape(B, S, KH, G, D)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def decode_attention_mq(
    q: torch.Tensor,         # (B, T, H, D) — T = k+1 draft positions
    k: torch.Tensor,         # (B, S_max, KH, D) cache (draft rows written)
    v: torch.Tensor,
    base_len: torch.Tensor,  # (B,) kv length visible to query row 0
) -> torch.Tensor:
    """Multi-query decode attention for speculative verify: query row
    ``t`` sits at absolute position ``base_len[b] - 1 + t`` and sees the
    cache positions ``< base_len[b] + t`` — a causal limit per row.  Row
    0 is single-token decode attention with ``kv_len = base_len``."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, S, KH, G, D) * (D ** -0.5)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    kpos = torch.arange(T, device=q.device)
    limit = base_len.to(q.device)[:, None] + torch.arange(S, device=q.device)
    mask = kpos[None, None, :] < limit[:, :, None]  # (B, S, T)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def paged_attention_mq(
    q: torch.Tensor,           # (B, T, H, D) — T = k+1 draft positions
    k_pool: torch.Tensor,      # (KH, P, page, D) global page pool
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32; -1 = unmapped
    base_len: torch.Tensor,    # (B,) kv length visible to query row 0
) -> torch.Tensor:
    """Paged verify attention: the dense gather of
    :func:`paged_attention` with the per-row causal limits of
    :func:`decode_attention_mq`."""
    B = q.shape[0]
    KH, _, page, D = k_pool.shape
    max_pages = page_table.shape[1]
    pt = page_table.long().clamp(min=0)
    k = k_pool[:, pt].permute(1, 2, 3, 0, 4).reshape(B, max_pages * page, KH, D)
    v = v_pool[:, pt].permute(1, 2, 3, 0, 4).reshape(B, max_pages * page, KH, D)
    return decode_attention_mq(q, k, v, base_len)
