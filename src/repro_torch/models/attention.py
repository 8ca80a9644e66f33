"""GQA attention: projections, the train path and the decode-time cache
paths.

Counterpart of the reference package's ``models/attention.py``.
Projection weights keep the reference's 4-D shapes — ``wq (D, H, Dh)``,
``wk``/``wv (D, KH, Dh)``, ``wo (H, Dh, D)`` — so bridged weights map one
to one.  ``p`` always holds one layer's parameters (no leading layer
axis).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rope_angles


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('bsd,dhk->bshk')`` as one matmul on the flattened heads."""
    D, H, K = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * K)).unflatten(-1, (H, K))


def qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
        prefix: str = "attn"):
    """x: (B, S, D) -> q (B, S, H, Dh), k/v (B, S, KH, Dh)."""
    dt = x.dtype
    q = _proj(x, p[f"{prefix}_wq"])
    k = _proj(x, p[f"{prefix}_wk"])
    v = _proj(x, p[f"{prefix}_wv"])
    if cfg.qkv_bias:
        q = q + p[f"{prefix}_bq"].to(dt)
        k = k + p[f"{prefix}_bk"].to(dt)
        v = v + p[f"{prefix}_bv"].to(dt)
    return q, k, v


def out_proj(p: Dict[str, torch.Tensor], attn: torch.Tensor,
             prefix: str = "attn") -> torch.Tensor:
    """``einsum('bshk,hkd->bsd')``."""
    H, K, D = p[f"{prefix}_wo"].shape
    return attn.flatten(-2) @ p[f"{prefix}_wo"].to(attn.dtype).reshape(H * K, D)


def attend_train(p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cfg: ModelConfig, *, causal: bool = True, window: int = 0,
                 use_rope: bool = True, prefix: str = "attn") -> torch.Tensor:
    """Full-sequence attention of the train path: x ``(B, S, D)`` normed
    -> ``(B, S, D)``.  RoPE over ``arange(S)``, then
    :func:`repro_torch.kernels.ops.flash_attention` (K1 forward, K1-bwd
    backward on the card), then the output projection."""
    q, k, v = qkv(p, x, cfg, prefix)
    if use_rope:
        cos, sin = rope_angles(torch.arange(x.shape[1], device=x.device),
                               cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return out_proj(p, out, prefix)


def cross_kv(p: Dict[str, torch.Tensor], enc: torch.Tensor,
             prefix: str = "xattn"):
    """Cross-attention K/V of the encoder states ``(B, T, D)``: each
    ``(B, T, KH, Dh)``, no bias (as the reference)."""
    return _proj(enc, p[f"{prefix}_wk"]), _proj(enc, p[f"{prefix}_wv"])


def attend_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: torch.Tensor, cfg: ModelConfig, *,
                  use_rope: bool = True,
                  prefix: str = "attn") -> torch.Tensor:
    """One-token attention against a dense cache ``(B, S_max, KH, Dh)``.

    The new token's K/V is written at ``pos`` in place (the reference
    returns updated copies; the port updates the cache it was given),
    then the read is the plain dense decode attention masked by
    ``kv_len = pos + 1``.  A parked slot's ``pos`` keeps advancing while
    other slots decode and can pass the cache's end, where the
    reference's scatter drops the write; here it is clamped into the
    slot's own last row, which only a parked slot can reach and the next
    admission rewrites.  ``use_rope=False`` (the encoder-decoder, whose
    positions are sinusoidal) skips the rotation."""
    B = x.shape[0]
    q, k, v = qkv(p, x, cfg, prefix)  # (B, 1, *, Dh)
    if use_rope:
        cos, sin = rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    bidx = torch.arange(B, device=x.device)
    idx = pos.long().clamp(max=cache_k.shape[1] - 1)
    cache_k[bidx, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, idx] = v[:, 0].to(cache_v.dtype)
    out = ops.decode_attention(q, cache_k, cache_v, kv_len=pos + 1)
    return out_proj(p, out, prefix)


def attend_decode_paged(p: Dict[str, torch.Tensor], x: torch.Tensor,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        page_table: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig, prefix: str = "attn") -> torch.Tensor:
    """One-token attention against this layer's paged KV pool
    ``(KH, P, page, Dh)``.

    The new token's K/V is scattered into physical page
    ``page_table[b, pos[b] // page]`` at offset ``pos[b] % page``, in
    place with ``index_put_`` (the reference returns updated pools).
    Parked rows (table entries -1) clamp to the null page 0, which the
    engine never allocates, so a retired slot's writes land there.  The
    read goes through :func:`repro_torch.kernels.ops.paged_decode_attention`,
    masked by ``kv_len = pos + 1``."""
    B = x.shape[0]
    page = k_pool.shape[2]
    max_pages = page_table.shape[1]
    q, k, v = qkv(p, x, cfg, prefix)  # (B, 1, *, Dh)
    cos, sin = rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    bidx = torch.arange(B, device=x.device)
    pos = pos.long()
    slot = torch.clamp(pos // page, 0, max_pages - 1)
    pid = page_table[bidx, slot].long().clamp(min=0)  # -1 -> null page 0
    off = pos % page
    # pool is (KH, P, page, Dh); write the (KH, B, Dh) token K/V at
    # [:, pid, off] in place (an index_put_ on the layer's pool view)
    k_pool[:, pid, off] = k[:, 0].to(k_pool.dtype).transpose(0, 1)
    v_pool[:, pid, off] = v[:, 0].to(v_pool.dtype).transpose(0, 1)
    out = ops.paged_decode_attention(q, k_pool, v_pool, page_table,
                                     kv_len=(pos + 1).to(torch.int32))
    return out_proj(p, out, prefix)


def attend_verify(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: torch.Tensor, cfg: ModelConfig,
                  prefix: str = "attn") -> torch.Tensor:
    """Speculative-verify attention against a dense cache: the ``T = k+1``
    rows of ``x (B, T, D)`` sit at ``pos .. pos + T - 1`` (RoPE per row at
    those positions), their K/V is written there in place, and row ``t``
    sees the positions ``< pos + t + 1``.  The write index is clamped to
    ``S_max - 1``, as in the reference: a parked slot whose frozen ``pos``
    sits near the cache's end writes into its own dead last row."""
    B, T = x.shape[:2]
    q, k, v = qkv(p, x, cfg, prefix)  # (B, T, *, Dh)
    positions = pos[:, None] + torch.arange(T, device=x.device)  # (B, T)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    bidx = torch.arange(B, device=x.device)[:, None]
    idx = positions.long().clamp(0, cache_k.shape[1] - 1)
    cache_k[bidx, idx] = k.to(cache_k.dtype)
    cache_v[bidx, idx] = v.to(cache_v.dtype)
    out = ops.decode_attention_mq(q, cache_k, cache_v, base_len=pos + 1)
    return out_proj(p, out, prefix)


def attend_verify_paged(p: Dict[str, torch.Tensor], x: torch.Tensor,
                        k_pool: torch.Tensor, v_pool: torch.Tensor,
                        page_table: torch.Tensor, pos: torch.Tensor,
                        cfg: ModelConfig, prefix: str = "attn") -> torch.Tensor:
    """Speculative-verify attention against this layer's paged pool
    ``(KH, P, page, Dh)``: the multi-row sibling of
    :func:`attend_decode_paged`.  Position ``pos + t`` is written in place
    into physical page ``page_table[b, (pos + t) // page]`` with the
    reference's clamps — the table slot to ``[0, max_pages - 1]``, a -1
    entry to the null page 0 — so parked slots' writes are absorbed as
    their decode writes are.  The read goes through
    :func:`repro_torch.kernels.ops.paged_decode_attention_mq` with
    ``base_len = pos + 1``."""
    B, T = x.shape[:2]
    page = k_pool.shape[2]
    max_pages = page_table.shape[1]
    q, k, v = qkv(p, x, cfg, prefix)  # (B, T, *, Dh)
    positions = pos[:, None] + torch.arange(T, device=x.device)  # (B, T)
    cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    positions = positions.long()
    bidx = torch.arange(B, device=x.device)[:, None]
    slot = torch.clamp(positions // page, 0, max_pages - 1)
    pid = page_table[bidx, slot].long().clamp(min=0)  # -1 -> null page 0
    off = positions % page
    # (B, T, KH, Dh) -> (KH, B, T, Dh) written at [:, pid, off]
    k_pool[:, pid, off] = k.to(k_pool.dtype).permute(2, 0, 1, 3)
    v_pool[:, pid, off] = v.to(v_pool.dtype).permute(2, 0, 1, 3)
    out = ops.paged_decode_attention_mq(q, k_pool, v_pool, page_table,
                                        base_len=(pos + 1).to(torch.int32))
    return out_proj(p, out, prefix)
