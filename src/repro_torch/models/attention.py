"""GQA attention: projections, the train path and the decode-time cache
paths.

Counterpart of the reference package's ``models/attention.py``.
Projection weights keep the reference's 4-D shapes — ``wq (D, H, Dh)``,
``wk``/``wv (D, KH, Dh)``, ``wo (H, Dh, D)`` — so bridged weights map one
to one.  ``p`` always holds one layer's parameters (no leading layer
axis).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rope_angles
from repro_torch.parallel import collectives, tensor


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
                 use_rope: bool = True, prefix: str = "attn",
                 kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention of the train path: x ``(B, S, D)`` normed
    -> ``(B, S, D)``.  RoPE over ``arange(S)``, then
    :func:`repro_torch.kernels.ops.flash_attention` (K1 forward, K1-bwd
    backward on the card), then the output projection.  ``kv`` ``(B, T,
    D)`` makes it cross attention: K and V projected from ``kv`` (the
    encoder's states), no biases and no RoPE, as the reference's.

    Under a split over ``model`` (``parallel/tensor.py``) the inputs'
    gradients are summed over ``model``, and the rank computes by
    ``"heads"`` its ``H/m`` query heads (its blocks of ``wq``, ``bq`` and
    ``wo``) against the KV heads they read, the output projection's terms
    summed over ``model``; by ``"seq"`` its ``S/m`` query rows (RoPE at
    their global positions) against the whole K and V through K1's
    ``q_offset`` (which a non-causal call ignores), the output rows
    gathered back over ``model``.  The mode is this call's
    (``Split.attn_mode`` of its ``S``)."""
    return _attend(p, x, cfg, causal=causal, window=window,
                   use_rope=use_rope, prefix=prefix, kv=kv)[0]


def attend_prefill(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig, block: Tuple[int, int], *,
                   window: int = 0, use_rope: bool = True,
                   prefix: str = "attn",
                   kv: Optional[torch.Tensor] = None):
    """The prefill's attention, as :func:`attend_train` computes it
    (under a split the rank's heads or query rows; causal self-attention,
    ``window`` 0 = global, or with ``kv`` the cross attention over the
    encoder's states), and the cache's entries at the positions ``block
    = (start, n)`` of its K/V source: ``(out, k, v)``, k (RoPE'd where
    ``use_rope``) and v ``(B, n, KH, Dh)`` of every KV head.  Where the
    rank's own K and V already hold every KV head they are sliced; where
    it projected only its heads' KV heads (attention by heads), its ``n``
    positions are projected for all of them from the rows it holds alike
    (``wk`` and ``wv`` are held alike), with no collective."""
    return _attend(p, x, cfg, causal=kv is None, window=window,
                   use_rope=use_rope, prefix=prefix, kv=kv, block=block)


def _attend(p, x, cfg, *, causal, window, use_rope, prefix, kv,
            block: Optional[Tuple[int, int]] = None):
    """``(out, k, v)``: :func:`attend_train`'s output and, for a
    ``block``, :func:`attend_prefill`'s cache entries (else None)."""
    assert kv is None or not use_rope
    sp = tensor.active()
    S = x.shape[1]
    mode = None if sp is None else sp.attn_mode(S)
    hl = p[f"{prefix}_wq"].shape[1]  # the query heads this rank holds
    h0, off, n = 0, 0, S  # its first head, its query rows
    if mode == "heads":
        assert hl * sp.size == cfg.num_heads, (hl, sp.size, cfg.num_heads)
        h0 = sp.rank * hl
    elif mode == "seq":
        assert S % sp.size == 0, (S, sp.size)
        n = S // sp.size
        off = sp.rank * n
    if mode is not None:
        x = sp.sum_grad(x)
        if kv is not None:
            kv = sp.sum_grad(kv)
    src = x if kv is None else kv
    dt = x.dtype
    w, idx = _kv_heads(p, cfg, h0, hl, prefix)
    q = _proj(x if n == S else x.narrow(1, off, n), p[f"{prefix}_wq"])
    k = _proj(src, w["wk"])
    v = _proj(src, w["wv"])
    if cfg.qkv_bias and kv is None:
        q = q + p[f"{prefix}_bq"].to(dt)
        k = k + w["bk"].to(dt)
        v = v + w["bv"].to(dt)
    every_kv = idx is None and w["wk"] is p[f"{prefix}_wk"]
    if idx is not None:
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    if use_rope:
        cos, sin = rope_angles(torch.arange(S, device=x.device),
                               cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin) if n == S else \
            apply_rope(q, cos[off:off + n], sin[off:off + n])
        k = apply_rope(k, cos, sin)
    kc = vc = None
    if block is not None:
        start, size = block
        if every_kv:
            kc, vc = k.narrow(1, start, size), v.narrow(1, start, size)
        else:
            kc, vc = _kv_at(p, src, cfg, start, size, prefix,
                            rope=use_rope, bias=kv is None)
    out = out_proj(p, ops.flash_attention(q, k, v, causal=causal,
                                          window=window, q_offset=off), prefix)
    if mode == "heads":
        out = sp.reduce_sum(out)
    elif mode == "seq":
        out = sp.gather(out, 1)
    return out, kc, vc


def _kv_at(p, x: torch.Tensor, cfg: ModelConfig, start: int, n: int,
           prefix: str = "attn", rope: bool = True, bias: bool = True):
    """K (RoPE'd where ``rope``) and V of every KV head at positions
    ``start .. start+n-1`` of ``x`` (the biases where the config has
    them and ``bias``)."""
    dt = x.dtype
    xs = x.narrow(1, start, n)
    k = _proj(xs, p[f"{prefix}_wk"])
    v = _proj(xs, p[f"{prefix}_wv"])
    if cfg.qkv_bias and bias:
        k = k + p[f"{prefix}_bk"].to(dt)
        v = v + p[f"{prefix}_bv"].to(dt)
    if not rope:
        return k, v
    cos, sin = rope_angles(torch.arange(start, start + n, device=x.device),
                           cfg.head_dim, cfg.rope_theta)
    return apply_rope(k, cos, sin), v


def _kv_range(cfg: ModelConfig, h0: int, hl: int, device):
    """``(lo, hi, idx)``: the KV heads ``lo .. hi-1`` that the query
    heads ``h0 .. h0+hl-1`` read (query head ``h`` reads KV head ``h //
    (H / KH)``), and the index that gives one of them to each query head
    where the heads straddle KV groups unevenly (``index_select`` on the
    heads dim; None where they fall in equal groups)."""
    g = cfg.num_heads // cfg.num_kv_heads
    lo, hi = h0 // g, (h0 + hl - 1) // g + 1
    counts = {min((j + 1) * g, h0 + hl) - max(j * g, h0)
              for j in range(lo, hi)}
    idx = None
    if len(counts) > 1:
        idx = torch.arange(h0, h0 + hl, device=device) // g - lo
    return lo, hi, idx


def _kv_heads(p, cfg: ModelConfig, h0: int, hl: int, prefix: str):
    """``wk``, ``wv`` (and ``bk``, ``bv``) cut to the KV heads that the
    query heads ``h0 .. h0+hl-1`` read (the leaves themselves when that
    is all of them), and :func:`_kv_range`'s index."""
    lo, hi, idx = _kv_range(cfg, h0, hl, p[f"{prefix}_wk"].device)
    names = ("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv")
    kv = {n: p[f"{prefix}_{n}"] for n in names}
    if (lo, hi) != (0, cfg.num_kv_heads):
        kv = {n: t[lo:hi] if n[0] == "b" else t[:, lo:hi]
              for n, t in kv.items()}
    return kv, idx


def attend_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cache_k: torch.Tensor, cache_v: torch.Tensor,
                  pos: torch.Tensor, cfg: ModelConfig, *,
                  use_rope: bool = True, window: int = 0,
                  slot_pos: Optional[torch.Tensor] = None,
                  prefix: str = "attn", kv_blocks: int = 1) -> torch.Tensor:
    """One-token attention against a dense cache ``(B, S_max, KH, Dh)``.

    The new token's K/V is written at ``pos`` in place (the reference
    returns updated copies; the port updates the cache it was given),
    then the read is the plain dense decode attention masked by
    ``kv_len = pos + 1``.  A parked slot's ``pos`` keeps advancing while
    other slots decode and can pass the cache's end, where the
    reference's scatter drops the write; here it is clamped into the
    slot's own last row, which only a parked slot can reach and the next
    admission rewrites.  ``use_rope=False`` (the encoder-decoder, whose
    positions are sinusoidal) skips the rotation.

    ``window > 0`` (the hybrid's window layers) makes the cache a ring
    of ``S_max`` slots with ``slot_pos`` ``(B, S_max)`` the position each
    slot holds (-1: none yet): K/V and the position are written at
    ``pos % S_max`` in place, and the read sees the slots with ``0 <=
    slot_pos <= pos`` and ``pos - slot_pos < window``.  The reference's
    mask (``attention.py:126``) lacks ``0 <=``, so until a prompt plus its
    tokens fill the window its decode also attends to the zero K/V of
    slots that hold no position, and disagrees with its own forward; the
    port's decode computes the windowed attention its forward computes (a
    difference by design, ROADMAP §3).

    Under a serving split over ``model``, and with ``kv_blocks > 1`` on
    one device, a dense cache (``window`` 0) is read in sequence blocks:
    :func:`_attend_decode_blocks`.  A window layer's ring is read whole
    (``kv_blocks`` 1): under the split the serving layout holds it whole
    over ``model``, and every rank writes the same slot and reads every
    slot.  Its ``wk`` and ``wv`` are held alike, so every rank projects
    the new token's K/V of every KV head itself; where attention is split
    by heads the ranks' query heads are gathered over ``model``
    (``B·H·Dh`` values), every rank attends with all of them, keeps its
    heads for its rows of ``wo``, and the terms are summed over
    ``model``."""
    sp = tensor.active()
    if window == 0 and (kv_blocks > 1 or sp is not None):
        return _attend_decode_blocks(p, x, cache_k, cache_v, pos, cfg,
                                     kv_blocks, use_rope, prefix)
    if kv_blocks > 1:
        raise ValueError("a window layer's ring is read whole, not in "
                         "sequence blocks")
    heads = sp is not None and sp.attn_mode(1) == "heads"
    B = x.shape[0]
    q, k, v = qkv(p, x, cfg, prefix)  # (B, 1, *, Dh)
    if heads:
        q = collectives.all_gather_dim(q, 2, sp.mesh, tensor.AXIS)
    if use_rope:
        cos, sin = rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    bidx = torch.arange(B, device=x.device)
    if window > 0:
        idx = pos.long() % cache_k.shape[1]
        slot_pos[bidx, idx] = pos.to(slot_pos.dtype)
    else:
        idx = pos.long().clamp(max=cache_k.shape[1] - 1)
    cache_k[bidx, idx] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, idx] = v[:, 0].to(cache_v.dtype)
    if window > 0:
        at = pos[:, None]
        valid = (slot_pos >= 0) & (slot_pos <= at) & (at - slot_pos < window)
        out = ops.masked_decode_attention(q, cache_k, cache_v, valid)
    else:
        out = ops.decode_attention(q, cache_k, cache_v, kv_len=pos + 1)
    if heads:
        hl = p[f"{prefix}_wq"].shape[1]
        return sp.reduce_sum(out_proj(p, out.narrow(2, sp.rank * hl, hl),
                                      prefix))
    return out_proj(p, out, prefix)


def attend_cross_decode(p: Dict[str, torch.Tensor], x: torch.Tensor,
                        xk: torch.Tensor, xv: torch.Tensor, cfg: ModelConfig,
                        prefix: str = "xattn") -> torch.Tensor:
    """One token's cross attention over the whole cross cache ``xk``/
    ``xv`` ``(B, T, KH, Dh)`` (every frame valid), the plain read.  Under
    a split by heads the rank's query heads read the KV heads they map
    to (:func:`_kv_range`) and the output projection's terms over its
    rows of ``wo`` are summed over ``model``; unsplit, every rank reads
    every head."""
    sp = tensor.active()
    heads = sp is not None and sp.attn_mode(1) == "heads"
    q = _proj(x, p[f"{prefix}_wq"])  # (B, 1, H or H/m, Dh)
    if heads:
        hl = q.shape[2]
        lo, hi, idx = _kv_range(cfg, sp.rank * hl, hl, x.device)
        xk, xv = xk[:, :, lo:hi], xv[:, :, lo:hi]
        if idx is not None:
            xk, xv = xk.index_select(2, idx), xv.index_select(2, idx)
    xlen = torch.full((x.shape[0],), xk.shape[1], dtype=torch.int32,
                      device=x.device)
    out = out_proj(p, ops.decode_attention(q, xk, xv, kv_len=xlen), prefix)
    return sp.reduce_sum(out) if heads else out


def _attend_decode_blocks(p, x, cache_k, cache_v, pos, cfg, kv_blocks,
                          use_rope, prefix) -> torch.Tensor:
    """One-token attention against a dense cache read in sequence blocks,
    each block's partial softmax (``ops.decode_attention_partial``)
    merged by ``ops.merge_partials``: the decode of a cache whose
    sequence is split over ``model``, or, with ``kv_blocks`` on one
    device, the same arithmetic over that many blocks of a whole cache.

    Under the split ``cache_k``/``cache_v`` ``(B, S_max/m, KH, Dh)`` are
    this rank's block, positions ``rank·S_max/m ..`` (``Split.
    cache_block``: a cache laid out otherwise raises).  Every rank
    projects the new token's K/V (``wk`` and ``wv`` are held alike); the
    rank whose block holds ``pos`` writes it there, by a ``where`` on the
    row (no host sync), after today's clamp of a parked slot's ``pos``
    into the last row, which the last rank holds.  Attention split by
    heads gathers the ranks' query heads over ``model`` (``B·H·Dh``
    values); every rank reads all heads over its block, masked by global
    position ``< pos + 1``, and the blocks' ``(out, lse)`` are gathered
    over ``model`` (one all-gather) and merged.  By heads each rank then
    keeps its heads for its rows of ``wo`` and the terms are summed over
    ``model``; unsplit, ``wo`` is whole."""
    sp = tensor.active()
    B, T = x.shape[0], cache_k.shape[1]
    if sp is not None:
        if kv_blocks != 1:
            raise ValueError("under a split each rank reads its one block")
        start = sp.rank * sp.cache_block(T * sp.size)
        heads = sp.attn_mode(1) == "heads"
        total = T * sp.size
    else:
        start, heads, total = 0, False, T
    q, k, v = qkv(p, x, cfg, prefix)  # (B, 1, *, Dh)
    if heads:
        q = collectives.all_gather_dim(q, 2, sp.mesh, tensor.AXIS)
    if use_rope:
        cos, sin = rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    bidx = torch.arange(B, device=x.device)
    at = pos.long().clamp(max=total - 1) - start
    own = ((at >= 0) & (at < T))[:, None, None]
    at = at.clamp(0, T - 1)
    cache_k[bidx, at] = torch.where(own, k[:, 0].to(cache_k.dtype),
                                    cache_k[bidx, at])
    cache_v[bidx, at] = torch.where(own, v[:, 0].to(cache_v.dtype),
                                    cache_v[bidx, at])
    kpos = start + torch.arange(T, device=x.device)
    valid = kpos[None, :] < (pos + 1)[:, None]  # (B, T)
    n = kv_blocks
    if T % n:
        raise ValueError(f"{T} positions do not split into {n} blocks")
    out, lse = ops.decode_attention_partial(
        q if n == 1 else q.repeat_interleave(n, 0),
        cache_k.reshape(B * n, T // n, *cache_k.shape[2:]),
        cache_v.reshape(B * n, T // n, *cache_v.shape[2:]),
        valid.reshape(B * n, T // n))
    out = out.unflatten(0, (B, n)).movedim(1, 0)  # (n, B, H, Dh)
    lse = lse.unflatten(0, (B, n)).movedim(1, 0)
    if sp is not None:
        both = torch.cat([out, lse[..., None]], -1)
        both = collectives.all_gather_dim(both, 0, sp.mesh, tensor.AXIS)
        out, lse = both[..., :-1], both[..., -1]
    out = ops.merge_partials(out, lse).to(q.dtype)[:, None]  # (B, 1, H, Dh)
    if heads:
        hl = p[f"{prefix}_wq"].shape[1]
        return sp.reduce_sum(out_proj(p, out.narrow(2, sp.rank * hl, hl),
                                      prefix))
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
