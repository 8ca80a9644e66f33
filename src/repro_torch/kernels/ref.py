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
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell): the sequential oracle, and K6's and
# K6-bwd's plain versions.  Layout as the reference's: q/k ``(B, H, S, D)``,
# v ``(B, H, S, DV)``, gate pre-activations ``(B, H, S)``.
# ---------------------------------------------------------------------------
MLSTM_CHUNK = 32  # the chunk length of the CUDA kernels (csrc/mlstm_scan.cu)


def mlstm_scan(
    q: torch.Tensor,      # (B, H, S, D)
    k: torch.Tensor,      # (B, H, S, D)
    v: torch.Tensor,      # (B, H, S, DV)
    i_pre: torch.Tensor,  # (B, H, S) input-gate preactivation (exp gate)
    f_pre: torch.Tensor,  # (B, H, S) forget-gate preactivation (sigmoid)
    initial: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Stabilized mLSTM recurrence (xLSTM paper, eqs. 19-27), one step at
    a time, as the reference's ``ref.mlstm_scan``.  Returns h
    ``(B, H, S, DV)`` in v's dtype and the final float32 state
    ``(C (B, H, D, DV), n (B, H, D), m (B, H))``."""
    B, H, S, D = q.shape
    DV = v.shape[-1]
    scale = D ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    log_i = i_pre.float()
    log_f = F.logsigmoid(f_pre.float())
    if initial is None:
        C = torch.zeros((B, H, D, DV), dtype=torch.float32, device=q.device)
        n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
        m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    else:
        C, n, m = (x.float() for x in initial)
    hs = []
    for t in range(S):
        qt, kt, vt = qf[:, :, t], kf[:, :, t], vf[:, :, t]
        li, lf = log_i[:, :, t], log_f[:, :, t]
        m_new = torch.maximum(lf + m, li)
        f_sc = torch.exp(lf + m - m_new)[..., None]
        i_sc = torch.exp(li - m_new)[..., None]
        C = f_sc[..., None] * C + i_sc[..., None] * (kt[..., :, None]
                                                     * vt[..., None, :])
        n = f_sc * n + i_sc * kt
        qn = (n * qt).sum(-1) * scale
        denom = torch.maximum(qn.abs(), torch.exp(-m_new))
        hs.append(torch.einsum("bhd,bhdv->bhv", qt, C) * scale
                  / denom[..., None])
        m = m_new
    h = torch.stack(hs, dim=2).to(v.dtype)
    return h, (C, n, m)


def _mlstm_padded(chunk, S, *xs):
    """Each of ``xs`` ((B, H, S, ...) tensors) zero-padded along S to a
    multiple of ``chunk``."""
    pad = -S % chunk
    if not pad:
        return xs
    out = []
    for x in xs:
        widths = [0, 0] * (x.dim() - 3) + [0, pad]
        out.append(F.pad(x, widths))
    return out


def _mlstm_gates(i_pre, f_pre, chunk):
    """float32 ``log_i`` and ``log_f`` ``(B, H, S_pad)`` with the ragged
    edge masked as the kernel masks it: past S the input gate is
    ``NEG_INF`` (no contribution) and ``log_f`` is 0 (the state is kept)."""
    S = i_pre.shape[-1]
    pad = -S % chunk
    log_i = F.pad(i_pre.float(), (0, pad), value=NEG_INF)
    log_f = F.pad(F.logsigmoid(f_pre.float()), (0, pad), value=0.0)
    return log_i, log_f


def _mlstm_chunk_weights(li, lf, m_prev):
    """The within-chunk weights of one chunk, from its gates ``(B, H, L)``
    and the stabiliser carried into it ``(B, H)``: the cumulative
    log-forget ``b``, the stabiliser ``m`` of every row, the weight of
    the carried state in each row ``inter_w``, the masked intra-chunk
    matrix ``W[t, j] = exp(b_t - b_j + log_i_j - m_t)`` for ``j <= t``,
    each row's weight into the end-of-chunk state ``wk`` and the carried
    state's decay over the chunk ``c_decay`` — what ``_mlstm_kernel``
    computes in ``src/repro/kernels/mlstm_scan.py``."""
    L = li.shape[-1]
    b = torch.cumsum(lf, dim=-1)
    local_max = torch.cummax(li - b, dim=-1).values + b
    m = torch.maximum(m_prev[..., None] + b, local_max)
    inter_w = torch.exp(m_prev[..., None] + b - m)
    logw = b[..., :, None] - b[..., None, :] + li[..., None, :] - m[..., :, None]
    causal = torch.ones((L, L), dtype=torch.bool, device=li.device).tril()
    w = torch.where(causal, torch.exp(logw), 0.0)
    m_end = m[..., -1]
    wk = torch.exp(b[..., -1:] - b + li - m_end[..., None])
    c_decay = torch.exp(m_prev + b[..., -1] - m_end)
    return m, inter_w, w, wk, c_decay


def mlstm_scan_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    i_pre: torch.Tensor, f_pre: torch.Tensor, *,
    chunk: int = MLSTM_CHUNK, with_stats: bool = False,
):
    """K6's plain version: the chunkwise-parallel mLSTM of the reference's
    ``_mlstm_kernel``, one chunk of ``chunk`` rows at a time, the
    ``(C, n, m)`` carry in float32, a ragged S masked as
    :func:`_mlstm_gates` says.  Returns h ``(B, H, S, DV)`` in v's dtype;
    with ``with_stats`` also each row's stabiliser ``m`` and
    normaliser ``qn = q_t . n_t / sqrt(D)`` ``(B, H, S)`` float32, what
    the backward needs."""
    B, H, S, D = q.shape
    DV = v.shape[-1]
    scale = D ** -0.5
    qf, kf, vf = _mlstm_padded(chunk, S, q.float() * scale, k.float(),
                               v.float())
    log_i, log_f = _mlstm_gates(i_pre, f_pre, chunk)
    C = torch.zeros((B, H, D, DV), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    m_prev = torch.full((B, H), NEG_INF, dtype=torch.float32, device=q.device)
    hs, ms, qns = [], [], []
    for c0 in range(0, qf.shape[2], chunk):
        rows = slice(c0, c0 + chunk)
        qc, kc, vc = qf[:, :, rows], kf[:, :, rows], vf[:, :, rows]
        m, inter_w, w, wk, c_decay = _mlstm_chunk_weights(
            log_i[..., rows], log_f[..., rows], m_prev)
        s = (qc @ kc.transpose(-1, -2)) * w
        num = inter_w[..., None] * (qc @ C) + s @ vc
        qn = inter_w * (qc @ n[..., None])[..., 0] + s.sum(-1)
        denom = torch.maximum(qn.abs(), torch.exp(-m))
        hs.append(num / denom[..., None])
        ms.append(m)
        qns.append(qn)
        kw = kc * wk[..., None]
        C = c_decay[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = c_decay[..., None] * n + kw.sum(-2)
        m_prev = m[..., -1]
    h = torch.cat(hs, dim=2)[:, :, :S].to(v.dtype).contiguous()
    if not with_stats:
        return h
    return (h, torch.cat(ms, dim=2)[..., :S].contiguous(),
            torch.cat(qns, dim=2)[..., :S].contiguous())


def mlstm_scan_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    i_pre: torch.Tensor, f_pre: torch.Tensor, h: torch.Tensor,
    m: torch.Tensor, qn: torch.Tensor, dh: torch.Tensor, *,
    chunk: int = MLSTM_CHUNK,
) -> Tuple[torch.Tensor, ...]:
    """K6-bwd's plain version: the gradients ``(dq, dk, dv, d i_pre,
    d f_pre)`` of :func:`mlstm_scan_chunked`'s h, from its inputs, its
    output ``h`` and stats ``m``, ``qn`` and the incoming ``dh``, each in
    its input's dtype.

    The stabiliser is held constant: h does not depend on it (every
    sequence of ``m`` gives the same h), so its gradient path adds
    nothing.  With ``v' = [v, 1]`` and the state ``C' = [C, n]``, the
    numerator and the normaliser are one product, and the backward is
    that of a decayed linear attention:

      * per row, ``dO_t = dh_t / den_t`` and ``dqn_t = -(dh_t . h_t) /
        den_t * sign(qn_t)`` where ``|qn_t|`` wins the denominator's
        max, else 0;
      * ``dS[t, j] = dO_t . v_j + dqn_t`` for the pairs of a chunk;
      * dq (a forward walk carrying ``C'``): ``inter_w_t C' dO'_t +
        sum_j dS W k_j``;
      * dk and dv (a reverse walk carrying ``dC'``): ``sum_t dS W q_t +
        wk_j dC' v'_j`` and ``sum_t S[t, j] dO_t + wk_j k_j dC``;
      * the gates from the pairwise weights ``W[t, j] = exp(B_t - B_j +
        log_i_j - m_t)`` (``B`` the cumulative log-forget): ``d log_i_j
        = k_j . dk_j``, ``d B_t = q_t . dq_t - k_t . dk_t``, ``d log_f``
        the reverse cumulative sum of ``d B``, and ``d f_pre = d log_f *
        sigmoid(-f_pre)``."""
    B, H, S, D = q.shape
    DV = v.shape[-1]
    scale = D ** -0.5
    qf, kf, vf, dhf = _mlstm_padded(chunk, S, q.float() * scale, k.float(),
                                    v.float(), dh.float())
    log_i, log_f = _mlstm_gates(i_pre, f_pre, chunk)
    den = torch.maximum(qn.abs(), torch.exp(-m))
    delta = (dh.float() * h.float()).sum(-1)
    sgn = torch.where(qn.abs() > torch.exp(-m), torch.sign(qn), 0.0)
    dqn, rden = _mlstm_padded(chunk, S, -delta / den * sgn, 1.0 / den)
    do = dhf * rden[..., None]
    Sp = qf.shape[2]
    starts = range(0, Sp, chunk)
    m_prevs = [torch.full((B, H), NEG_INF, dtype=torch.float32,
                          device=q.device)]
    m_prevs += [m[..., c0 - 1].float() for c0 in starts if c0]
    weights = [_mlstm_chunk_weights(log_i[..., c0:c0 + chunk],
                                    log_f[..., c0:c0 + chunk], mp)
               for c0, mp in zip(starts, m_prevs)]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    # forward walk: dq
    C = torch.zeros((B, H, D, DV), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    for c0, (_, inter_w, w, wk, c_decay) in zip(starts, weights):
        rows = slice(c0, c0 + chunk)
        kc, vc, doc, dqnc = kf[:, :, rows], vf[:, :, rows], do[:, :, rows], \
            dqn[..., rows]
        dsw = (doc @ vc.transpose(-1, -2) + dqnc[..., None]) * w
        dq[:, :, rows] = (inter_w[..., None] * (doc @ C.transpose(-1, -2)
                                                + dqnc[..., None]
                                                * n[..., None, :])
                          + dsw @ kc)
        kw = kc * wk[..., None]
        C = c_decay[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = c_decay[..., None] * n + kw.sum(-2)
    # reverse walk: dk, dv
    dC = torch.zeros((B, H, D, DV), dtype=torch.float32, device=q.device)
    dn = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    for c0, (_, inter_w, w, wk, c_decay) in reversed(list(zip(starts,
                                                            weights))):
        rows = slice(c0, c0 + chunk)
        qc, kc, vc, doc, dqnc = qf[:, :, rows], kf[:, :, rows], \
            vf[:, :, rows], do[:, :, rows], dqn[..., rows]
        dsw = (doc @ vc.transpose(-1, -2) + dqnc[..., None]) * w
        s = (qc @ kc.transpose(-1, -2)) * w
        dk[:, :, rows] = (dsw.transpose(-1, -2) @ qc
                          + wk[..., None] * (vc @ dC.transpose(-1, -2)
                                             + dn[..., None, :]))
        dv[:, :, rows] = (s.transpose(-1, -2) @ doc
                          + wk[..., None] * (kc @ dC))
        qw = qc * inter_w[..., None]
        dC = c_decay[..., None, None] * dC + qw.transpose(-1, -2) @ doc
        dn = c_decay[..., None] * dn + (qw * dqnc[..., None]).sum(-2)
    kdk = (kf * dk).sum(-1)
    d_b = (qf * dq).sum(-1) - kdk
    d_logf = torch.flip(torch.cumsum(torch.flip(d_b, [-1]), -1), [-1])
    d_f = d_logf[..., :S] * torch.sigmoid(-f_pre.float())
    return ((dq[:, :, :S] * scale).to(q.dtype), dk[:, :, :S].to(k.dtype),
            dv[:, :, :S].to(v.dtype), kdk[..., :S].to(i_pre.dtype),
            d_f.to(f_pre.dtype))
