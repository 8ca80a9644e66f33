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

The mLSTM (K6, K6-bwd) and the selective scan (K5, K5-bwd) follow with
their sequential oracles; :func:`ssm_scan_fwd_ckpt` and
:func:`ssm_scan_bwd` are the counterparts of ``_fwd_full``/``_bwd_vjp``
in the reference's ``kernels/ssm_vjp.py``.

:func:`moe_gmm` is K4's plain version, the grouped matmul over
expert-sorted rows of the reference's oracle ``ref.moe_gmm``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

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


def masked_decode_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, valid: torch.Tensor
                            ) -> torch.Tensor:
    """One decode token against cache slots chosen by ``valid`` ``(B,
    T)`` (the ring buffer of a window layer), q ``(B, 1, H, D)``, k/v
    ``(B, T, KH, D)``: the reference's ``_masked_decode_attention``."""
    B, _, H, D = q.shape
    KH = k.shape[2]
    qf = q.float().reshape(B, 1, KH, H // KH, D) * (D ** -0.5)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    scores = torch.where(valid[:, None, None, None, :], scores, NEG_INF)
    out = torch.einsum("bkgst,btkd->bskgd", torch.softmax(scores, dim=-1),
                       v.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


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


def paged_attention_split(
    q: torch.Tensor,           # (B, T, H, D); T = 1 is K2's decode read
    k_pool: torch.Tensor,      # (KH, P, page, D) global page pool
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32; -1 = unmapped
    base_len: torch.Tensor,    # (B,) kv length visible to query row 0
    pps: int,                  # table entries a split walks
) -> torch.Tensor:
    """K2's and K3's split walk and merge, in plain PyTorch (the tests'
    model of the kernels' algorithm; the port's path never calls it).
    Split ``s`` walks the table entries ``[s * pps, (s + 1) * pps)`` and
    keeps, for each row, ``m_s`` (the max of its visible scores, -1e30 when
    it sees none there), ``l_s`` and ``acc_s`` (the sums of
    ``exp(score - m_s)`` and of those weights times V); the merge weighs
    split ``s`` by ``exp(m_s - max m)`` and adds the splits in order.  Row
    ``t`` sees the positions ``< min(base_len + t, max_pages * page)``."""
    B, T, H, D = q.shape
    KH, _, page, _ = k_pool.shape
    max_pages = page_table.shape[1]
    G, cap = H // KH, max_pages * page
    pt = page_table.long().clamp(min=0)
    k = k_pool[:, pt].permute(1, 2, 3, 0, 4).reshape(B, cap, KH, D).float()
    v = v_pool[:, pt].permute(1, 2, 3, 0, 4).reshape(B, cap, KH, D).float()
    qf = q.float().reshape(B, T, KH, G, D) * (D ** -0.5)
    scores = torch.einsum("btkgd,bpkd->bkgtp", qf, k)
    kpos = torch.arange(cap, device=q.device)
    limit = torch.clamp(base_len.to(q.device).long()[:, None]
                        + torch.arange(T, device=q.device), max=cap)
    seen = kpos[None, None, :] < limit[:, :, None]  # (B, T, cap)
    parts = []
    for lo in range(0, cap, pps * page):
        mask = seen & (kpos >= lo) & (kpos < lo + pps * page)
        s = torch.where(mask[:, None, None], scores, NEG_INF)
        m = s.amax(-1)
        p = torch.where(mask[:, None, None], torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bkgtp,bpkd->bkgtd", p, v)))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:  # split order
        w = torch.exp(m - M)
        L = L + l * w
        acc = acc + a * w[..., None]
    out = acc / torch.clamp(L, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell): the sequential oracle, and K6's and
# K6-bwd's plain versions.  Layout as the reference's: q/k ``(B, H, S, D)``,
# v ``(B, H, S, DV)``, gate pre-activations ``(B, H, S)``.
# ---------------------------------------------------------------------------
# the chunk length of the CUDA kernels' FMA path (csrc/mlstm_scan.cu); the
# tensor-core path's is kernels.mlstm_scan.TC_CHUNK
MLSTM_CHUNK = 32


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


def _mlstm_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype the chunked mLSTM computes in: float64 for float64 inputs
    (the oracle ``chip_smoke.py`` holds the float32 kernels against),
    float32 for every other input, as the kernels do."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _mlstm_gates(i_pre, f_pre, chunk):
    """``log_i`` and ``log_f`` ``(B, H, S_pad)`` in :func:`_mlstm_dtype`
    with the ragged edge masked as the kernel masks it: past S the input
    gate is ``NEG_INF`` (no contribution) and ``log_f`` is 0 (the state is
    kept)."""
    S = i_pre.shape[-1]
    pad = -S % chunk
    cd = _mlstm_dtype(i_pre)
    log_i = F.pad(i_pre.to(cd), (0, pad), value=NEG_INF)
    log_f = F.pad(F.logsigmoid(f_pre.to(cd)), (0, pad), value=0.0)
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
    with_state: bool = False,
):
    """K6's plain version: the chunkwise-parallel mLSTM of the reference's
    ``_mlstm_kernel``, one chunk of ``chunk`` rows at a time, the
    ``(C, n, m)`` carry in float32, a ragged S masked as
    :func:`_mlstm_gates` says.  Returns h ``(B, H, S, DV)`` in v's dtype;
    with ``with_stats`` also each row's stabiliser ``m`` and
    normaliser ``qn = q_t . n_t / sqrt(D)`` ``(B, H, S)`` float32, what
    the backward needs; with ``with_state`` instead ``(h, (C, n, m))``,
    the final carry: the state :func:`mlstm_scan` returns (the chunkwise
    ``m`` is the sequential one: both are the max over j of ``log i_j``
    plus the log forgets after j)."""
    B, H, S, D = q.shape
    DV = v.shape[-1]
    scale = D ** -0.5
    cd = _mlstm_dtype(q)
    qf, kf, vf = _mlstm_padded(chunk, S, q.to(cd) * scale, k.to(cd),
                               v.to(cd))
    log_i, log_f = _mlstm_gates(i_pre, f_pre, chunk)
    C = torch.zeros((B, H, D, DV), dtype=cd, device=q.device)
    n = torch.zeros((B, H, D), dtype=cd, device=q.device)
    m_prev = torch.full((B, H), NEG_INF, dtype=cd, device=q.device)
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
    if with_state:
        return h, (C, n, m_prev)
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
        sigmoid(-f_pre)``.

    float64 inputs (stats included) run, and return, in float64."""
    B, H, S, D = q.shape
    DV = v.shape[-1]
    scale = D ** -0.5
    cd = _mlstm_dtype(q)
    qf, kf, vf, dhf = _mlstm_padded(chunk, S, q.to(cd) * scale, k.to(cd),
                                    v.to(cd), dh.to(cd))
    log_i, log_f = _mlstm_gates(i_pre, f_pre, chunk)
    den = torch.maximum(qn.abs(), torch.exp(-m))
    delta = (dh.to(cd) * h.to(cd)).sum(-1)
    sgn = torch.where(qn.abs() > torch.exp(-m), torch.sign(qn), 0.0)
    dqn, rden = _mlstm_padded(chunk, S, -delta / den * sgn, 1.0 / den)
    do = dhf * rden[..., None]
    Sp = qf.shape[2]
    starts = range(0, Sp, chunk)
    m_prevs = [torch.full((B, H), NEG_INF, dtype=cd, device=q.device)]
    m_prevs += [m[..., c0 - 1].to(cd) for c0 in starts if c0]
    weights = [_mlstm_chunk_weights(log_i[..., c0:c0 + chunk],
                                    log_f[..., c0:c0 + chunk], mp)
               for c0, mp in zip(starts, m_prevs)]
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    # forward walk: dq
    C = torch.zeros((B, H, D, DV), dtype=cd, device=q.device)
    n = torch.zeros((B, H, D), dtype=cd, device=q.device)
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
    dC = torch.zeros((B, H, D, DV), dtype=cd, device=q.device)
    dn = torch.zeros((B, H, D), dtype=cd, device=q.device)
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
    d_f = d_logf[..., :S] * torch.sigmoid(-f_pre.to(cd))
    return ((dq[:, :, :S] * scale).to(q.dtype), dk[:, :, :S].to(k.dtype),
            dv[:, :, :S].to(v.dtype), kdk[..., :S].to(i_pre.dtype),
            d_f.to(f_pre.dtype))


# ---------------------------------------------------------------------------
# Mamba-style selective scan: the sequential oracle, the chunked scan, and
# K5's and K5-bwd's plain versions (the checkpointed adjoint of the
# reference's ``kernels/ssm_vjp.py``).  Layout as the reference's: x, dt
# ``(B, S, Din)``, A ``(Din, N)``, B and C ``(B, S, N)``, D ``(Din,)``.
# ---------------------------------------------------------------------------
SSM_CHUNK = 32  # the checkpoint interval of the CUDA kernels (csrc/ssm_scan.cu)


def ssm_scan(
    x: torch.Tensor,     # (B, S, Din)
    dt: torch.Tensor,    # (B, S, Din), already softplus'd, > 0
    A: torch.Tensor,     # (Din, N), negative
    Bmat: torch.Tensor,  # (B, S, N)
    Cmat: torch.Tensor,  # (B, S, N)
    D: torch.Tensor,     # (Din,)
    initial: Optional[torch.Tensor] = None,  # (B, Din, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``y_t = C_t . h_t + D x_t`` with ``h_t = exp(dt_t A) h_{t-1} + dt_t
    B_t x_t``, one step at a time, as the reference's ``ref.ssm_scan``.
    Returns y ``(B, S, Din)`` in x's dtype and the final float32 state
    ``(B, Din, N)``."""
    Bsz, S, Din = x.shape
    xf, dtf = x.float(), dt.float()
    Af, Bf, Cf = A.float(), Bmat.float(), Cmat.float()
    h = (torch.zeros((Bsz, Din, A.shape[-1]), dtype=torch.float32,
                     device=x.device)
         if initial is None else initial.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t, :, None] * Af)
        h = decay * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + xf * D.float()
    return y.to(x.dtype), h


def _ssm_padded(chunk: int, *xs: torch.Tensor) -> List[torch.Tensor]:
    """Each of ``xs`` ((B, S, W) tensors) in float32, zero-padded along S to
    a multiple of ``chunk``: a padded step has dt = 0, so it keeps the
    state (decay 1, no input) and adds nothing to any gradient."""
    pad = -xs[0].shape[1] % chunk
    return [F.pad(x.float(), (0, 0, 0, pad)) for x in xs]


def _ssm_chunk_states(h, xc, dtc, bc, Af):
    """The states of one chunk from its initial state h: ``(decay (B, L,
    Din, N), states (B, L + 1, Din, N))`` with ``states[:, t + 1] = h_t``
    and ``states[:, 0]`` the initial state."""
    a = torch.exp(dtc[..., None] * Af)
    u = (dtc * xc)[..., None] * bc[:, :, None, :]
    hs = [h]
    for t in range(a.shape[1]):
        h = a[:, t] * h + u[:, t]
        hs.append(h)
    return a, torch.stack(hs, dim=1)


def _ssm_chunks(x, dt, A, Bmat, Cmat, chunk):
    """Walk the chunks forward: ``(h_t . C_t (B, S, Din) float32, the state
    at each chunk start (nc, B, Din, N), the final state)``."""
    Bsz, S, Din = x.shape
    xf, dtf, bf, cf = _ssm_padded(chunk, x, dt, Bmat, Cmat)
    Af = A.float()
    h = torch.zeros((Bsz, Din, A.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys, ckpts = [], []
    for t0 in range(0, xf.shape[1], chunk):
        sl = slice(t0, t0 + chunk)
        ckpts.append(h)
        _, hs = _ssm_chunk_states(h, xf[:, sl], dtf[:, sl], bf[:, sl], Af)
        ys.append((hs[:, 1:] * cf[:, sl, None, :]).sum(-1))
        h = hs[:, -1]
    return torch.cat(ys, dim=1)[:, :S], torch.stack(ckpts), h


def ssm_scan_chunked(x, dt, A, Bmat, Cmat, D, chunk: int = 16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``ref.ssm_scan_chunked``: the oracle's math with
    the state carried once per chunk.  Returns ``(y in x's dtype, final
    float32 state)``."""
    ys, _, h = _ssm_chunks(x, dt, A, Bmat, Cmat, chunk)
    return (ys + x.float() * D.float()).to(x.dtype), h


def ssm_scan_fwd_ckpt(x, dt, A, Bmat, Cmat, D, chunk: int = SSM_CHUNK
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's plain version, the reference's ``ssm_vjp._fwd_full``: y in x's
    dtype (``D x`` added in float32 before the cast, as the oracle does)
    and the float32 state at the start of each ``chunk``-step chunk,
    ``(ceil(S / chunk), B, Din, N)`` (the first is zero)."""
    ys, ckpts, _ = _ssm_chunks(x, dt, A, Bmat, Cmat, chunk)
    return (ys + x.float() * D.float()).to(x.dtype), ckpts


def ssm_scan_bwd(x, dt, A, Bmat, Cmat, D, ckpts: torch.Tensor,
                 dy: torch.Tensor, chunk: int = SSM_CHUNK
                 ) -> Tuple[torch.Tensor, ...]:
    """K5-bwd's plain version, the reference's ``ssm_vjp._bwd_vjp``: the
    gradients ``(dx, ddt, dA, dB, dC, dD)`` of :func:`ssm_scan_fwd_ckpt`'s
    y, each in its input's dtype, from the inputs, the checkpoints and the
    incoming ``dy``.  The chunks are walked in reverse; each recomputes its
    states forward from its checkpoint (never inverting the decay, which
    can be tiny) and runs the adjoint
    ``dh_t = dy_t C_t + a_{t+1} dh_{t+1}``, ``da_t = dh_t h_{t-1}``."""
    Bsz, S, Din = x.shape
    xf, dtf, bf, cf, dyf = _ssm_padded(chunk, x, dt, Bmat, Cmat, dy)
    Af = A.float()
    dh = torch.zeros_like(ckpts[0])
    dA = torch.zeros_like(Af)
    dxs, ddts, dBs, dCs = [], [], [], []
    for k in reversed(range(ckpts.shape[0])):
        sl = slice(k * chunk, (k + 1) * chunk)
        xc, dtc, bc, cc, dyc = (z[:, sl] for z in (xf, dtf, bf, cf, dyf))
        a, hs = _ssm_chunk_states(ckpts[k], xc, dtc, bc, Af)
        g = dyc[..., None] * cc[:, :, None, :]  # dy_t C_t
        dhs = [None] * a.shape[1]
        for t in reversed(range(a.shape[1])):
            dh = dh + g[:, t]
            dhs[t] = dh
            dh = a[:, t] * dh
        dhs = torch.stack(dhs, dim=1)  # (B, L, Din, N)
        da = dhs * hs[:, :-1]
        ddtx = (dhs * bc[:, :, None, :]).sum(-1)
        dCs.append((dyc[..., None] * hs[:, 1:]).sum(2))
        dBs.append((dhs * (dtc * xc)[..., None]).sum(2))
        dA = dA + (da * dtc[..., None] * a).sum((0, 1))
        dxs.append(ddtx * dtc)
        ddts.append((da * Af * a).sum(-1) + ddtx * xc)

    def whole(parts):
        return torch.cat(parts[::-1], dim=1)[:, :S]

    dyx = dyf[:, :S]
    dx = whole(dxs) + dyx * D.float()
    dD = (dyx * xf[:, :S]).sum((0, 1))
    return (dx.to(x.dtype), whole(ddts).to(dt.dtype), dA.to(A.dtype),
            whole(dBs).to(Bmat.dtype), whole(dCs).to(Cmat.dtype),
            dD.to(D.dtype))


# --------------------------------------------------------------------------
# MoE grouped matmul over expert-sorted rows (K4)
# --------------------------------------------------------------------------
def group_ranges(group_sizes: Union[torch.Tensor, Sequence[int]], M: int,
                 *, tail_to_last: bool) -> List[Tuple[int, int]]:
    """Each expert's rows ``[lo, hi)`` of an ``M``-row sorted matrix, in
    expert order.  ``tail_to_last``: the rows past ``sum(sizes)`` go to the
    last expert (the reference oracle's convention); else they belong to
    none (the kernels', which write zeros there)."""
    sizes = (group_sizes.tolist() if isinstance(group_sizes, torch.Tensor)
             else list(group_sizes))
    out, start = [], 0
    for e, size in enumerate(sizes):
        end = start + int(size)
        hi = M if tail_to_last and e == len(sizes) - 1 else end
        out.append((min(start, M), min(max(hi, start), M)))
        start = end
    return out


def moe_gmm(tokens: torch.Tensor,
            group_sizes: Union[torch.Tensor, Sequence[int]],
            w: torch.Tensor, *, transpose_w: bool = False) -> torch.Tensor:
    """``out[i] = tokens[i] @ w[e(i)]`` — tokens ``(M, K)`` sorted so that
    expert ``e`` owns ``group_sizes[e]`` consecutive rows, w ``(E, K, N)``
    (or ``(E, N, K)`` read transposed with ``transpose_w``) -> ``(M, N)``
    in tokens' dtype, each product in float32.  Rows past
    ``sum(group_sizes)`` get the last expert's product, as in the
    reference's oracle (its Pallas kernel and K4 write zeros there).  A
    loop over the groups, so that it is cheap at a full layer's shapes."""
    M = tokens.shape[0]
    N = w.shape[1] if transpose_w else w.shape[2]
    out = torch.zeros((M, N), dtype=tokens.dtype, device=tokens.device)
    for e, (lo, hi) in enumerate(group_ranges(group_sizes, M,
                                              tail_to_last=True)):
        if hi > lo:
            we = w[e].float()
            out[lo:hi] = (tokens[lo:hi].float()
                          @ (we.t() if transpose_w else we)).to(tokens.dtype)
    return out
