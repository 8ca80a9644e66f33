"""Lossless speculative decoding: the n-gram proposer, the history buffer
and the draft/verify acceptance rule, in PyTorch.

Counterpart of the reference package's ``models/speculate.py``.  A round
drafts ``k`` tokens per slot, scores all ``k + 1`` positions with one
target pass (:meth:`repro_torch.models.api.Model.verify_step`) and keeps
the longest prefix the target agrees with:

  * greedy slots accept drafts while they equal the target's argmax and
    emit the argmax at the first mismatch (or as the bonus token after a
    full run) — the non-speculative greedy sequence, token for token;
  * temperature slots run the rejection test ``u < p(d) / q(d)`` per
    draft and resample the first rejection from ``norm(relu(p - q))``,
    so the emitted tokens follow the target law for any proposal ``q``,
    the point masses of the n-gram proposer included.

Every draw has its own stream, keyed by ``(seed, slot, absolute
position, tag)`` with one tag per purpose (draft draw, acceptance
uniform, residual, bonus) — the property of the reference's
``spec_keys``.  The bits are PyTorch's (see
:mod:`repro_torch.models.sampling`), so temperature draws agree with the
reference in law, not in value.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import sampling

TAG_DRAFT = 0x5D1
TAG_ACCEPT = 0x5D2
TAG_RESIDUAL = 0x5D3
TAG_BONUS = 0x5D4


# ---------------------------------------------------------------------------
# n-gram / prompt-lookup proposer
# ---------------------------------------------------------------------------
def ngram_propose(hist: torch.Tensor, hist_len: torch.Tensor, *, k: int,
                  n: int = 3) -> torch.Tensor:
    """Draft ``k`` tokens per slot by prompt lookup.

    ``hist`` is ``(B, cap)`` int32, every token of the slot's prompt and
    generated history, left-aligned; ``hist_len`` ``(B,)`` counts the
    valid entries.  The slot's last ``n`` tokens are matched against
    every earlier window of its own history, and the proposal is the
    continuation after the most recent prior match.  A slot with no match
    (or too little history) repeats its last token, and so does a
    continuation that runs off the known history.  Returns ``(B, k)``
    int32."""
    B, cap = hist.shape
    W = cap - n + 1
    dev = hist.device
    hist_len = hist_len.long()
    sidx = torch.clamp(hist_len[:, None] - n + torch.arange(n, device=dev),
                       0, cap - 1)
    suffix = torch.gather(hist, 1, sidx)                        # (B, n)
    starts = torch.arange(W, device=dev)[None]                  # (1, W)
    match = torch.ones((B, W), dtype=torch.bool, device=dev)
    for j in range(n):
        match &= hist[:, j:j + W] == suffix[:, j:j + 1]
    # a prior occurrence ends strictly before the suffix itself
    match &= starts <= (hist_len - n - 1)[:, None]
    match &= (hist_len >= n + 1)[:, None]
    best = torch.where(match, starts, -1).max(dim=1).values     # (B,)
    found = best >= 0
    cont = best + n
    last = torch.gather(hist, 1, torch.clamp(hist_len - 1, 0, cap - 1)[:, None])[:, 0]
    props = []
    for j in range(k):
        cidx = torch.clamp(cont + j, 0, cap - 1)
        pj = torch.gather(hist, 1, cidx[:, None])[:, 0]
        props.append(torch.where(found & (cont + j <= hist_len - 1), pj, last))
    return torch.stack(props, dim=1).to(torch.int32)


def update_history(hist: torch.Tensor, pos: torch.Tensor,
                   emitted: torch.Tensor, m: torch.Tensor,
                   active: torch.Tensor) -> torch.Tensor:
    """Append a verify round's emitted tokens to the history buffer, in
    place, and return it.  ``emitted`` is ``(B, K)`` with ``m[b]`` valid
    entries landing at positions ``pos[b] + 1 .. pos[b] + m[b]``;
    inactive slots and dead columns leave the buffer as it was."""
    B, cap = hist.shape
    bidx = torch.arange(B, device=hist.device)
    for j in range(emitted.shape[1]):
        idx = torch.clamp(pos.long() + 1 + j, 0, cap - 1)
        write = active & (j < m)
        hist[bidx, idx] = torch.where(write, emitted[:, j].to(hist.dtype),
                                      hist[bidx, idx])
    return hist


# ---------------------------------------------------------------------------
# acceptance: exact-match greedy / rejection-sampling temperature
# ---------------------------------------------------------------------------
def _count_prefix(match: torch.Tensor) -> torch.Tensor:
    """Length of each row's leading run of True."""
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)


def accept_and_emit(
    logits: torch.Tensor,              # (B, k+1, V) target verify logits
    drafts: torch.Tensor,              # (B, k) proposed tokens
    q_probs: Optional[torch.Tensor],   # (B, k, V) draft softmax; None = delta
    temperatures,                      # (B,) host values
    *,
    seed: int,
    slots,                             # (B,) slot ids
    pos0: torch.Tensor,                # (B,) position of drafts[:, 0]
    bonus: bool,
    greedy_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decide which drafts survive and what to emit in place of the first
    casualty.  Returns ``(emitted (B, k+1), m (B,), accepted (B,))``, all
    int32: ``emitted[:, :m]`` are the round's tokens and ``accepted``
    counts the surviving drafts.

    Greedy slots (``temperature <= 0``) accept while the draft equals the
    target argmax and emit the argmax at the first mismatch.  Temperature
    slots accept draft ``i`` iff ``u_i < p_i(d_i) / q_i(d_i)`` and draw
    the first rejection from ``norm(relu(p - q))`` (``p`` itself where
    that is empty); ``q_probs=None`` is a point mass at each draft (the
    n-gram proposer).  ``bonus`` appends the target's own token after a
    fully accepted run (``m = k + 1``); a draft model's cache holds K/V
    through draft ``k - 1`` only, so its path passes ``bonus=False`` and
    a full run stops at ``m = k``."""
    B, K, V = logits.shape
    k = K - 1
    dev = logits.device
    logits32 = logits.float()
    tgt = torch.argmax(logits32, dim=-1).to(torch.int32)        # (B, k+1)
    acc = _count_prefix(drafts == tgt[:, :k])
    fix = tgt  # correction (mismatch) or bonus (full run) per column
    temps = torch.as_tensor(temperatures, dtype=torch.float32).cpu()
    hot = [] if greedy_only else torch.nonzero(temps > 0).flatten().tolist()
    if hot:
        slots = torch.as_tensor(slots).tolist()
        starts = pos0.tolist()
        temps_d = temps.to(dev)
        safe = torch.where(temps_d > 0, temps_d, torch.ones_like(temps_d))
        p = torch.softmax(logits32 / safe[:, None, None], dim=-1)
        d_idx = drafts.long()[:, :, None]
        p_d = torch.gather(p[:, :k], 2, d_idx)[:, :, 0]         # (B, k)
        if q_probs is None:
            ratio = p_d
            q_at = torch.nn.functional.one_hot(drafts.long(), V).float()
        else:
            q_at = q_probs.float()
            q_d = torch.gather(q_at, 2, d_idx)[:, :, 0]
            ratio = p_d / torch.clamp(q_d, min=1e-30)
        # one acceptance uniform per drafted position, keyed by its
        # absolute position (other rows' entries are never read)
        u = torch.zeros((B, k), dtype=torch.float32, device=dev)
        for b in hot:
            for j in range(k):
                u[b, j] = sampling.uniform(seed=seed, slot=slots[b],
                                           pos=starts[b] + j,
                                           tag=TAG_ACCEPT, device=dev)
        hot_row = temps_d[:, None] > 0
        acc = torch.where(hot_row[:, 0], _count_prefix(u < ratio), acc)
        # the correction of a temperature row: a residual draw at the first
        # rejection, or the bonus draw from the target after a full run
        acc_h = acc.tolist()
        corr = tgt[:, 0].clone()
        for b in hot:
            a = acc_h[b]
            if a >= k:
                row = logits32[b, k] / safe[b]
                corr[b] = sampling.gumbel_argmax(
                    row, seed=seed, slot=slots[b], pos=starts[b] + k,
                    tag=TAG_BONUS)
                continue
            res = torch.relu(p[b, a] - q_at[b, a])
            total = res.sum()
            res = (res / total) if float(total) > 1e-30 else p[b, a]
            corr[b] = sampling.gumbel_argmax(
                torch.log(torch.clamp(res, min=1e-30)), seed=seed,
                slot=slots[b], pos=starts[b] + a, tag=TAG_RESIDUAL)
        fix = torch.where(hot_row, corr[:, None].expand(B, K), tgt)

    kcol = torch.arange(K, device=dev)[None]
    drafts_pad = torch.cat(
        [drafts.to(torch.int32),
         torch.zeros((B, 1), dtype=torch.int32, device=dev)], dim=1)
    emitted = torch.where(kcol < acc[:, None], drafts_pad, fix)
    m = torch.where(acc >= k, torch.full_like(acc, k + 1 if bonus else k),
                    acc + 1)
    m = torch.clamp(m, min=1)  # k == 0 degenerates to decode + sample
    return (emitted.to(torch.int32), m.to(torch.int32),
            acc.to(torch.int32))
