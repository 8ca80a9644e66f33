"""Serving engine: slot-based continuous batching over the model's decode
paths, in PyTorch.

Counterpart of the reference package's ``serve/engine.py`` for
``engine="fused"`` and ``engine="paged"``:

  * the engine owns a fixed decode batch of ``max_batch`` slots and
    decodes the whole batch per step;
  * queued requests are admitted in groups: every request whose prompt
    shares the head-of-queue's power-of-two length bucket (and the shapes
    of its extra inputs) is prefilled in one call (right-padded, exact
    per-row ``lens``), then scattered into the batch cache leaf by leaf;
    a model whose prefill takes no padding (the encoder-decoder) groups
    requests of exactly equal prompt length instead;
  * sampling follows the decode step on the device, so each step moves
    one ``(B,)`` token array to the host — never the ``(B, V)`` logits;
  * ``decode_chunk > 1`` decodes that many tokens per host transfer in a
    device-side loop, masking slots that finish mid-chunk;
  * ``engine="paged"`` keeps K/V in a global page pool: pages are
    reserved at admission for the request's whole budget, full prompt
    pages are shared across requests by a chain hash of the prefix they
    cover (and of the request's extra inputs, so two images never share
    a page), and pool page 0 is the null page where retired slots'
    writes land;
  * ``spec_k > 0`` decodes speculatively on either engine: each round
    drafts ``spec_k`` tokens per slot (n-gram prompt lookup, or a draft
    model with the same vocabulary and its own dense cache), verifies
    them in one target pass and keeps the longest prefix the target
    agrees with (:mod:`repro_torch.models.speculate`); ``decode_chunk``
    rounds run per host transfer.

Greedy tokens agree with the reference engine's on the same weights,
with and without speculation.  Temperature draws are keyed by
``(seed, slot, position)`` (plus a tag per speculative purpose) but are
not the reference's bits (see :mod:`repro_torch.models.sampling`).

``engine="legacy"`` is not ported yet and raises ``NotImplementedError``.

The engine runs on its model's device (``build_model`` defaults to the
card).  K/V caches are updated in place.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import sampling, speculate
from repro_torch.models.api import Model

_MIN_SEQ_BUCKET = 8
_LATER = "is not ported to PyTorch yet (ROADMAP queue 1, the control plane)"


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    # per-request model inputs besides the prompt, one row each (the
    # encoder-decoder's "frames" (T, D), the VLM's "image_embeds" (n, D))
    extra: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    prompt_len: int
    finished_reason: str  # eos | length


def _pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to cap."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class PagePool:
    """Host-side allocator for the global K/V page pool.

    Page 0 is reserved as the null/parking page (never handed out):
    retired slots' table rows clamp to it, so a stale write can never
    land in a live allocation.  Full prompt pages are deduplicated by a
    *chain hash* — a digest of every prompt token the page and its
    predecessors cover — so identical prefixes map identical physical
    pages.  Sharing is sound because a causal model's K/V at position
    ``t`` depends only on tokens ``<= t``, and shared pages are
    read-only (decode writes start at ``pos >= plen``, past them).
    Registry entries are refcounted with the pages themselves and drop
    out when the last owner frees the page.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2 (page 0 is the "
                             f"reserved null page), got {num_pages}")
        self.num_pages = num_pages
        self.page = page_size
        self.refs = np.zeros(num_pages, np.int32)
        self._free = list(range(num_pages - 1, 0, -1))  # stack: pop() -> 1 first
        self._registry: Dict[bytes, int] = {}   # chain hash -> physical page
        self._page_hash: Dict[int, bytes] = {}  # physical page -> chain hash
        self.prefix_hits = 0
        self.prefix_lookups = 0

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the reserved null page)."""
        return self.num_pages - 1

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.capacity - len(self._free)

    @property
    def hit_rate(self) -> float:
        return self.prefix_hits / max(1, self.prefix_lookups)

    def lookup(self, chain_hash: bytes) -> Optional[int]:
        """Find a shared prompt page; increfs and returns it on a hit."""
        self.prefix_lookups += 1
        pid = self._registry.get(chain_hash)
        if pid is None:
            return None
        self.prefix_hits += 1
        self.refs[pid] += 1
        return pid

    def alloc(self, chain_hash: Optional[bytes] = None) -> Optional[int]:
        """Pop a free page (ref = 1), registering it for prefix sharing
        when a chain hash is given.  Returns None when the pool is dry."""
        if not self._free:
            return None
        pid = self._free.pop()
        self.refs[pid] = 1
        if chain_hash is not None:
            self._registry[chain_hash] = pid
            self._page_hash[pid] = chain_hash
        return pid

    def free(self, pid: int) -> None:
        """Decref; the page returns to the free list (and leaves the
        sharing registry) when its last owner lets go."""
        self.refs[pid] -= 1
        if self.refs[pid] == 0:
            h = self._page_hash.pop(pid, None)
            if h is not None:
                self._registry.pop(h, None)
            self._free.append(pid)


def _chain_hash(prompt: np.ndarray, end: int, salt: bytes = b"") -> bytes:
    """Digest of ``salt`` and ``prompt[:end]`` — the sharing key for the
    page whose last covered position is ``end - 1``.  ``salt`` is
    :func:`_extra_digest` of the request's extra inputs (empty without
    them, which gives the reference's key)."""
    return hashlib.sha1(salt + np.ascontiguousarray(
        prompt[:end], dtype=np.int32).tobytes()).digest()


def _extra_digest(extra: Optional[Dict[str, np.ndarray]]) -> bytes:
    """Digest of a request's extra inputs (names, shapes, dtypes and
    bytes), or ``b""`` without them.  A page's K/V depends on the image
    embeddings overlaid on the prompt as much as on its tokens, so the
    chain hash takes them in: the reference keys by tokens alone and
    shares one request's image pages with another that has the same
    tokens and a different image."""
    if not extra:
        return b""
    h = hashlib.sha1()
    for k in sorted(extra):
        v = np.ascontiguousarray(extra[k])
        h.update(f"{k}{v.shape}{v.dtype.str}".encode())
        h.update(v.tobytes())
    return h.digest()


def _cache_batch_axes(model: Model, max_seq: int) -> Dict[str, int]:
    """Each decode-cache leaf's batch axis, found by comparing the cache's
    shapes at batch 1 and 2 on the meta device (no allocation)."""
    a, b = model.cache_specs(1, max_seq), model.cache_specs(2, max_seq)
    return {k: next(i for i, (p, q) in enumerate(zip(a[k].shape, b[k].shape))
                    if p != q)
            for k in a}


def _insert_rows(cache: Dict[str, torch.Tensor], rows: Dict[str, torch.Tensor],
                 idx: torch.Tensor, axes: Dict[str, int]) -> None:
    """Copy the first ``len(idx)`` rows of a prefilled group cache into
    the batch cache's slots ``idx``, in place, leaf by leaf along each
    leaf's batch axis."""
    n = len(idx)
    for name, ax in axes.items():
        cache[name].index_copy_(ax, idx, rows[name].narrow(ax, 0, n))


class ServeEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_seq: int = 256, eos_id: int = 2, seed: int = 0,
                 engine: str = "fused", decode_chunk: int = 1,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 spec_k: int = 0, spec_ngram_n: int = 3,
                 draft: Optional[Model] = None, draft_params=None):
        if engine == "legacy":
            raise NotImplementedError(f"engine='legacy' {_LATER}")
        if engine not in ("fused", "paged"):
            raise ValueError(f"engine must be 'fused' or 'paged', "
                             f"got {engine!r}")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k == 0 and draft is not None:
            raise ValueError("a draft model requires spec_k >= 1")
        if spec_k > 0:
            if model.cfg.family == "vlm":
                raise NotImplementedError(
                    f"speculative serving of {model.cfg.name!r} (family "
                    f"'vlm') is not ported to PyTorch yet: ROADMAP queue 1, "
                    f"VLM speculation")
            if not model.supports_speculative():
                raise ValueError(
                    f"speculative decoding unsupported for family "
                    f"{model.cfg.family!r}: the decode cache cannot roll "
                    f"back rejected drafts")
            if spec_ngram_n < 1:
                raise ValueError(f"spec_ngram_n must be >= 1, "
                                 f"got {spec_ngram_n}")
            if draft is not None:
                if draft_params is None:
                    raise ValueError("a draft model requires draft_params")
                if draft.cfg.vocab_size != model.cfg.vocab_size:
                    raise ValueError(
                        f"draft vocab ({draft.cfg.vocab_size}) must match "
                        f"target vocab ({model.cfg.vocab_size}): drafts are "
                        f"target token ids")
                if not draft.supports_speculative():
                    raise ValueError(
                        f"draft family {draft.cfg.family!r} cannot draft: "
                        f"its cache cannot roll back rejected drafts")
                if (model.supports_padded_prefill()
                        and not draft.supports_padded_prefill()):
                    raise ValueError(
                        "draft model must support padded prefill when the "
                        "target does: both prefill the same admission "
                        "groups")
        self.model = model
        self.device = model.device
        self.params = model.serving_params(params)
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.seed = seed
        self.engine = engine
        self.decode_chunk = decode_chunk

        self.pool: Optional[PagePool] = None
        if engine == "paged":
            if not model.supports_paged_cache():
                raise ValueError(
                    f"engine='paged' requires a dense attention decode "
                    f"cache; family {model.cfg.family!r} keeps state that "
                    f"cannot be paged")
            if page_size < 1 or page_size & (page_size - 1):
                raise ValueError(f"page_size must be a power of two, "
                                 f"got {page_size}")
            self.page_size = page_size
            self._max_pages = -(-max_seq // page_size)  # table width / slot
            if num_pages is None:
                # full-occupancy capacity + the reserved null page; pass a
                # smaller pool to make memory proportional to live tokens
                num_pages = 1 + max_batch * self._max_pages
            self.num_pages = num_pages
            self.pool = PagePool(num_pages, page_size)
            self.cache = model.init_paged_cache(
                max_batch, num_pages=num_pages, page_size=page_size,
                max_pages=self._max_pages)
            # host mirror of the device page table; synced before decode
            self._ptable = np.full((max_batch, self._max_pages), -1, np.int32)
            self._ptable_dirty = False
            self._slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
        else:
            self.cache = model.init_cache(max_batch, max_seq)
            self._axes = _cache_batch_axes(model, max_seq)
        self.active = np.zeros(max_batch, dtype=bool)
        self.req: List[Optional[Request]] = [None] * max_batch
        self.emitted: List[List[int]] = [[] for _ in range(max_batch)]
        self.last_token = np.zeros(max_batch, dtype=np.int32)
        self.temps = np.zeros(max_batch, dtype=np.float32)
        self.queue: Deque[Request] = deque()
        self.done: List[Completion] = []
        # instrumentation: decode-path device-to-host transfers (count,
        # elements) and chunk utilization (decode steps consumed vs run)
        self.d2h_transfers = 0
        self.d2h_elems = 0
        self.chunk_steps_total = 0
        self.chunk_steps_used = 0
        # speculative decoding counters (spec_k > 0)
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_tokens = 0

        self.spec_k = spec_k
        self.spec_ngram_n = spec_ngram_n
        self.draft = draft
        if spec_k > 0:
            # history buffer (the n-gram proposer's source and the record
            # of committed tokens): every reachable position of a slot
            cap = (self._max_pages * page_size if engine == "paged"
                   else max_seq)
            self._hist_cap = cap
            self.hist = torch.zeros((max_batch, cap), dtype=torch.int32,
                                    device=self.device)
            self._hist_dirty: List[int] = []
            if draft is not None:
                # the draft serves from its own dense cache sized to the
                # target's reachable positions, admitted with the target
                self.draft_params = draft.serving_params(draft_params)
                self._draft_cache = draft.init_cache(max_batch, cap)
                self._draft_axes = _cache_batch_axes(draft, cap)

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request.  Validation happens here — once a request is
        accepted, admission and decode cannot fail or silently clamp."""
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError("prompt must have at least one token")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        # the last decode writes K/V at position plen + max_new_tokens - 2;
        # a verify pass entered one token before the budget writes spec_k
        # draft rows past it
        spec = f" + spec_k ({self.spec_k})" if self.spec_k else ""
        if self.engine == "paged":
            need = -(-(plen + req.max_new_tokens - 1 + self.spec_k)
                     // self.page_size)
            limit = min(self.pool.capacity, self._max_pages)
            if need > limit:
                raise ValueError(
                    f"prompt ({plen}) + max_new_tokens "
                    f"({req.max_new_tokens}){spec} needs {need} KV pages but "
                    f"engine='paged' can map at most {limit} pages per "
                    f"request ({self.pool.capacity} allocatable pages of "
                    f"page_size={self.page_size} in the pool, "
                    f"{self._max_pages} page-table entries per slot): "
                    f"the request could never be admitted")
        elif plen + req.max_new_tokens - 1 + self.spec_k > self.max_seq:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens ({req.max_new_tokens}) "
                f"- 1{spec} exceeds max_seq={self.max_seq}: the decode "
                f"would overflow the KV cache")
        self.queue.append(req)

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        out = t.cpu().numpy()
        self.d2h_transfers += 1
        self.d2h_elems += out.size
        return out

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _all_greedy(self) -> bool:
        return not bool((self.temps[self.active] > 0).any())

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    @staticmethod
    def _extra_sig(extra: Optional[Dict[str, np.ndarray]]):
        """The names, shapes and dtypes of a request's extra inputs: rows
        of one admission group stack into one batch."""
        if not extra:
            return None
        return tuple(sorted(
            (k, tuple(np.asarray(v).shape), np.asarray(v).dtype.str)
            for k, v in extra.items()))

    def _group_key(self, req: Request) -> Tuple:
        """Admission-group key: requests sharing it prefill in one call.
        ``("pad", bucket, sig)`` for models whose prefill takes padding:
        the padded prompt length, right-padded with exact per-row
        ``lens`` (causality keeps every real position exact); paged
        groups bucket to at least one page so every prompt page of the
        mini-cache is whole.  ``("exact", plen, sig)`` for the others
        (the encoder-decoder): equal prompt lengths, no padding."""
        plen = len(req.prompt)
        sig = self._extra_sig(req.extra)
        if self.model.supports_padded_prefill():
            seq = _pow2_bucket(max(plen, _MIN_SEQ_BUCKET), self.max_seq)
            if self.engine == "paged":
                seq = max(seq, self.page_size)
            return ("pad", seq, sig)
        return ("exact", plen, sig)

    def _select(self, n_slots: int) -> List[Request]:
        """Prompt-length-aware two-pass selection: pass 0 pulls every
        queued request sharing the head request's bucket forward; pass 1
        fills the remaining slots FIFO.  The head of the queue is always
        selected first, so reordering never starves a request."""
        if not self.queue or n_slots <= 0:
            return []
        head_key = self._group_key(self.queue[0])
        picked: List[Request] = []
        rest: List[Request] = []
        for r in self.queue:
            if len(picked) < n_slots and self._group_key(r) == head_key:
                picked.append(r)
            else:
                rest.append(r)
        while rest and len(picked) < n_slots:
            picked.append(rest.pop(0))
        self.queue = deque(rest)
        return picked

    def _group_inputs(self, seq_len: int, members):
        """Host arrays of one admission group, rows padded to a power of
        two: tokens (right-padded), lens, temperatures, slots, and each
        extra input's rows stacked on the device (pad rows repeat row 0),
        or None."""
        n = len(members)
        n_pad = _pow2_bucket(n, self.max_batch)
        tokens = np.zeros((n_pad, seq_len), np.int32)
        lens = np.ones(n_pad, np.int32)
        temps = np.zeros(n_pad, np.float32)
        slots = np.zeros(n_pad, np.int32)
        for i, (slot, req, *_) in enumerate(members):
            plen = len(req.prompt)
            tokens[i, :plen] = np.asarray(req.prompt, np.int32)
            lens[i] = plen
            temps[i] = req.temperature
            slots[i] = slot
        extra = None
        first = members[0][1]
        if first.extra:
            extra = {}
            for k in sorted(first.extra):
                rows = [np.asarray(req.extra[k]) for _, req, *_ in members]
                rows += [rows[0]] * (n_pad - n)
                extra[k] = self._tensor(np.stack(rows))
        return tokens, lens, temps, slots, extra

    def _prefill_sample(self, kind: str, tokens, lens, temps, slots, extra,
                        max_seq: int):
        """Prefill one group (with ``lens`` for a padded group) and sample
        each row's first token on the device: row ``i``'s stream is keyed
        by ``(slot, lens - 1)``."""
        logits, cache1 = self.model.prefill(
            self.params, self._tensor(tokens), extra, max_seq=max_seq,
            lens=self._tensor(lens) if kind == "pad" else None)
        first = sampling.sample_tokens(
            logits, temps, seed=self.seed, slots=slots, pos=lens - 1,
            greedy_only=not bool((temps > 0).any()))
        return first, cache1

    def _admit(self) -> None:
        if self.engine == "paged":
            self._admit_paged()
            return
        if not self.queue:
            return
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            return
        selected = self._select(int(free.size))
        groups: Dict[Tuple, List[Tuple[int, Request]]] = {}
        for i, req in enumerate(selected):
            groups.setdefault(self._group_key(req), []).append(
                (int(free[i]), req))
        for (kind, seq_len, _), members in groups.items():
            self._admit_group(kind, seq_len, members)

    def _admit_group(self, kind: str, seq_len: int,
                     members: List[Tuple[int, Request]]) -> None:
        n = len(members)
        tokens, lens, temps, slots, extra = self._group_inputs(seq_len,
                                                               members)
        first, cache1 = self._prefill_sample(kind, tokens, lens, temps, slots,
                                             extra, self.max_seq)
        # scatter the group's first n rows into their slots, each leaf
        # along its batch axis (1 of the (L, B, ...) K/V and cross K/V,
        # 0 of pos)
        idx = self._tensor(slots[:n]).long()
        _insert_rows(self.cache, cache1, idx, self._axes)
        self._admit_draft(kind, tokens, lens, slots, n)
        first = first.cpu().numpy()
        for i, (slot, req) in enumerate(members):
            self._place(slot, req, int(first[i]))

    def _admit_draft(self, kind: str, tokens, lens, slots, n: int) -> None:
        """Prefill the draft model's cache for a freshly admitted group
        (same rows, same slots, no extra inputs).  The target's prefill
        decides the first token, so the draft's logits are dropped; its
        cache position lands at ``lens``, in lockstep with the target."""
        if self.draft is None:
            return
        _, dc = self.draft.prefill(
            self.draft_params, self._tensor(tokens), max_seq=self._hist_cap,
            lens=self._tensor(lens) if kind == "pad" else None)
        _insert_rows(self._draft_cache, dc, self._tensor(slots[:n]).long(),
                     self._draft_axes)

    # ---- paged admission ---------------------------------------------
    def _plan_pages(self, req: Request):
        """Reserve the request's full page budget (prompt + decode room,
        so decode can never run out), sharing full prompt pages through
        the chain-hash registry.  Returns ``(pages, copy_lps)`` — physical
        pages per logical page, plus which logical pages need their K/V
        copied from the prefill (shared hits need none) — or None with
        every reservation rolled back when the pool can't fit it."""
        plen = len(req.prompt)
        # + spec_k: room for the draft rows a final verify pass writes past
        # the budget (the over-reserved tail frees at retirement)
        n_total = -(-(plen + req.max_new_tokens - 1 + self.spec_k)
                    // self.page_size)
        n_prompt = -(-plen // self.page_size)
        n_full = plen // self.page_size  # only fully covered pages share
        prompt = np.asarray(req.prompt, np.int32)
        salt = _extra_digest(req.extra)
        pages: List[int] = []
        copies: List[int] = []
        for k in range(n_total):
            h = None
            pid = None
            if k < n_full:
                h = _chain_hash(prompt, (k + 1) * self.page_size, salt)
                pid = self.pool.lookup(h)
            if pid is None:
                pid = self.pool.alloc(h)
                if pid is None:
                    for p in pages:
                        self.pool.free(p)
                    return None
                if k < n_prompt:
                    copies.append(k)
            pages.append(pid)
        return pages, copies

    def _admit_paged(self) -> None:
        if not self.queue:
            return
        free = np.flatnonzero(~self.active)
        if free.size == 0:
            return
        selected = self._select(int(free.size))
        admitted: List[Tuple[int, Request, List[int], List[int]]] = []
        for i, req in enumerate(selected):
            plan = self._plan_pages(req)
            if plan is None:
                # pool exhausted: requeue this and everything behind it
                # at the front, order preserved — retirements will free
                # pages and the next admission retries
                self.queue.extendleft(reversed(selected[i:]))
                break
            admitted.append((int(free[len(admitted)]), req, *plan))
        groups: Dict[Tuple, list] = {}
        for entry in admitted:
            groups.setdefault(self._group_key(entry[1]), []).append(entry)
        for (kind, seq_len, _), members in groups.items():
            self._admit_group_paged(kind, seq_len, members)

    def _admit_group_paged(self, kind: str, seq_len: int, members) -> None:
        """Prefill a group densely into a throwaway mini-cache padded to a
        page multiple, then copy its prompt pages into the pool: one
        indexed gather of every copied page (all layers at once) and one
        scatter into the pool.  Shared prefix pages already hold their
        data and are not copied."""
        n = len(members)
        tokens, lens, temps, slots, extra = self._group_inputs(seq_len,
                                                               members)
        src_row: List[int] = []
        src_page: List[int] = []
        dst_page: List[int] = []
        for i, (slot, req, pages, copies) in enumerate(members):
            row = np.full(self._max_pages, -1, np.int32)
            row[:len(pages)] = pages
            self._ptable[slot] = row
            self._slot_pages[slot] = pages
            for lp in copies:
                src_row.append(i)
                src_page.append(lp)
                dst_page.append(pages[lp])
        self._ptable_dirty = True
        page = self.page_size
        s_cache = -(-seq_len // page) * page
        first, cache1 = self._prefill_sample(kind, tokens, lens, temps, slots,
                                             extra, s_cache)
        if dst_page:
            r = self._tensor(np.asarray(src_row)).long()
            lp = self._tensor(np.asarray(src_page)).long()
            dp = self._tensor(np.asarray(dst_page)).long()
            for name, pool in (("k", "k_pool"), ("v", "v_pool")):
                L, n_pad, _, KH, Dh = cache1[name].shape
                mini = cache1[name].view(L, n_pad, s_cache // page, page, KH, Dh)
                blocks = mini[:, r, lp]  # (L, n_copy, page, KH, Dh)
                self.cache[pool][:, :, dp] = blocks.permute(0, 3, 1, 2, 4)
        idx = self._tensor(slots[:n]).long()
        self.cache["pos"][idx] = self._tensor(lens[:n])
        self._admit_draft(kind, tokens, lens, slots, n)
        first = first.cpu().numpy()
        for i, (slot, req, _, _) in enumerate(members):
            self._place(slot, req, int(first[i]))

    def _sync_ptable(self) -> None:
        """Upload the host page-table mirror before a decode step.  Rows
        parked at -1 (retired slots) clamp to the null page, so a
        freed-and-reallocated page is never written by its old owner."""
        if self.engine == "paged" and self._ptable_dirty:
            self.cache["page_table"].copy_(torch.from_numpy(self._ptable))
            self._ptable_dirty = False

    def _sync_hist(self) -> None:
        """Upload the history rows of freshly admitted slots (prompt and
        the admission-sampled token).  The rounds keep continuing slots'
        rows current on the device, so only admissions transfer."""
        if self.spec_k == 0 or not self._hist_dirty:
            return
        idx = sorted(set(self._hist_dirty))
        self._hist_dirty = []
        rows = np.zeros((len(idx), self._hist_cap), np.int32)
        for r, slot in enumerate(idx):
            req = self.req[slot]
            if req is None:  # admitted and retired at once: the row is dead
                continue
            seq = np.concatenate([np.asarray(req.prompt, np.int64),
                                  np.asarray(self.emitted[slot], np.int64)])
            seq = seq[:self._hist_cap]
            rows[r, :len(seq)] = seq
        self.hist[self._tensor(np.asarray(idx)).long()] = self._tensor(rows)

    def _place(self, slot: int, req: Request, first: int) -> None:
        """Occupy a slot with a freshly prefilled request and apply the
        retire rules to its admission-sampled token — a prefill EOS (or a
        1-token budget) finishes the request without a decode step."""
        self.active[slot] = True
        self.req[slot] = req
        self.emitted[slot] = [first]
        self.last_token[slot] = first
        self.temps[slot] = req.temperature
        if self.spec_k > 0:
            self._hist_dirty.append(slot)
        if first == self.eos_id:
            self._retire(slot, "eos")
        elif req.max_new_tokens <= 1:
            self._retire(slot, "length")

    def _retire(self, slot: int, reason: str) -> None:
        req = self.req[slot]
        self.done.append(
            Completion(req.uid, list(self.emitted[slot]), len(req.prompt),
                       reason))
        self.active[slot] = False
        self.req[slot] = None
        self.emitted[slot] = []
        if self.engine == "paged":
            for p in self._slot_pages[slot]:
                self.pool.free(p)
            self._slot_pages[slot] = []
            self._ptable[slot] = -1  # park: dead writes go to the null page
            self._ptable_dirty = True

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _consume(self, tok_rows: np.ndarray) -> None:
        """Apply decoded tokens, one (B,) row per decode step, to the host
        bookkeeping — the same retire rules the device chunk mask uses,
        so host and device state stay in lockstep."""
        self.chunk_steps_total += len(tok_rows)
        for row in tok_rows:
            if not self.active.any():
                break  # the rest of the chunk is dead work
            self.chunk_steps_used += 1
            for slot in range(self.max_batch):
                if not self.active[slot]:
                    continue
                req = self.req[slot]
                tok = int(row[slot])
                self.emitted[slot].append(tok)
                self.last_token[slot] = tok
                if tok == self.eos_id:
                    self._retire(slot, "eos")
                elif len(self.emitted[slot]) >= req.max_new_tokens:
                    self._retire(slot, "length")

    def step(self) -> None:
        """One engine iteration: admit new work, decode one token for
        every slot, retire finished slots — one (B,) host transfer."""
        self._admit()
        self._sync_ptable()
        if not self.active.any():
            return
        toks, self.cache = self.model.decode_and_sample(
            self.params, self.cache, self._tensor(self.last_token)[:, None],
            seed=self.seed, temperatures=self.temps,
            greedy_only=self._all_greedy())
        self._consume(self._to_host(toks)[None])

    def _decode_chunk(self, budgets: np.ndarray,
                      counts: np.ndarray) -> torch.Tensor:
        """``decode_chunk`` decode+sample steps on the device, masking
        slots that finish (EOS or budget) so their later tokens are dead.
        Returns the ``(steps, B)`` tokens — the chunk's one transfer."""
        last = self._tensor(self.last_token)
        act = self._tensor(self.active)
        cnt = self._tensor(counts)
        bud = self._tensor(budgets)
        greedy_only = self._all_greedy()
        rows = []
        for _ in range(self.decode_chunk):
            toks, self.cache = self.model.decode_and_sample(
                self.params, self.cache, last[:, None], seed=self.seed,
                temperatures=self.temps, greedy_only=greedy_only)
            cnt = cnt + act.to(torch.int32)
            rows.append(torch.where(act, toks, torch.zeros_like(toks)))
            finished = act & ((toks == self.eos_id) | (cnt >= bud))
            last = torch.where(act, toks, last)
            act = act & ~finished
        return torch.stack(rows)

    def step_chunk(self) -> int:
        """One chunked iteration: admit, then decode ``decode_chunk``
        tokens per slot with one host transfer.  Returns the number of
        decode steps run (0 when idle)."""
        if self.decode_chunk == 1:
            self.step()
            return 1
        self._admit()
        self._sync_ptable()
        if not self.active.any():
            return 0
        budgets = np.asarray(
            [r.max_new_tokens if r is not None else 0 for r in self.req],
            np.int32)
        counts = np.asarray([len(e) for e in self.emitted], np.int32)
        self._consume(self._to_host(self._decode_chunk(budgets, counts)))
        return self.decode_chunk

    # ---- speculative decode ------------------------------------------
    def _draft_propose(self, last: torch.Tensor, pos: torch.Tensor,
                       greedy_only: bool):
        """``spec_k`` draft-model decode steps from ``last``: the drafts
        ``(B, k)`` (greedy rows take the argmax, temperature rows draw
        from the stream tagged ``TAG_DRAFT`` at the draft's position) and
        the draft's softmax ``(B, k, V)`` at each step, which the
        rejection test needs (None when every row is greedy)."""
        safe = self._tensor(np.where(self.temps > 0, self.temps,
                                     1.0).astype(np.float32))
        dc, cur = self._draft_cache, last
        toks, probs = [], []
        for j in range(self.spec_k):
            lg, dc = self.draft.decode_step(self.draft_params, dc,
                                            cur[:, None])
            cur = sampling.sample_tokens(
                lg, self.temps, seed=self.seed, slots=range(self.max_batch),
                pos=pos + 1 + j, greedy_only=greedy_only,
                tag=speculate.TAG_DRAFT)
            toks.append(cur)
            if not greedy_only:
                probs.append(torch.softmax(lg.float() / safe[:, None], -1))
        self._draft_cache = dc
        return (torch.stack(toks, dim=1),
                torch.stack(probs, dim=1) if probs else None)

    def _spec_chunk(self, budgets: np.ndarray,
                    counts: np.ndarray) -> torch.Tensor:
        """``max(1, decode_chunk)`` draft/verify rounds on the device, each
        committing 1..k+1 tokens per slot from one target pass.

        Per round and slot: propose ``k`` drafts, verify all ``k + 1``
        positions at once, keep the longest prefix the target agrees with
        (:func:`repro_torch.models.speculate.accept_and_emit`), cut the run
        at the first EOS and at the token budget as the decode chunk's
        mask does, and rewind the cache's ``pos`` to the last committed
        token — rejected rows need no K/V surgery, the per-row limits hide
        everything above ``pos``.  Returns ``(rounds, B, k + 3)`` int32:
        per round the ``k + 1`` candidate tokens, then ``m`` (tokens
        committed) and ``accepted`` (drafts that survived) — the chunk's
        one transfer."""
        K = self.spec_k
        last = self._tensor(self.last_token)
        act = self._tensor(self.active)
        cnt = self._tensor(counts)
        bud = self._tensor(budgets)
        greedy_only = self._all_greedy()
        jcol = torch.arange(K + 1, device=self.device)[None]
        rows = []
        for _ in range(max(1, self.decode_chunk)):
            pos = self.cache["pos"]  # plen + cnt - 1 for live slots
            if self.draft is None:
                drafts = speculate.ngram_propose(self.hist, pos + 1, k=K,
                                                 n=self.spec_ngram_n)
                q_probs = None
            else:
                drafts, q_probs = self._draft_propose(last, pos, greedy_only)
            vt = torch.cat([last[:, None], drafts], dim=1)
            logits, cache = self.model.verify_step(self.params, self.cache, vt)
            emitted, m, accepted = speculate.accept_and_emit(
                logits, drafts, q_probs, self.temps, seed=self.seed,
                slots=range(self.max_batch), pos0=pos + 1,
                bonus=self.draft is None, greedy_only=greedy_only)
            # tokens after the first EOS or past the budget are dead
            is_eos = (jcol < m[:, None]) & (emitted == self.eos_id)
            eos_idx = torch.where(is_eos, jcol, K + 2).min(dim=1).values
            m_eff = torch.minimum(torch.minimum(m, eos_idx + 1),
                                  torch.clamp(bud - cnt, min=0))
            m_eff = torch.where(act, m_eff, 0).to(torch.int32)
            new_pos = pos + m_eff  # rollback: rejected rows stay above pos
            self.cache = dict(cache, pos=new_pos)
            if self.draft is not None:
                # the draft cache holds [last, d_1 .. d_{k-1}] at pos ..
                # pos + k - 1; every committed token up to the new last
                # matches it, so syncing pos is the whole rollback
                self._draft_cache = dict(self._draft_cache, pos=new_pos)
            cnt2 = cnt + m_eff
            lidx = torch.clamp(m_eff - 1, 0, K).long()
            last = torch.where(act & (m_eff > 0),
                               torch.gather(emitted, 1, lidx[:, None])[:, 0],
                               last)
            fin = act & ((eos_idx + 1 <= m_eff) | (cnt2 >= bud))
            speculate.update_history(self.hist, pos, emitted, m_eff, act)
            rows.append(torch.cat([emitted, m_eff[:, None],
                                   accepted[:, None]], dim=1))
            act = act & ~fin
            cnt = cnt2
        return torch.stack(rows)

    def _consume_spec(self, rows: np.ndarray) -> None:
        """Apply speculative rounds — ``rows`` is ``(R, B, k + 3)`` — with
        the retire rules the device mask uses, so host and device stay in
        lockstep."""
        mcol, acol = self.spec_k + 1, self.spec_k + 2
        self.chunk_steps_total += len(rows)
        for row in rows:
            if not self.active.any():
                break  # the rest of the chunk is dead work
            self.chunk_steps_used += 1
            for slot in range(self.max_batch):
                if not self.active[slot]:
                    continue
                req = self.req[slot]
                m = int(row[slot, mcol])
                self.spec_rounds += 1
                self.spec_proposed += self.spec_k
                self.spec_accepted += int(row[slot, acol])
                self.spec_tokens += m
                for j in range(m):
                    tok = int(row[slot, j])
                    self.emitted[slot].append(tok)
                    self.last_token[slot] = tok
                    if tok == self.eos_id:
                        self._retire(slot, "eos")
                        break
                    if len(self.emitted[slot]) >= req.max_new_tokens:
                        self._retire(slot, "length")
                        break

    def step_spec(self) -> int:
        """One speculative iteration: admit, then run ``decode_chunk``
        draft/verify rounds — up to ``decode_chunk * (spec_k + 1)`` tokens
        per slot for one host transfer.  Returns the rounds run (0 when
        idle)."""
        self._admit()
        self._sync_ptable()
        self._sync_hist()
        if not self.active.any():
            return 0
        budgets = np.asarray(
            [r.max_new_tokens if r is not None else 0 for r in self.req],
            np.int32)
        counts = np.asarray([len(e) for e in self.emitted], np.int32)
        self._consume_spec(self._to_host(self._spec_chunk(budgets, counts)))
        return max(1, self.decode_chunk)

    def run(self, max_steps: int = 10_000) -> List[Completion]:
        steps = 0
        while (self.queue or self.active.any()) and steps < max_steps:
            if self.spec_k > 0:
                steps += self.step_spec() or 1
            else:
                steps += self.step_chunk() or 1
        return self.done

    # ------------------------------------------------------------------
    @property
    def live_tokens(self) -> int:
        """Tokens resident in the KV cache across active slots (prompt +
        emitted so far)."""
        return sum(
            len(self.req[s].prompt) + len(self.emitted[s])
            for s in range(self.max_batch) if self.active[s])

    def kv_stats(self) -> Dict[str, float]:
        """KV-memory accounting: a dense engine reserves the full
        ``max_batch x max_seq`` rectangle up front, a paged engine holds
        ``pages_in_use x page`` tokens — memory proportional to live
        tokens, not to the worst-case shape."""
        cfg = self.model.cfg
        per_tok = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim
                   * getattr(torch, cfg.dtype).itemsize)
        live = self.live_tokens
        stats: Dict[str, float] = {
            "kv_bytes_per_token": per_tok,
            "live_tokens": live,
            "chunk_utilization": (self.chunk_steps_used
                                  / max(1, self.chunk_steps_total)),
        }
        if self.spec_k > 0:
            stats.update(
                spec_rounds=self.spec_rounds,
                spec_tokens=self.spec_tokens,
                spec_accepted=self.spec_accepted,
                spec_proposed=self.spec_proposed,
                spec_accept_rate=(self.spec_accepted
                                  / max(1, self.spec_proposed)),
                spec_tokens_per_round=(self.spec_tokens
                                       / max(1, self.spec_rounds)),
            )
        if self.engine == "paged":
            in_use = self.pool.pages_in_use * self.page_size * per_tok
            stats.update(
                kv_bytes_allocated=self.num_pages * self.page_size * per_tok,
                kv_bytes_in_use=in_use,
                kv_bytes_per_live_token=in_use / max(1, live),
                pages_in_use=self.pool.pages_in_use,
                pages_total=self.pool.capacity,
                prefix_hits=self.pool.prefix_hits,
                prefix_lookups=self.pool.prefix_lookups,
                prefix_hit_rate=self.pool.hit_rate,
            )
        else:
            alloc = self.max_batch * self.max_seq * per_tok
            stats.update(
                kv_bytes_allocated=alloc,
                kv_bytes_in_use=alloc,  # dense: reserved whether live or not
                kv_bytes_per_live_token=alloc / max(1, live),
            )
        return stats


def smoke_serve(model: Model, params, *, num_requests: int, vocab_size: int,
                max_batch: int = 8, max_seq: int = 96, prompt_len: int = 8,
                max_new_tokens: int = 8, seed: int = 0, engine: str = "fused",
                decode_chunk: int = 1, temperature: float = 0.0,
                page_size: int = 16, num_pages: Optional[int] = None,
                spec_k: int = 0, spec_ngram_n: int = 3,
                draft: Optional[Model] = None, draft_params=None
                ) -> Tuple[List[Completion], Dict[str, float]]:
    """Drive one engine through a synthetic request burst and report
    throughput stats.  Returns (completions, stats): request and token
    counts, wall time and tokens/s (the clock stops after the last
    token reached the host), the acceptance rate and tokens per round
    when ``spec_k > 0``, plus the page pool's counters when
    ``engine='paged'``.  Runs on the model's device."""
    eng = ServeEngine(model, params, max_batch=max_batch, max_seq=max_seq,
                      seed=seed, engine=engine, decode_chunk=decode_chunk,
                      page_size=page_size, num_pages=num_pages,
                      spec_k=spec_k, spec_ngram_n=spec_ngram_n,
                      draft=draft, draft_params=draft_params)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for i in range(num_requests):
        eng.submit(Request(uid=i,
                           prompt=rng.integers(1, vocab_size, prompt_len),
                           max_new_tokens=max_new_tokens,
                           temperature=temperature))
    completions = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(c.tokens) for c in completions)
    stats = {"requests": len(completions), "tokens": toks,
             "step_time_s": dt, "tok_per_s": toks / max(dt, 1e-9),
             "engine": engine, "decode_chunk": decode_chunk,
             "d2h_transfers": eng.d2h_transfers,
             "chunk_utilization": (eng.chunk_steps_used
                                   / max(1, eng.chunk_steps_total))}
    if spec_k > 0:
        stats["spec_k"] = spec_k
        stats["spec_accept_rate"] = (eng.spec_accepted
                                     / max(1, eng.spec_proposed))
        stats["spec_tokens_per_round"] = (eng.spec_tokens
                                          / max(1, eng.spec_rounds))
    if engine == "paged":
        stats["prefix_hit_rate"] = eng.pool.hit_rate
        stats["prefix_hits"] = eng.pool.prefix_hits
        stats["pages_total"] = eng.pool.capacity
        stats["pages_in_use"] = eng.pool.pages_in_use
    return completions, stats
