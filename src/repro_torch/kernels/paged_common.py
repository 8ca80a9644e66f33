"""What K2 (:mod:`.paged_attention`) and K3 (:mod:`.paged_attention_mq`)
share: their path rule, their row tiles and their split over the
sequence, in Python as ``csrc/paged_common.cuh`` has them, and the launch
both wrappers make.

The split: a launch walks a slot's page table in ``splits`` contiguous
ranges of ``split_pages(...)`` entries, each a whole number of pages and of
64-token chunks, one block a (split, row tile, KV head, slot); with more
than one split each block writes float32 partials ``(m, l, acc)`` and a
merge kernel adds them in split order.  :func:`split_plan` chooses
``splits`` from the batch, the KV heads, the row tiles, the table's width
and the SM count alone, about :data:`WAVES` waves of blocks, at least
:data:`MIN_CHUNKS` chunks a split.  It never reads the lengths, which live
on the card: the serving loop is host bound, and a read would stall it.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build

CT = 64            # kv tokens a chunk
TC_ROWS = 64       # query rows of a tensor-core tile
WAVES = 1          # blocks the plan aims at, in SM counts
MIN_CHUNKS = 4     # chunks a split walks at least
MAX_SMEM = 232448  # shared memory a block may use on sm_90
H100_SMS = 132     # the SM count a dry call plans with (an H100 SXM)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tensor_core_path(dtype: torch.dtype, D: int, page: int) -> bool:
    """Whether the walk runs on the tensor cores (the C rule
    ``repro_paged_tensor_cores``): bf16, D 64 or 128, a page of 8, 16, 32
    or 64 rows or a multiple of 64."""
    return (dtype == torch.bfloat16 and D in (64, 128) and page >= 8
            and (CT % page == 0 or page % CT == 0))


def fma_tile_rows(rows: int, D: int) -> int:
    """Rows of one tile of the FMA walk: the fewest tiles whose shared
    memory fits in a block, balanced."""
    fixed = CT * (2 * D + 1)
    per_row = 2 * D + CT + 3
    fit = (MAX_SMEM // 4 - fixed) // per_row
    if rows < 1 or fit < 1:
        return 0
    tiles = -(-rows // fit)
    return -(-rows // tiles)


def tile_rows(rows: int, D: int, page: int, dtype: torch.dtype) -> int:
    """Rows of one row tile of a launch for ``rows = T * G`` (the C entry
    ``repro_paged_attention_mq_tile_rows``)."""
    if rows < 1:
        return 0
    if tensor_core_path(dtype, D, page):
        return min(rows, TC_ROWS)
    return fma_tile_rows(rows, D)


def unit_pages(page: int) -> int:
    """Pages of a split unit: whole pages that are whole 64-token chunks."""
    return CT // math.gcd(page, CT)


def split_pages(max_pages: int, page: int, splits: int) -> int:
    """Table entries each split walks (the C entry
    ``repro_paged_split_pages``); 0 when ``splits`` does not cut the
    table into that many non-empty ranges."""
    unit = unit_pages(page)
    units = -(-max_pages // unit)
    if not 1 <= splits <= units:
        return 0
    per = -(-units // splits)
    if -(-units // per) != splits:
        return 0
    return per * unit


def split_plan(B: int, KH: int, tiles: int, max_pages: int, page: int,
               sms: int) -> int:
    """The number of splits of a launch: about ``WAVES * sms`` blocks,
    each split at least ``MIN_CHUNKS`` chunks, every split non-empty."""
    unit = unit_pages(page)
    units = -(-max_pages // unit)
    chunks = units * unit * page // CT
    want = max(1, WAVES * sms // (B * KH * tiles))
    splits = max(1, min(want, units, chunks // MIN_CHUNKS))
    per = -(-units // splits)
    return -(-units // per)


def walk(base: int, r0: int, R: int, G: int, split: int, pps: int,
         page: int, max_pages: int) -> tuple:
    """The kv range ``[lo, hi)`` the block of split ``split`` walks for the
    rows ``r0 .. r0 + R - 1`` (row ``r`` at draft position ``r // G``) of a
    slot whose row 0 sees ``base`` positions, and the split's end: what
    ``walk_of`` in ``csrc/paged_common.cuh`` computes.  Row ``r`` sees the
    positions ``< min(base + r // G, end)`` of it."""
    lo = split * pps * page
    end = min(max_pages * page, lo + pps * page)
    hi = max(lo, min(end, base + (r0 + R - 1) // G))
    return lo, hi, end


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan(dtype: torch.dtype, B: int, T: int, KH: int, G: int, D: int,
          page: int, max_pages: int, index: int) -> tuple:
    """A launch's path, splits and float32 scratch values (0 for one
    split), computed once a shape: the wrappers are on the serving loop's
    host path."""
    tc = tensor_core_path(dtype, D, page)
    rows = T * G
    tiles = -(-rows // tile_rows(rows, D, page, dtype))
    sms = H100_SMS if index is None else sm_count(index)
    splits = split_plan(B, KH, tiles, max_pages, page, sms)
    return tc, splits, (B * KH * splits * rows * (D + 2) if splits > 1
                        else 0)


def launch(entry: str, q: torch.Tensor, k_pool: torch.Tensor,
           v_pool: torch.Tensor, page_table: torch.Tensor,
           base: torch.Tensor, shape: tuple, dry: bool = False) -> tuple:
    """Launch ``entry`` (``repro_paged_attention`` with ``shape`` =
    ``(B, KH, G, D, P, page, max_pages)``, or
    ``repro_paged_attention_mq`` with ``(B, T, KH, G, D, P, page,
    max_pages)``) on the current stream, the split chosen by
    :func:`split_plan`.  Returns ``(out, tensor_cores, splits)``.  A
    ``dry`` call (under a counter, :func:`work.dry`) plans for an H100,
    allocates what the launch would and launches nothing."""
    B, T = q.shape[:2]
    KH, G, D, _, page, max_pages = shape[-6:]
    tc, splits, n_part = _plan(q.dtype, B, T, KH, G, D, page, max_pages,
                               None if dry else q.device.index)
    out = torch.empty_like(q)
    part = (torch.empty(n_part, dtype=torch.float32, device=q.device)
            if n_part else None)
    if dry:
        return out, tc, splits
    err = getattr(build.library(), entry)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), base.data_ptr(), out.data_ptr(), *shape,
        D ** -0.5, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream, splits,
        None if part is None else part.data_ptr())
    build.check(err, entry)
    return out, tc, splits
