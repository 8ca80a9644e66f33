"""K2's and K3's split over the sequence, on the CPU.

The page walk of ``csrc/paged_common.cuh`` splits a slot's page table into
``splits`` ranges, chosen on the host by ``paged_common.split_plan`` from
the batch, the KV heads, the row tiles, the table's width and the SM
count (never from the lengths, which live on the card), and merges the
splits' float32 partials in split order.  Here, over random shapes,
lengths and SM counts (hypothesis): every position a row sees lies in
exactly one split's walk, and no position it does not see in any; the
splits are page aligned, whole 64-token chunks, non-empty and in
sequence order (so the merge, in split order, adds them in a fixed
order); a split wholly past what a tile's rows see walks nothing (an
empty partial).  Then ``ref.paged_attention_split``, the algorithm in
plain PyTorch, is held against the reference's Pallas kernels
``paged_attention_bkgd`` and ``paged_attention_mq_bkgd`` in interpret
mode on the same numpy inputs, in float32 within 2e-5 (the two sum in
other orders), at every split count a table admits, with empty splits,
lengths on page edges, ``kv_len`` 1 and ``base_len`` 1.  The card tests
hold the C entries' split and tiles against these mirrors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ops as jops
from repro_torch.kernels import paged_common as pc
from repro_torch.kernels import ref as tref
from test_torch_model import one_torch_thread  # noqa: F401

TOL = 2e-5


@st.composite
def launches(draw):
    page = draw(st.sampled_from([8, 16, 32, 64, 128, 192, 24, 100]))
    max_pages = draw(st.integers(1, 3000 // page + 8))
    cap = max_pages * page
    T = draw(st.integers(1, 9))
    return dict(
        B=draw(st.integers(1, 256)), KH=draw(st.integers(1, 8)), T=T,
        G=draw(st.integers(1, 16)),
        D=draw(st.sampled_from([64, 128, 96, 256])),
        dtype=draw(st.sampled_from([torch.bfloat16, torch.float32])),
        page=page, max_pages=max_pages,
        sms=draw(st.sampled_from([1, 16, 78, 114, 132])),
        bases=draw(st.lists(st.integers(0, cap + 4), min_size=1,
                            max_size=4)))


@settings(max_examples=300, deadline=None)
@given(launches())
def test_split_plan_partitions_what_each_row_sees(c):
    rows = c["T"] * c["G"]
    tile = pc.tile_rows(rows, c["D"], c["page"], c["dtype"])
    assert 1 <= tile <= rows
    if pc.tensor_core_path(c["dtype"], c["D"], c["page"]):
        assert tile == min(rows, pc.TC_ROWS)
    tiles = -(-rows // tile)
    splits = pc.split_plan(c["B"], c["KH"], tiles, c["max_pages"],
                           c["page"], c["sms"])
    pps = pc.split_pages(c["max_pages"], c["page"], splits)
    page, max_pages, cap = c["page"], c["max_pages"], c["max_pages"] * c["page"]
    # page aligned, whole chunks, non-empty, covering the table in order
    assert splits >= 1 and pps >= 1
    assert pps * page % pc.CT == 0
    assert (splits - 1) * pps < max_pages <= splits * pps
    # about WAVES waves of blocks, each split at least MIN_CHUNKS chunks
    blocks = c["B"] * c["KH"] * tiles
    assert blocks * splits <= max(blocks, pc.WAVES * c["sms"])
    if splits > 1:
        assert pps * page >= pc.MIN_CHUNKS * pc.CT
    for base in c["bases"]:
        for r0 in range(0, rows, tile):
            R = min(tile, rows - r0)
            seen = min(base + (r0 + R - 1) // c["G"], cap)
            walked = np.zeros(cap + 1, np.int64)
            prev_end = 0
            for s in range(splits):
                lo, hi, end = pc.walk(base, r0, R, c["G"], s, pps, page,
                                      max_pages)
                assert lo == prev_end and lo % page == 0 and lo < end
                prev_end = end
                assert lo <= hi <= end
                if lo >= seen:  # wholly past what the tile sees: empty
                    assert hi == lo
                walked[lo:hi] += 1
            assert prev_end == cap
            # every position the tile's furthest row sees once, none else
            assert (walked[:seen] == 1).all() and (walked[seen:] == 0).all()
            # each row's limit inside the split it ends in
            for r in range(r0, r0 + R):
                lim = min(base + r // c["G"], cap)
                assert lim <= seen


def test_split_plan_at_the_measured_shapes():
    # qwen2-1.5b (KH 2, G 6, D 128, page 16) on an H100's 132 SMs: the
    # serving main path runs one split; batch 8 at 32k 8 (128 blocks);
    # decode_32k one (256 blocks); batch 2 at 32k 32
    H100 = 132
    assert pc.split_plan(8, 2, 1, 6, 16, H100) == 1
    assert pc.split_plan(8, 2, 1, 7, 16, H100) == 1
    assert pc.split_plan(8, 2, 1, 2048, 16, H100) == 8
    assert pc.split_plan(128, 2, 1, 2048, 16, H100) == 1
    assert pc.split_plan(2, 2, 1, 2048, 16, H100) == 32
    assert pc.split_plan(2, 2, 1, 256, 16, H100) == 16
    assert pc.split_pages(2048, 16, 8) == 256
    assert pc.split_pages(6, 16, 2) == 4 and pc.split_pages(6, 16, 3) == 0


@pytest.mark.parametrize("rows,D,page,dtype,want", [
    (80, 128, 16, torch.float32, 80), (128, 128, 16, torch.float32, 128),
    (144, 128, 16, torch.float32, 72), (150, 128, 16, torch.float32, 75),
    (272, 128, 16, torch.float32, 91), (43, 256, 16, torch.float32, 43),
    (44, 256, 16, torch.float32, 22), (30, 128, 16, torch.bfloat16, 30),
    (144, 128, 16, torch.bfloat16, 64), (150, 64, 8, torch.bfloat16, 64),
    (144, 96, 16, torch.bfloat16, 144), (30, 128, 24, torch.bfloat16, 30),
])
def test_tile_rows(rows, D, page, dtype, want):
    assert pc.tile_rows(rows, D, page, dtype) == want


def _interpret(fn, *args, **static):
    """A reference ``ops`` entry point with its Pallas kernel in interpret
    mode, as one compiled program, then the default backend again."""
    jops.set_backend("interpret")
    try:
        return jax.jit(lambda *a: fn(*a, **static))(*args)
    finally:
        jops.set_backend("ref")


def _inputs(rng, B, T, KH, G, D, page, max_pages, base_len):
    """Random q and pools, a table mapping distinct pages (never the null
    page 0) for the positions the furthest row sees, -1 elsewhere."""
    P = 1 + B * max_pages
    q = rng.normal(size=(B, T, KH * G, D)).astype(np.float32)
    kp = rng.normal(size=(KH, P, page, D)).astype(np.float32)
    vp = rng.normal(size=(KH, P, page, D)).astype(np.float32)
    base = np.asarray(base_len, np.int32)
    table = np.full((B, max_pages), -1, np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        seen = min(int(base[b]) + T - 1, max_pages * page)
        for j in range(-(-seen // page)):
            table[b, j] = free.pop()
    return q, kp, vp, table, base


# (B, T, KH, G, D, page, max_pages, lengths): kv_len / base_len 1, lengths
# on page and chunk edges, slots whose later splits are empty, a -1 entry
# inside a live range (slot 0 of the T = 5 case), pages narrower and wider
# than a chunk
SPLIT_CASES = [
    (4, 1, 2, 3, 32, 16, 16, [1, 16, 64, 200]),
    (3, 1, 1, 4, 16, 8, 24, [1, 63, 129]),
    (2, 1, 2, 2, 32, 128, 3, [128, 300]),
    (4, 5, 2, 3, 32, 16, 16, [1, 12, 60, 250]),
    (2, 3, 1, 8, 16, 32, 10, [1, 254]),
    (2, 4, 2, 2, 32, 64, 4, [64, 190]),
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: f"T{c[1]}-page{c[5]}")
def test_split_and_merge_matches_the_reference_kernels(rng, case):
    B, T, KH, G, D, page, max_pages, lens = case
    q, kp, vp, table, base = _inputs(rng, B, T, KH, G, D, page, max_pages,
                                     lens)
    if T == 5:
        table[0, 0] = -1  # an unmapped entry read as the null page 0
    jq, jk, jv, jt, jb = (jnp.asarray(x) for x in (q, kp, vp, table, base))
    if T == 1:
        want = _interpret(lambda *a: jops.paged_decode_attention(
            *a[:4], kv_len=a[4]), jq, jk, jv, jt, jb)
    else:
        want = _interpret(lambda *a: jops.paged_decode_attention_mq(
            *a[:4], base_len=a[4]), jq, jk, jv, jt, jb)
    want = np.asarray(want, np.float32)
    tq, tk, tv, tt, tb = (torch.from_numpy(x)
                          for x in (q, kp, vp, table, base))
    counts = [s for s in range(1, max_pages + 1)
              if pc.split_pages(max_pages, page, s)]
    assert len(counts) >= 2
    outs = []
    for splits in counts:
        pps = pc.split_pages(max_pages, page, splits)
        got = tref.paged_attention_split(tq, tk, tv, tt, tb, pps)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
        outs.append(got)
    # one split is the unsplit plain version's algorithm
    plain = (tref.paged_attention if T == 1 else tref.paged_attention_mq)(
        tq, tk, tv, tt, tb)
    torch.testing.assert_close(outs[0], plain, atol=TOL, rtol=TOL)
    # the merge adds in split order: the same inputs give the same bits
    again = tref.paged_attention_split(
        tq, tk, tv, tt, tb, pc.split_pages(max_pages, page, counts[-1]))
    torch.testing.assert_close(again, outs[-1], atol=0, rtol=0)


def test_row0_of_the_split_verify_is_the_split_decode(rng):
    """K3 at one row is K2: row 0 of the split verify read equals the
    split decode read at kv_len = base_len, bit for bit."""
    q, kp, vp, table, base = _inputs(rng, 3, 4, 2, 3, 32, 16, 16,
                                     [1, 64, 190])
    tq, tk, tv, tt, tb = (torch.from_numpy(x)
                          for x in (q, kp, vp, table, base))
    for splits in (1, 2, 4):
        pps = pc.split_pages(16, 16, splits)
        mq = tref.paged_attention_split(tq, tk, tv, tt, tb, pps)
        one = tref.paged_attention_split(tq[:, :1].contiguous(), tk, tv, tt,
                                         tb, pps)
        torch.testing.assert_close(mq[:, :1], one, atol=0, rtol=0)
