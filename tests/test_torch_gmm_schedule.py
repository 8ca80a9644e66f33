"""K4's tensor-core tile walk (``repro_torch.kernels.moe_gmm.tile_order``,
the Python mirror of ``tile_at`` in ``csrc/moe_gmm.cu``), on the CPU.

Properties, over random group sizes (empty groups, groups of up to 6000
rows, so of several bands of ``BAND`` row tiles, sizes whose sum falls
short of M or runs past it), widths and block counts, at the kernel's
own tiling (``BM``, ``BN``, ``BAND``): every output tile
is covered exactly once; no tile straddles two experts; the tail group's
tiles are exactly the rows past ``sum(sizes)``, clamped to M; empty
groups own no tile; each block's order is fixed.  The card test
``test_moe_gmm_walk_matches_tile_order`` holds the kernel's own walk
against this mirror."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import moe_gmm


@st.composite
def walks(draw):
    E = draw(st.integers(1, 12))
    sizes = draw(st.lists(st.one_of(st.just(0), st.integers(0, 300),
                                    st.integers(0, 6000)),
                          min_size=E, max_size=E))
    M = draw(st.one_of(st.just(max(sum(sizes), 1)), st.integers(1, 20000)))
    N = 8 * draw(st.integers(1, 160))
    blocks = draw(st.integers(1, 140))
    return sizes, M, N, blocks


def _expert_ranges(sizes, M):
    """Each expert's rows, clamped to M, and the tail's rows."""
    starts = np.concatenate([[0], np.cumsum(sizes)])
    ranges = [(min(int(a), M), min(int(b), M))
              for a, b in zip(starts[:-1], starts[1:])]
    return ranges, (min(int(starts[-1]), M), M)


@settings(max_examples=150, deadline=None)
@given(walks())
def test_every_output_tile_is_covered_exactly_once(case):
    sizes, M, N, blocks = case
    order = moe_gmm.tile_order(sizes, M, N, blocks)
    assert len(order) == blocks
    n_ct = -(-N // moe_gmm.BN)
    hits = np.zeros((M, n_ct), dtype=np.int64)
    for g, row0, row_end, n0 in (t for block in order for t in block):
        assert 0 <= row0 < row_end <= M and row_end - row0 <= moe_gmm.BM
        assert n0 % moe_gmm.BN == 0 and 0 <= n0 < N
        hits[row0:row_end, n0 // moe_gmm.BN] += 1
    assert (hits == 1).all()


@settings(max_examples=150, deadline=None)
@given(walks())
def test_tiles_keep_to_their_group(case):
    """No tile straddles two experts; the tail group E holds exactly the
    rows past sum(sizes), clamped to M; an empty group owns no tile."""
    sizes, M, N, blocks = case
    E = len(sizes)
    ranges, tail = _expert_ranges(sizes, M)
    owner = np.full(M, -1, dtype=np.int64)  # the group whose tiles hold a row
    tiles_of = np.zeros(E + 1, dtype=np.int64)
    for g, row0, row_end, _ in (t for b in moe_gmm.tile_order(
            sizes, M, N, blocks) for t in b):
        lo, hi = tail if g == E else ranges[g]
        assert lo <= row0 < row_end <= hi, (g, row0, row_end, lo, hi)
        owner[row0:row_end] = g
        tiles_of[g] += 1
    want = np.full(M, -1, dtype=np.int64)
    for g, (lo, hi) in enumerate(ranges + [tail]):
        want[lo:hi] = g
        if hi == lo:
            assert tiles_of[g] == 0, g
    assert (owner == want).all()


@settings(max_examples=100, deadline=None)
@given(walks())
def test_each_block_takes_a_fixed_stride_of_one_walk(case):
    """Block b takes tiles b, b + blocks, ... of the one-block walk, the
    same on every call: the order cannot depend on timing."""
    sizes, M, N, blocks = case
    walk = moe_gmm.tile_order(sizes, M, N, 1)[0]
    order = moe_gmm.tile_order(sizes, M, N, blocks)
    assert order == [walk[b::blocks] for b in range(blocks)]
    assert moe_gmm.tile_order(sizes, M, N, blocks) == order


def test_raster_runs_the_row_tile_fastest_inside_a_band():
    """phi3.5-moe's gate projection at batch 2: 16 groups of 10 row tiles,
    25 column tiles; a band is a whole group (10 <= 16), so the first 132
    tiles (one an SM) cover group 0's 10 row tiles at column tiles 0-13
    and group 0 ends at tile 250."""
    walk = moe_gmm.tile_order([1280] * 16, 20480, 6400, 1)[0]
    assert len(walk) == 16 * 10 * 25
    assert walk[:10] == [(0, 128 * r, 128 * (r + 1), 0) for r in range(10)]
    assert walk[10] == (0, 0, 128, 256)
    first = walk[:132]
    assert {t[0] for t in first} == {0}
    assert {t[3] // 256 for t in first} == set(range(14))
    assert walk[250] == (1, 1280, 1408, 0)


def test_raster_walks_a_long_group_band_by_band():
    """A group of 5000 rows is 40 row tiles: bands of 16, 16 and 8, each
    walked row tile fastest over all 3 column tiles before the next band;
    the last row tile holds the group's 8 ragged rows."""
    assert moe_gmm.BAND == 16
    walk = moe_gmm.tile_order([5000], 5000, 600, 1)[0]
    assert len(walk) == 40 * 3
    want = []
    for first, rows in ((0, 16), (16, 16), (32, 8)):
        for n0 in (0, 256, 512):
            want += [(0, 128 * r, min(128 * (r + 1), 5000), n0)
                     for r in range(first, first + rows)]
    assert walk == want
    assert walk[-1] == (0, 4992, 5000, 512)


@pytest.mark.parametrize("sizes,M,want_row_start,want_tile_start", [
    ([300, 0, 211, 489, 0], 1000, [0, 300, 300, 511, 1000, 1000, 1000],
     [0, 3, 3, 5, 9, 9, 9]),
    ([0, 700, 0, 500], 1000, [0, 0, 700, 700, 1000, 1000],
     [0, 0, 6, 6, 9, 9]),           # sum past M: the last group clamped
    ([100, 50], 600, [0, 100, 150, 600], [0, 1, 2, 6]),  # a 450-row tail
])
def test_schedule_is_the_schedule_kernel_s(sizes, M, want_row_start,
                                           want_tile_start):
    assert moe_gmm.schedule(sizes, M) == (want_row_start, want_tile_start)
