"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: each test skips where there is no GPU (decided
inside the fixture, never at import).  Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 2e-5 (the kernel and the plain version sum in other
orders), bfloat16 2e-2 (outputs rounded to bfloat16; K1 and K1-bwd on
the tensor cores also round P, P^T, dS^T and dS to bfloat16 before their
products); K1-bwd's float32
gradients 2e-4 (the reference's own tolerance for its flash VJP, sums
over whole sequences in other orders); K6-bwd's gradients 1e-4 (float32)
and 2e-2 (bfloat16) of each gradient's max |g| (the same algorithm summed
in other orders, and the gates' gradients a cumulative sum over the
whole sequence); K5 2e-5 / 2e-2 abs+rel as the other forwards, K5-bwd's
gradients 1e-4 / 2e-2 of each gradient's max |g| (dB, dC, dA and dD are
sums over every channel or step, in other orders); K4 and its backward
2e-2 abs+rel in bfloat16 (outputs rounded to bfloat16) and 1e-4 of the
output's max |y| in float32 (sums over K of up to 4096 products in other
orders)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (build, flash_attention, flash_attention_bwd,
                                 mlstm_scan, moe_gmm, ops, paged_attention,
                                 paged_attention_mq, ref, ssm_scan)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,KH,D,causal,window,q_offset", [
    (2, 64, 64, 12, 2, 128, True, 0, 0),
    (1, 200, 200, 4, 4, 64, True, 0, 0),     # ragged S/T
    (2, 256, 256, 4, 2, 128, True, 64, 0),   # sliding window
    (1, 33, 100, 4, 1, 96, False, 0, 0),     # cross, odd sizes
    (1, 32, 96, 2, 2, 64, True, 0, 64),      # continuation
    (1, 40, 40, 2, 1, 256, True, 0, 0),      # widest head
])
def test_flash_kernel_matches_plain(dev, dtype, B, S, T, H, KH, D, causal,
                                    window, q_offset):
    gen = torch.Generator().manual_seed(0)
    q = _randn(gen, (B, S, H, D), dtype, dev)
    k = _randn(gen, (B, T, KH, D), dtype, dev)
    v = _randn(gen, (B, T, KH, D), dtype, dev)
    n0 = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.launches == n0 + 1
    want = ref.attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KH,G,D,page,max_pages", [
    (8, 2, 6, 128, 16, 8),
    (3, 4, 1, 64, 8, 16),
    (2, 1, 32, 256, 32, 3),
    (4, 2, 4, 96, 128, 2),   # pages wider than the kernel's chunk
])
def test_paged_kernel_matches_plain(dev, dtype, B, KH, G, D, page, max_pages):
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    P = 1 + B * max_pages
    q = _randn(gen, (B, 1, KH * G, D), dtype, dev)
    kp = _randn(gen, (KH, P, page, D), dtype, dev)
    vp = _randn(gen, (KH, P, page, D), dtype, dev)
    lens = rng.integers(1, page * max_pages + 1, B).astype(np.int32)
    lens[0] = page  # exact page boundary
    table = np.full((B, max_pages), -1, np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for j in range(-(-int(lens[b]) // page)):
            table[b, j] = free.pop()
    tt = torch.from_numpy(table).to(dev)
    tl = torch.from_numpy(lens).to(dev)
    n0 = paged_attention.launches
    got = ops.paged_decode_attention(q, kp, vp, tt, kv_len=tl)
    torch.cuda.synchronize()
    assert paged_attention.launches == n0 + 1
    want = ref.paged_attention(q, kp, vp, tt, tl)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(1, 8, 2, 100, device=dev)  # head_dim not a multiple of 8
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 8, 2, 64, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention_cuda(q, q, q)
    q = torch.zeros(1, 1, 64, 64, device=dev)  # group of 64 > 32
    pool = torch.zeros(1, 2, 16, 64, device=dev)
    table = torch.zeros(1, 1, dtype=torch.int32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="group size"):
        paged_attention.paged_attention_cuda(q, pool, pool, table, lens)


def _verify_inputs(dev, dtype, B, T, KH, G, D, page, max_pages, base_len,
                   seed=0):
    """Random q and pools, a table mapping distinct pages (never the null
    page 0) for the positions the furthest row sees, -1 elsewhere."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    P = 1 + B * max_pages
    q = _randn(gen, (B, T, KH * G, D), dtype, dev)
    kp = _randn(gen, (KH, P, page, D), dtype, dev)
    vp = _randn(gen, (KH, P, page, D), dtype, dev)
    lens = np.asarray(base_len, np.int32)
    table = np.full((B, max_pages), -1, np.int32)
    free = list(rng.permutation(np.arange(1, P)))
    for b in range(B):
        for j in range(min(max_pages, -(-(int(lens[b]) + T - 1) // page))):
            table[b, j] = free.pop()
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(lens).to(dev))


# the K3 cases of chip_smoke.py: (name, B, T, KH, G, D, page, max_pages,
# base_len)
VERIFY_CASES = [
    ("main-path", 8, 5, 2, 6, 128, 16, 7, [65, 70, 80, 95, 96, 64, 81, 90]),
    ("long", 8, 5, 2, 6, 128, 16, 64, [1, 16, 17, 512, 1020, 1000, 333, 32]),
    ("page-edges", 8, 5, 2, 6, 128, 16, 8, [1, 12, 16, 17, 28, 32, 48, 64]),
    ("G=16", 4, 5, 2, 16, 128, 16, 8, [1, 33, 64, 100]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", VERIFY_CASES, ids=lambda c: c[0])
def test_verify_kernel_matches_plain(dev, dtype, case):
    _, B, T, KH, G, D, page, max_pages, base_len = case
    q, kp, vp, tt, tl = _verify_inputs(dev, dtype, B, T, KH, G, D, page,
                                       max_pages, base_len)
    n0 = paged_attention_mq.launches
    got = ops.paged_decode_attention_mq(q, kp, vp, tt, base_len=tl)
    torch.cuda.synchronize()
    assert paged_attention_mq.launches == n0 + 1
    want = ref.paged_attention_mq(q, kp, vp, tt, tl)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # pages the rows cannot see are never read: scribble over them
    mapped = set(tt[tt >= 0].tolist())
    dead = [p for p in range(kp.shape[1]) if p not in mapped]
    kp[:, dead] = 1e4
    vp[:, dead] = -1e4
    again = ops.paged_decode_attention_mq(q, kp, vp, tt, base_len=tl)
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_kernel_one_row_matches_decode_kernel(dev, dtype):
    q, kp, vp, tt, tl = _verify_inputs(dev, dtype, 8, 1, 2, 6, 128, 16, 7,
                                       [65, 70, 80, 95, 96, 64, 81, 1])
    got = paged_attention_mq.paged_attention_mq_cuda(q, kp, vp, tt, tl)
    want = paged_attention.paged_attention_cuda(q, kp, vp, tt, tl)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_kernel_tiles_rows_past_one_block(dev, dtype):
    """144 query rows (T = 9, G = 16: glm4-9b at spec_k 8) do not fit in
    one block's shared memory at D = 128: they run as two row tiles and
    match the plain version.  Each row's bits do not depend on the tiling:
    the 128 rows of T = 8 (one tile, the untiled launch) equal the same
    rows inside the two-tile launch, bit for bit."""
    q, kp, vp, tt, tl = _verify_inputs(dev, dtype, 4, 9, 2, 16, 128, 16, 8,
                                       [1, 33, 64, 100])
    n0 = paged_attention_mq.launches
    got = ops.paged_decode_attention_mq(q, kp, vp, tt, base_len=tl)
    torch.cuda.synchronize()
    assert paged_attention_mq.launches == n0 + 1
    want = ref.paged_attention_mq(q, kp, vp, tt, tl)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    one_tile = paged_attention_mq.paged_attention_mq_cuda(
        q[:, :8].contiguous(), kp, vp, tt, tl)
    torch.testing.assert_close(one_tile, got[:, :8], rtol=0, atol=0)
    # rows per tile: all of them while they fit (128 at D = 128, 43 at
    # D = 256), else the fewest balanced tiles
    tile_rows = build.library().repro_paged_attention_mq_tile_rows
    for rows, d, want in ((80, 128, 80), (128, 128, 128), (144, 128, 72),
                          (150, 128, 75), (272, 128, 91), (43, 256, 43),
                          (44, 256, 22)):
        assert tile_rows(rows, d) == want, (rows, d)


def test_verify_kernel_refuses_what_it_does_not_take(dev):
    table = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    pool = torch.zeros(2, 3, 16, 128, device=dev)
    half = torch.zeros(1, 5, 12, 128, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        paged_attention_mq.paged_attention_mq_cuda(
            half, pool.half(), pool.half(), table, lens)
    q = torch.zeros(1, 12, 5, 128, device=dev).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        paged_attention_mq.paged_attention_mq_cuda(q, pool, pool, table, lens)
    n0 = paged_attention_mq.launches
    q = torch.zeros(1, 5, 12, 128, device=dev)
    with pytest.raises(ValueError, match="int32"):
        paged_attention_mq.paged_attention_mq_cuda(q, pool, pool,
                                                   table.long(), lens)
    assert paged_attention_mq.launches == n0


# K1's training pair: the chip_smoke.py phase-9 cases, shrunk
# (B, S, T, H, KH, D, causal, window, q_offset)
TRAIN_CASES = [
    (1, 512, 512, 12, 2, 128, True, 0, 0),     # the training shape, shorter
    (1, 200, 200, 12, 2, 128, True, 0, 0),     # ragged S = T
    (1, 256, 256, 12, 2, 128, True, 64, 0),    # sliding window
    (1, 72, 200, 12, 2, 128, True, 0, 128),    # S != T with an offset
    (2, 33, 100, 4, 1, 64, False, 0, 0),       # cross, odd sizes
    (1, 40, 40, 2, 1, 256, True, 0, 0),        # widest head
]
TRAIN_IDS = ["train", "ragged", "window", "offset", "cross", "D256"]
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _train_inputs(dev, dtype, B, S, T, H, KH, D, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (_randn(gen, (B, S, H, D), dtype, dev),
            _randn(gen, (B, T, KH, D), dtype, dev),
            _randn(gen, (B, T, KH, D), dtype, dev),
            _randn(gen, (B, S, H, D), dtype, dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
def test_flash_forward_lse_matches_plain(dev, dtype, case):
    B, S, T, H, KH, D, causal, window, q_offset = case
    q, k, v, _ = _train_inputs(dev, dtype, B, S, T, H, KH, D)
    out, lse = flash_attention.flash_attention_cuda(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        with_lse=True)
    torch.cuda.synchronize()
    want_out, want_lse = ref.attention_fwd(q, k, v, causal=causal,
                                           window=window, q_offset=q_offset)
    assert lse.dtype == torch.float32 and lse.shape == (B, S, H)
    torch.testing.assert_close(lse, want_lse, atol=TOL[dtype], rtol=TOL[dtype])
    torch.testing.assert_close(out.float(), want_out.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    # without the LSE the output is the same, bit for bit
    plain_out = flash_attention.flash_attention_cuda(
        q, k, v, causal=causal, window=window, q_offset=q_offset)
    torch.testing.assert_close(plain_out, out, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", TRAIN_CASES, ids=TRAIN_IDS)
def test_flash_bwd_kernel_matches_plain(dev, dtype, case):
    B, S, T, H, KH, D, causal, window, q_offset = case
    q, k, v, do = _train_inputs(dev, dtype, B, S, T, H, KH, D)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = ref.attention_fwd(q, k, v, **mask)
    n0 = flash_attention_bwd.launches
    got = flash_attention_bwd.flash_attention_bwd(q, k, v, out, lse, do, **mask)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == n0 + 1
    want = ref.attention_bwd(q, k, v, out, lse, do, **mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype], msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_is_deterministic(dev, dtype):
    q, k, v, do = _train_inputs(dev, dtype, 2, 384, 384, 12, 2, 128, seed=3)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, with_lse=True)
    first = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    for _ in range(3):
        again = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse,
                                                             do)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_flash_function_launches_both_kernels(dev):
    q, k, v, do = _train_inputs(dev, torch.float32, 1, 128, 128, 4, 2, 64)
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*xs, window=32)
    got = torch.autograd.grad(out, xs, do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (
        n0[0] + 1, n0[1] + 1)
    ys = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.attention(*ys, window=32), ys, do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


def test_flash_bwd_refuses_what_it_does_not_take(dev):
    n0 = flash_attention_bwd.launches
    bwd = flash_attention_bwd.flash_attention_bwd_cuda
    q = torch.zeros(1, 8, 2, 64, device=dev)
    lse = torch.zeros(1, 8, 2, device=dev)
    with pytest.raises(ValueError, match="lse must be float32"):
        bwd(q, q, q, q, lse.half(), q)
    with pytest.raises(ValueError, match="lse must be"):
        bwd(q, q, q, q, lse[:, :4].contiguous(), q)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q, q, q, q.transpose(1, 2).contiguous().transpose(1, 2), lse, q)
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        bwd(q, q, q, q, lse, q.bfloat16())
    with pytest.raises(ValueError, match="dtype"):
        bwd(*(x.half() for x in (q, q, q, q)), lse, q.half())
    q100 = torch.zeros(1, 8, 2, 100, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        bwd(q100, q100, q100, q100, lse, q100)
    with pytest.raises(ValueError, match="out and do"):
        bwd(q, q, q, q[:, :4].contiguous(), lse, q)
    assert flash_attention_bwd.launches == n0
    # the wrapper's shared-memory layout is the CUDA source's
    lib = build.library()
    for d in (8, 64, 128, 256):
        assert (lib.repro_flash_attention_bwd_smem(d)
                == flash_attention_bwd.smem_bytes(d))


# K1 and K1-bwd on the tensor cores (bf16, head dims 64, 96, 128): S and T
# off the tile edges, windows of 64 and 2048, a q_offset continuation,
# non-causal, G = 1, 5 and 6, and the 64-row tiles of a short prefill
# (B, S, T, H, KH, D, causal, window, q_offset)
TC_CASES = [
    (1, 33, 100, 4, 4, 64, False, 0, 0),
    (1, 200, 200, 12, 2, 128, True, 0, 0),
    (1, 1000, 1000, 10, 2, 64, True, 64, 0),
    (1, 1000, 1000, 12, 2, 96, True, 0, 0),
    (1, 2100, 2100, 5, 1, 64, True, 2048, 0),
    (2, 72, 200, 12, 2, 128, True, 0, 128),
    (8, 64, 64, 12, 2, 128, True, 0, 0),
    (2, 48, 48, 6, 6, 96, True, 0, 0),
]
TC_IDS = ["cross-G1", "ragged-G6", "window64-G5", "D96", "window2048",
          "offset", "short-prefill", "short-D96"]


@pytest.mark.parametrize("case", TC_CASES, ids=TC_IDS)
def test_flash_tensor_core_pair_matches_plain(dev, case):
    B, S, T, H, KH, D, causal, window, q_offset = case
    dtype = torch.bfloat16
    assert flash_attention.tensor_core_path(dtype, D)
    q, k, v, do = _train_inputs(dev, dtype, B, S, T, H, KH, D, seed=5)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    n0 = (flash_attention.tc_launches, flash_attention_bwd.tc_launches)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, with_lse=True,
                                                    **mask)
    got = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                       **mask)
    torch.cuda.synchronize()
    assert (flash_attention.tc_launches, flash_attention_bwd.tc_launches) \
        == (n0[0] + 1, n0[1] + 1)
    want_out, want_lse = ref.attention_fwd(q, k, v, **mask)
    torch.testing.assert_close(out.float(), want_out.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=TOL[dtype], rtol=TOL[dtype])
    # without the LSE the output is the same, bit for bit
    torch.testing.assert_close(
        flash_attention.flash_attention_cuda(q, k, v, **mask), out, rtol=0,
        atol=0)
    want = ref.attention_bwd(q, k, v, out, lse, do, **mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype], msg=name)


def test_flash_tensor_core_bwd_is_deterministic(dev):
    q, k, v, do = _train_inputs(dev, torch.bfloat16, 2, 700, 700, 12, 2, 128,
                                seed=4)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, with_lse=True)
    first = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    for _ in range(3):
        again = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse,
                                                             do)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,D,tc", [(torch.bfloat16, 128, True),
                                        (torch.bfloat16, 64, True),
                                        (torch.bfloat16, 40, False),
                                        (torch.float32, 128, False)])
def test_flash_path_counters(dev, dtype, D, tc):
    q, k, v, do = _train_inputs(dev, dtype, 1, 80, 80, 4, 2, D)
    mods = (flash_attention, flash_attention_bwd)
    before = [(m.launches, m.tc_launches, m.fma_launches) for m in mods]
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    torch.autograd.grad(ops.flash_attention(*xs), xs, do)
    for m, (n, n_tc, n_fma) in zip(mods, before):
        assert (m.launches, m.tc_launches, m.fma_launches) == (
            n + 1, n_tc + tc, n_fma + (not tc))


def test_flash_path_rule_is_the_library_s(dev):
    lib = build.library()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for D in range(8, 264, 8):
            assert bool(lib.repro_flash_attention_tensor_cores(D, code)) == \
                flash_attention.tensor_core_path(dtype, D), (dtype, D)


# K6 and K6-bwd: (B, H, S, D, DV) — the training head width at a short S,
# a ragged S, the chip_smoke.py D = 64 case, and odd tile edges
MLSTM_CASES = [
    (1, 2, 256, 384, 384),   # D = DV = 384, the training width
    (2, 2, 200, 64, 64),     # ragged S (6.25 chunks)
    (1, 4, 1000, 64, 64),    # S = 1000, D = 64
    (1, 2, 70, 72, 136),     # partial D and DV tiles
    (2, 1, 33, 8, 16),       # smallest D, one row past a chunk
]
MLSTM_IDS = ["D384", "ragged", "S1000", "tiles", "small"]
MLSTM_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _mlstm_inputs(dev, dtype, B, H, S, D, DV, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q, k = (_randn(gen, (B, H, S, D), dtype, dev) for _ in range(2))
    v, dh = (_randn(gen, (B, H, S, DV), dtype, dev) for _ in range(2))
    i_pre = _randn(gen, (B, H, S), dtype, dev)
    f_pre = (torch.randn((B, H, S), generator=gen) + 1.0).to(dev, dtype)
    return q, k, v, i_pre, f_pre, dh


def _close_to_max(got, want, tol, name):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{name}: max err {err} > {tol} * {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLSTM_CASES, ids=MLSTM_IDS)
def test_mlstm_kernel_matches_plain(dev, dtype, case):
    q, k, v, i_pre, f_pre, _ = _mlstm_inputs(dev, dtype, *case)
    n0 = mlstm_scan.launches
    h, m, qn = mlstm_scan.mlstm_scan_cuda(q, k, v, i_pre, f_pre,
                                          with_stats=True)
    torch.cuda.synchronize()
    assert mlstm_scan.launches == n0 + 1
    want_h, want_m, want_qn = ref.mlstm_scan_chunked(q, k, v, i_pre, f_pre,
                                                     with_stats=True)
    assert h.dtype == dtype and m.dtype == qn.dtype == torch.float32
    torch.testing.assert_close(h.float(), want_h.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(m, want_m, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(qn, want_qn, atol=TOL[dtype], rtol=TOL[dtype])
    # without the stats the output is the same, bit for bit
    torch.testing.assert_close(
        mlstm_scan.mlstm_scan_cuda(q, k, v, i_pre, f_pre), h, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLSTM_CASES, ids=MLSTM_IDS)
def test_mlstm_bwd_kernel_matches_plain(dev, dtype, case):
    q, k, v, i_pre, f_pre, dh = _mlstm_inputs(dev, dtype, *case)
    h, m, qn = ref.mlstm_scan_chunked(q, k, v, i_pre, f_pre, with_stats=True)
    n0 = mlstm_scan.bwd_launches
    got = mlstm_scan.mlstm_scan_bwd(q, k, v, i_pre, f_pre, h, m, qn, dh)
    torch.cuda.synchronize()
    assert mlstm_scan.bwd_launches == n0 + 1
    want = ref.mlstm_scan_bwd(q, k, v, i_pre, f_pre, h, m, qn, dh)
    for name, a, b in zip(("dq", "dk", "dv", "di", "df"), got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        _close_to_max(a, b, MLSTM_GRAD_TOL[dtype], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_bwd_is_deterministic(dev, dtype):
    q, k, v, i_pre, f_pre, dh = _mlstm_inputs(dev, dtype, 2, 2, 300, 128, 64,
                                              seed=3)
    h, m, qn = mlstm_scan.mlstm_scan_cuda(q, k, v, i_pre, f_pre,
                                          with_stats=True)
    first = mlstm_scan.mlstm_scan_bwd_cuda(q, k, v, i_pre, f_pre, h, m, qn, dh)
    for _ in range(3):
        again = mlstm_scan.mlstm_scan_bwd_cuda(q, k, v, i_pre, f_pre, h, m, qn,
                                               dh)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_mlstm_function_launches_both_kernels(dev):
    q, k, v, i_pre, f_pre, dh = _mlstm_inputs(dev, torch.float32, 1, 2, 100,
                                              32, 32)
    n0 = (mlstm_scan.launches, mlstm_scan.bwd_launches)
    xs = [x.clone().requires_grad_() for x in (q, k, v, i_pre, f_pre)]
    got = torch.autograd.grad(ops.mlstm_scan(*xs), xs, dh)
    assert (mlstm_scan.launches, mlstm_scan.bwd_launches) == (n0[0] + 1,
                                                              n0[1] + 1)
    ys = [x.clone().requires_grad_() for x in (q, k, v, i_pre, f_pre)]
    want = torch.autograd.grad(ref.mlstm_scan(*ys)[0], ys, dh)
    for name, a, b in zip(("dq", "dk", "dv", "di", "df"), got, want):
        _close_to_max(a, b, 1e-4, name)


def test_mlstm_kernels_refuse_what_they_do_not_take(dev):
    n0 = (mlstm_scan.launches, mlstm_scan.bwd_launches)
    fwd, bwd = mlstm_scan.mlstm_scan_cuda, mlstm_scan.mlstm_scan_bwd_cuda
    q = torch.zeros(1, 2, 40, 64, device=dev)
    g = torch.zeros(1, 2, 40, device=dev)
    with pytest.raises(ValueError, match="head_dim 392"):
        x = torch.zeros(1, 2, 40, 392, device=dev)
        fwd(x, x, q, g, g)
    with pytest.raises(ValueError, match="value dim 400"):
        fwd(q, q, torch.zeros(1, 2, 40, 400, device=dev), g, g)
    with pytest.raises(ValueError, match="dtype"):
        fwd(q.half(), q.half(), q.half(), g, g)
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        fwd(q, q.bfloat16(), q, g, g)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, g, g)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(q, q, q, g.transpose(1, 2).contiguous().transpose(1, 2), g)
    with pytest.raises(ValueError, match="must be"):
        fwd(q, q, q, g[:, :, :20].contiguous(), g)
    with pytest.raises(ValueError, match="m and qn must be float32"):
        bwd(q, q, q, g, g, q, g.half(), g, q)
    assert (mlstm_scan.launches, mlstm_scan.bwd_launches) == n0
    # the wrapper's shared-memory layouts are the CUDA sources'
    lib = build.library()
    for D, DV in ((8, 8), (64, 384), (384, 64), (384, 384)):
        assert mlstm_scan.smem_bytes(D) == lib.repro_mlstm_scan_smem(D)
        assert (mlstm_scan.bwd_smem_bytes(D, DV)
                == lib.repro_mlstm_scan_bwd_smem(D, DV))
        assert mlstm_scan.bwd_smem_bytes(D, DV) <= mlstm_scan.SMEM_LIMIT


# K1 and K1-bwd at hymba-1.5b's attention shapes: head dim 64, 5 query
# heads a KV head, global and a 2048 window inside a 4096 sequence
HYMBA_ATTN_CASES = [(1, 4096, 4096, 25, 5, 64, True, w, 0) for w in (0, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", HYMBA_ATTN_CASES, ids=["global", "window"])
def test_flash_pair_matches_plain_at_hymba_shapes(dev, dtype, case):
    B, S, T, H, KH, D, causal, window, q_offset = case
    q, k, v, do = _train_inputs(dev, dtype, B, S, T, H, KH, D)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = flash_attention.flash_attention_cuda(q, k, v, with_lse=True,
                                                    **mask)
    want_out, want_lse = ref.attention_fwd(q, k, v, **mask)
    torch.testing.assert_close(out.float(), want_out.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, atol=TOL[dtype], rtol=TOL[dtype])
    got = flash_attention_bwd.flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                       **mask)
    want = ref.attention_bwd(q, k, v, out, lse, do, **mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=GRAD_TOL[dtype],
                                   rtol=GRAD_TOL[dtype], msg=name)


# K5 and K5-bwd: (B, S, Din, N) — hymba's channels at a short S, a ragged S
# and Din, three batch rows, one step past a chunk, and fewer channels than
# a block
SSM_CASES = [
    (1, 512, 3200, 16),
    (2, 1000, 200, 16),
    (3, 300, 72, 16),
    (1, 33, 40, 16),
    (1, 7, 5, 16),
]
SSM_IDS = ["hymba", "ragged", "B3", "chunk+1", "tiny"]
SSM_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _ssm_inputs(dev, dtype, B, S, Din, N, seed=0):
    """x, dt in ``dtype`` (dt a softplus-sized step), A, B, C, D float32, dy
    in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    x = _randn(gen, (B, S, Din), dtype, dev)
    dt = (torch.rand((B, S, Din), generator=gen) * 0.2 + 0.01).to(dev, dtype)
    A = (-torch.rand((Din, N), generator=gen) * 2 - 0.05).to(dev)
    Bm = _randn(gen, (B, S, N), torch.float32, dev)
    Cm = _randn(gen, (B, S, N), torch.float32, dev)
    D = _randn(gen, (Din,), torch.float32, dev)
    dy = _randn(gen, (B, S, Din), dtype, dev)
    return x, dt, A, Bm, Cm, D, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSM_CASES, ids=SSM_IDS)
def test_ssm_kernel_matches_plain(dev, dtype, case):
    *xs, _ = _ssm_inputs(dev, dtype, *case)
    n0 = ssm_scan.launches
    y, ckpt = ssm_scan.ssm_scan_cuda(*xs, with_ckpt=True)
    torch.cuda.synchronize()
    assert ssm_scan.launches == n0 + 1
    want_y, want_ckpt = ref.ssm_scan_fwd_ckpt(*xs)
    assert y.dtype == dtype and ckpt.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    torch.testing.assert_close(ckpt, want_ckpt, atol=2e-5, rtol=2e-5)
    # without the checkpoints the output is the same, bit for bit
    torch.testing.assert_close(ssm_scan.ssm_scan_cuda(*xs), y, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSM_CASES, ids=SSM_IDS)
def test_ssm_bwd_kernel_matches_plain(dev, dtype, case):
    *xs, dy = _ssm_inputs(dev, dtype, *case)
    _, ckpt = ref.ssm_scan_fwd_ckpt(*xs)
    n0 = ssm_scan.bwd_launches
    got = ssm_scan.ssm_scan_bwd(*xs, ckpt, dy)
    torch.cuda.synchronize()
    assert ssm_scan.bwd_launches == n0 + 1
    want = ref.ssm_scan_bwd(*xs, ckpt, dy)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _close_to_max(a, b, SSM_GRAD_TOL[dtype], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_kernels_are_deterministic(dev, dtype):
    *xs, dy = _ssm_inputs(dev, dtype, 2, 700, 400, 16, seed=3)
    y, ckpt = ssm_scan.ssm_scan_cuda(*xs, with_ckpt=True)
    first = ssm_scan.ssm_scan_bwd_cuda(*xs, ckpt, dy)
    for _ in range(3):
        y2, ckpt2 = ssm_scan.ssm_scan_cuda(*xs, with_ckpt=True)
        assert torch.equal(y, y2) and torch.equal(ckpt, ckpt2)
        for a, b in zip(first, ssm_scan.ssm_scan_bwd_cuda(*xs, ckpt, dy)):
            assert torch.equal(a, b)


def test_ssm_function_launches_both_kernels(dev):
    *xs, dy = _ssm_inputs(dev, torch.float32, 2, 100, 48, 16)
    n0 = (ssm_scan.launches, ssm_scan.bwd_launches)
    ts = [x.clone().requires_grad_() for x in xs]
    got = torch.autograd.grad(ops.ssm_scan(*ts), ts, dy)
    assert (ssm_scan.launches, ssm_scan.bwd_launches) == (n0[0] + 1,
                                                          n0[1] + 1)
    us = [x.clone().requires_grad_() for x in xs]
    want = torch.autograd.grad(ref.ssm_scan(*us)[0], us, dy)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        _close_to_max(a, b, 1e-4, name)


def test_ssm_kernels_refuse_what_they_do_not_take(dev):
    n0 = (ssm_scan.launches, ssm_scan.bwd_launches)
    fwd, bwd = ssm_scan.ssm_scan_cuda, ssm_scan.ssm_scan_bwd_cuda
    x, dt, A, Bm, Cm, D, dy = _ssm_inputs(dev, torch.float32, 1, 40, 24, 16)
    with pytest.raises(ValueError, match="state size N=8"):
        fwd(x, dt, A[:, :8].contiguous(), Bm[..., :8].contiguous(),
            Cm[..., :8].contiguous(), D)
    with pytest.raises(ValueError, match="dtype"):
        fwd(x.half(), dt.half(), A, Bm, Cm, D)
    with pytest.raises(ValueError, match="dt is torch.bfloat16"):
        fwd(x, dt.bfloat16(), A, Bm, Cm, D)
    with pytest.raises(ValueError, match="B must be"):
        fwd(x, dt, A, Bm[:, :20], Cm, D)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fwd(x, dt, A, Bm, Cm, D.cpu())
    _, ckpt = fwd(x, dt, A, Bm, Cm, D, with_ckpt=True)
    with pytest.raises(ValueError, match="ckpt must be"):
        bwd(x, dt, A, Bm, Cm, D, ckpt[:1].contiguous(), dy)
    with pytest.raises(ValueError, match="ckpt must be float32"):
        bwd(x, dt, A, Bm, Cm, D, ckpt.double(), dy)
    assert (ssm_scan.launches, ssm_scan.bwd_launches) == (n0[0] + 1, n0[1])
    # the wrapper's constants are the CUDA sources'
    lib = build.library()
    assert lib.repro_ssm_scan_chunk() == ssm_scan.CHUNK
    assert lib.repro_ssm_scan_channels_per_block() == ssm_scan.CHANNELS


# K4: (name, M, K, N, sizes); None sizes: equal groups of M / 4
GMM_CASES = [
    ("equal", 1024, 512, 640, None),
    ("ragged-empty", 1000, 256, 384, [300, 0, 211, 489, 0]),
    ("rows-past-sum", 700, 128, 136, [0, 250, 0, 313]),
    ("unaligned", 333, 100, 90, [100, 0, 200, 33]),  # not 8-aligned widths
    ("one-row-groups", 9, 64, 64, [1, 1, 0, 1, 5, 0]),
]


def _gmm_inputs(dev, dtype, M, K, N, sizes, transpose_w, seed=0):
    gen = torch.Generator().manual_seed(seed)
    sizes = sizes or [M // 4] * 4
    E = len(sizes)
    x = _randn(gen, (M, K), dtype, dev)
    w = _randn(gen, (E, N, K) if transpose_w else (E, K, N), dtype, dev)
    return x, torch.tensor(sizes, dtype=torch.int32, device=dev), w


def _gmm_close(got, want, dtype, name=""):
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    else:
        _close_to_max(got, want, 1e-4, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose_w", [False, True])
@pytest.mark.parametrize("case", GMM_CASES, ids=lambda c: c[0])
def test_moe_gmm_kernel_matches_plain(dev, dtype, transpose_w, case):
    _, M, K, N, sizes = case
    x, s, w = _gmm_inputs(dev, dtype, M, K, N, sizes, transpose_w)
    n0 = moe_gmm.launches
    got = ops.moe_gmm(x, s, w) if not transpose_w else \
        moe_gmm.moe_gmm(x, s, w, transpose_w=True)
    torch.cuda.synchronize()
    assert moe_gmm.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (M, N)
    want = ref.moe_gmm(x, s, w, transpose_w=transpose_w)
    n = min(int(s.sum()), M)
    _gmm_close(got[:n], want[:n], dtype)
    # rows past sum(sizes) are zero (the Pallas kernel's convention)
    assert torch.count_nonzero(got[n:]) == 0
    # reruns give the same bits
    for _ in range(2):
        again = moe_gmm.moe_gmm_cuda(x, s, w, transpose_w=transpose_w)
        assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes", [None, [100, 300, 0, 112]])
def test_moe_gmm_function_matches_autograd_of_plain(dev, dtype, sizes):
    """K4 forward, K4 on the transposed weights for dX and the plain dW
    (one bmm on equal groups, a loop on ragged ones) against autograd of
    the plain version; bit-identical on a rerun."""
    x, s, w = _gmm_inputs(dev, dtype, 512, 256, 320, sizes, False, seed=1)
    gen = torch.Generator().manual_seed(2)
    dy = _randn(gen, (512, 320), dtype, dev)
    host = s.tolist()
    n0 = moe_gmm.launches
    runs = []
    for _ in range(2):
        tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = ops.moe_gmm(tx, host, tw)
        runs.append((y.detach(),) + torch.autograd.grad(y, (tx, tw), dy))
    assert moe_gmm.launches == n0 + 4  # a forward and a dX each
    ux, uw = x.clone().requires_grad_(), w.clone().requires_grad_()
    uy = ref.moe_gmm(ux, host, uw)
    want = (uy.detach(),) + torch.autograd.grad(uy, (ux, uw), dy)
    for name, a, b in zip(("y", "dx", "dw"), runs[0], want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        _gmm_close(a, b, dtype, name)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_moe_gmm_kernel_refuses_what_it_does_not_take(dev):
    x, s, w = _gmm_inputs(dev, torch.float32, 64, 32, 48, [32, 32], False)
    n0 = moe_gmm.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        moe_gmm.moe_gmm_cuda(x.cpu(), s, w)
    with pytest.raises(ValueError, match="dtype"):
        moe_gmm.moe_gmm_cuda(x.half(), s, w.half())
    with pytest.raises(ValueError, match="w is torch.bfloat16"):
        moe_gmm.moe_gmm_cuda(x, s, w.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        moe_gmm.moe_gmm_cuda(x.t(), s, w)
    with pytest.raises(ValueError, match="does not contract"):
        moe_gmm.moe_gmm_cuda(x, s, w, transpose_w=True)
    with pytest.raises(ValueError, match="group_sizes must be"):
        moe_gmm.moe_gmm_cuda(x, s[:1], w)
    with pytest.raises(ValueError, match="group_sizes is on"):
        moe_gmm.moe_gmm_cuda(x, s.cpu(), w)
    assert moe_gmm.launches == n0
    lib = build.library()
    assert lib.repro_moe_gmm_tensor_cores(4096, 6400, 1) == 1
    assert lib.repro_moe_gmm_tensor_cores(4096, 6400, 0) == 0
    assert lib.repro_moe_gmm_tensor_cores(100, 90, 1) == 0
