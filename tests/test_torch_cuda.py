"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: each test skips where there is no GPU (decided
inside the fixture, never at import).  Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 2e-5 (the kernel and the plain version sum in other
orders), bfloat16 2e-2 (outputs rounded to bfloat16); K1-bwd's float32
gradients 2e-4 (the reference's own tolerance for its flash VJP, sums
over whole sequences in other orders); K6-bwd's gradients 1e-4 (float32)
and 2e-2 (bfloat16) of each gradient's max |g| (the same algorithm summed
in other orders, and the gates' gradients a cumulative sum over the
whole sequence)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (build, flash_attention, flash_attention_bwd,
                                 mlstm_scan, ops, paged_attention,
                                 paged_attention_mq, ref)

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


def test_verify_kernel_refuses_what_it_does_not_take(dev):
    table = torch.zeros(1, 2, dtype=torch.int32, device=dev)
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    pool = torch.zeros(2, 3, 16, 128, device=dev)
    q = torch.zeros(1, 9, 32, 128, device=dev)  # 9 x 16 = 144 rows
    with pytest.raises(ValueError, match="too many rows"):
        paged_attention_mq.paged_attention_mq_cuda(q, pool, pool, table, lens)
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
