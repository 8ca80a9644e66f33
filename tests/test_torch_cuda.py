"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: each test skips where there is no GPU (decided
inside the fixture, never at import).  Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 2e-5 (the kernel and the plain version sum in other
orders), bfloat16 2e-2 (outputs rounded to bfloat16)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (flash_attention, ops, paged_attention,
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
