"""Kernel parity, PyTorch port vs the JAX reference, on the CPU.

The port's plain attention and paged attention (what its kernel
wrappers return on a CPU tensor, and what its CUDA kernels are held
against on the card) are checked against both the reference's jnp
oracle and its Pallas kernel in interpret mode, on the cases of the
reference's own kernel tests, in float32 and bfloat16.  Inputs come from
numpy with a fixed seed and are handed to both packages.

Tolerances are the reference's kernel tests' own: 2e-5 in float32 (the
two frameworks sum in other orders) and 2e-2 in bfloat16 (outputs are
rounded to bfloat16, whose spacing near 1 is 2**-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from test_torch_model import one_torch_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# the reference's oracles, compiled once per shape (eager dispatch would
# compile every primitive of them separately)
jref_attention = jax.jit(jref.attention,
                         static_argnames=("causal", "window", "q_offset"))
jref_paged = jax.jit(jref.paged_attention)


def _interpret(fn, *args, **static):
    """Run a reference ``ops`` entry point with its Pallas kernel in
    interpret mode, as one compiled program, then restore the default
    ``ref`` backend."""
    jops.set_backend("interpret")
    try:
        return jax.jit(lambda *a: fn(*a, **static))(*args)
    finally:
        jops.set_backend("ref")


def _pair(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(got: torch.Tensor, want, dtype: str):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ===========================================================================
# K1: attention
# ===========================================================================
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,T,H,KH,D,causal,window",
    [
        (1, 64, 64, 4, 4, 32, True, 0),     # MHA causal
        (2, 64, 64, 4, 2, 32, True, 0),     # GQA
        (2, 96, 96, 4, 1, 16, True, 0),     # MQA, ragged seq
        (1, 64, 64, 2, 2, 48, False, 0),    # bidirectional, odd head_dim
        (2, 128, 128, 4, 2, 32, True, 32),  # sliding window
        (1, 32, 128, 2, 2, 32, False, 0),   # cross-attention T != S
    ],
)
def test_attention_matches_reference(rng, B, S, T, H, KH, D, causal, window,
                                     dtype):
    qn = rng.normal(size=(B, S, H, D)).astype(np.float32)
    kn = rng.normal(size=(B, T, KH, D)).astype(np.float32)
    vn = rng.normal(size=(B, T, KH, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (qn, kn, vn))
    got = tflash.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jref_attention(jq, jk, jv, causal=causal, window=window), dtype)
    pallas = _interpret(jops.flash_attention, jq, jk, jv, causal=causal,
                        window=window, block_q=64, block_k=64)
    _close(got, pallas, dtype)
    # the public entry point takes the same path on the CPU
    torch.testing.assert_close(
        tops.flash_attention(tq, tk, tv, causal=causal, window=window), got,
        rtol=0, atol=0)


def test_attention_q_offset_and_kv_len(rng):
    """Continuation chunk (q at positions 32..63 against kv 0..63) and the
    decode-time kv_len mask, against the reference oracle."""
    qn = rng.normal(size=(2, 32, 2, 32)).astype(np.float32)
    kn = rng.normal(size=(2, 64, 2, 32)).astype(np.float32)
    vn = rng.normal(size=(2, 64, 2, 32)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "float32") for x in (qn, kn, vn))
    got = tref.attention(tq, tk, tv, causal=True, q_offset=32)
    _close(got, jref_attention(jq, jk, jv, causal=True, q_offset=32), "float32")
    lens = np.asarray([17, 64], np.int32)
    got = tref.attention(tq[:, :1], tk, tv, causal=False,
                         kv_len=torch.from_numpy(lens))
    want = jref_attention(jq[:, :1], jk, jv, causal=False,
                          kv_len=jnp.asarray(lens))
    _close(got, want, "float32")


# ===========================================================================
# K2: paged decode attention
# ===========================================================================
def _paged_inputs(rng, B, KH, G, D, page, max_pages, kv_len):
    """Random pools + a page table mapping ceil(kv_len/page) distinct
    pages per row (never page 0, the null page), -1 elsewhere."""
    num_pages = 1 + B * max_pages
    q = rng.normal(size=(B, 1, KH * G, D)).astype(np.float32)
    kp = rng.normal(size=(KH, num_pages, page, D)).astype(np.float32)
    vp = rng.normal(size=(KH, num_pages, page, D)).astype(np.float32)
    lens = np.asarray(kv_len, np.int32)
    table = np.full((B, max_pages), -1, np.int32)
    free = list(rng.permutation(np.arange(1, num_pages)))
    for b in range(B):
        for lp in range(-(-int(lens[b]) // page)):
            table[b, lp] = free.pop()
    return q, kp, vp, table, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,KH,G,D,page,max_pages",
    [
        (1, 4, 1, 32, 16, 4),   # MHA
        (4, 2, 4, 32, 16, 4),   # GQA
        (2, 1, 8, 16, 8, 8),    # MQA, small pages
        (2, 2, 2, 48, 16, 4),   # odd head_dim
    ],
)
def test_paged_attention_matches_reference(rng, B, KH, G, D, page, max_pages,
                                           dtype):
    kv_len = rng.integers(1, page * max_pages + 1, B)
    q, kp, vp, table, lens = _paged_inputs(rng, B, KH, G, D, page, max_pages,
                                           kv_len)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, kp, vp))
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jl, tl = jnp.asarray(lens), torch.from_numpy(lens)
    got = tops.paged_decode_attention(tq, tk, tv, tt, kv_len=tl)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, jref_paged(jq, jk, jv, jt, jl), dtype)
    pallas = _interpret(lambda *a: jops.paged_decode_attention(
        *a[:4], kv_len=a[4]), jq, jk, jv, jt, jl)
    _close(got, pallas, dtype)


@pytest.mark.parametrize("kv_len", [[1, 16], [15, 17], [32, 64]])
def test_paged_attention_dead_pages_and_page_edges(rng, kv_len):
    """Unmapped (-1) entries and positions past kv_len contribute nothing:
    scribbling over every unmapped page (null page 0 included) leaves the
    output unchanged, and kv_len on an exact page boundary matches the
    reference."""
    B, KH, G, D, page, max_pages = 2, 2, 3, 32, 16, 4
    q, kp, vp, table, lens = _paged_inputs(rng, B, KH, G, D, page, max_pages,
                                           kv_len)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, kp, vp))
    tt, tl = torch.from_numpy(table), torch.from_numpy(lens)
    got = tops.paged_decode_attention(tq, tk, tv, tt, kv_len=tl)
    want = jref_paged(*(jnp.asarray(x) for x in (q, kp, vp, table, lens)))
    _close(got, want, "float32")
    mapped = set(table[table >= 0].tolist())
    dead = torch.tensor([p for p in range(kp.shape[1]) if p not in mapped])
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, dead] = 1e4
    tv2[:, dead] = -1e4
    # partially filled last pages: scribble past kv_len inside them too
    for b in range(B):
        last = int(table[b, (int(lens[b]) - 1) // page])
        tk2[:, last, int(lens[b]) % page or page:] = 1e4
    torch.testing.assert_close(
        tops.paged_decode_attention(tq, tk2, tv2, tt, kv_len=tl), got,
        rtol=0, atol=0)
