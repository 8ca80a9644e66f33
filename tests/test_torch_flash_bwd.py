"""K1's training pair in the port against the reference, on the CPU.

The port's plain forward-with-LSE and backward (``ref.attention_fwd``,
``ref.attention_bwd``) are held against the reference's custom VJP
(``flash_xla.flash_attention_xla``: its ``_fwd`` lse and the gradients
``jax.vjp`` gives through ``_bwd_vjp``) and against ``jax.vjp`` of the
reference's plain ``ref.attention``, on the same numpy inputs, at the
shapes of the reference's ``test_flash_xla_grads`` (B 2, S 200, H 4,
KH 2, D 16) plus S != T with a query offset.  Tolerances: gradients
float32 atol 2e-4 (the reference's own tolerance between its VJP and
plain autodiff); lse and outputs 1e-5 (both sides float32, other
summation orders).  The autograd Function that joins K1 to K1-bwd is
checked on CPU tensors, where it runs that same plain pair, against
torch's autograd through ``ref.attention`` at 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_xla
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, flash_attention_bwd, ops, ref

CASES = [  # S, T, causal, window, q_offset
    (200, 200, True, 0, 0),
    (200, 200, False, 0, 0),
    (200, 200, True, 64, 0),
    (72, 200, True, 0, 128),   # continuation: S != T with an offset
    (72, 200, True, 48, 128),
    (33, 100, False, 0, 0),    # cross attention, odd sizes
]
IDS = ["causal", "full", "window64", "offset", "offset-window", "cross"]
# the cases held against the reference (each compiles two JAX VJPs)
REF_CASES, REF_IDS = CASES[:4], IDS[:4]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(S, T, seed=0):
    rng = np.random.default_rng(seed)
    B, H, KH, D = 2, 4, 2, 16
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KH, D)).astype(np.float32)
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, do


def _jax_grads(fn, q, k, v, do):
    @jax.jit
    def grads(q, k, v, do):
        return jax.vjp(fn, q, k, v)[1](do)

    return [np.asarray(g) for g in grads(q, k, v, do)]


@pytest.mark.parametrize("S,T,causal,window,q_offset", REF_CASES, ids=REF_IDS)
def test_plain_backward_matches_reference_vjps(S, T, causal, window, q_offset):
    q, k, v, do = _inputs(S, T)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = ref.attention_fwd(*t[:3], causal=causal, window=window,
                                 q_offset=q_offset)
    got = ref.attention_bwd(*t[:3], out, lse, t[3], causal=causal,
                            window=window, q_offset=q_offset)
    xla = _jax_grads(lambda a, b, c: flash_xla.flash_attention_xla(
        a, b, c, causal, window, q_offset, 64, 64), q, k, v, do)
    plain = _jax_grads(lambda a, b, c: jref.attention(
        a, b, c, causal=causal, window=window, q_offset=q_offset),
        q, k, v, do)
    for name, g, a, b in zip("qkv", got, xla, plain):
        np.testing.assert_allclose(g.numpy(), a, atol=2e-4,
                                   err_msg=f"d{name} vs flash_xla VJP")
        np.testing.assert_allclose(
            g.numpy(), b, atol=2e-4,
            err_msg=f"d{name} vs jax.vjp(ref.attention)")


@pytest.mark.parametrize("S,T,causal,window,q_offset", REF_CASES, ids=REF_IDS)
def test_plain_forward_lse_matches_flash_xla(S, T, causal, window, q_offset):
    q, k, v, _ = _inputs(S, T, seed=1)
    out, lse = ref.attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal, window=window,
                                 q_offset=q_offset)
    want_out, want_lse = flash_xla._fwd(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal, window,
                                        q_offset, 64, 64)
    B, S_, H = lse.shape
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(B, S_, H),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=1e-5)
    plain = ref.attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), atol=1e-5)


@pytest.mark.parametrize("S,T,causal,window,q_offset", CASES, ids=IDS)
def test_function_gradients_match_torch_autograd(S, T, causal, window,
                                                 q_offset):
    q, k, v, do = _inputs(S, T, seed=2)
    n0 = (flash_attention.launches, flash_attention_bwd.launches)

    def grads(fn):
        xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*xs, causal=causal, window=window, q_offset=q_offset)
        return [out] + list(torch.autograd.grad(out, xs,
                                                torch.from_numpy(do)))

    got = grads(ops.flash_attention)
    want = grads(ref.attention)
    for name, a, b in zip(["out", "dq", "dk", "dv"], got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5, msg=name)
    # CPU tensors take the plain pair: no kernel launched
    assert (flash_attention.launches, flash_attention_bwd.launches) == n0


def test_function_saves_lse_only_when_autograd_records():
    q, k, v, _ = _inputs(64, 64)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = ops.flash_attention(*t)
    assert out.grad_fn is None  # serving: the forward alone
    with torch.no_grad():
        out = ops.flash_attention(t[0].requires_grad_(), *t[1:])
    assert out.grad_fn is None
    out = ops.flash_attention(*t)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    saved = out.grad_fn.saved_tensors
    assert [tuple(x.shape) for x in saved[3:]] == [(2, 64, 4, 16), (2, 64, 4)]
    assert saved[4].dtype == torch.float32


def test_bwd_smem_layout_fits_every_head_dim():
    """The backward's shared-memory layout (mirrored from the CUDA
    source) fits a Hopper block for every head dim the wrapper takes."""
    for d in range(8, 257, 8):
        assert (flash_attention_bwd.smem_bytes(d)
                <= flash_attention_bwd.SMEM_LIMIT)
    assert flash_attention_bwd.smem_bytes(128) == 4 * (
        2 * 64 * 132 + 2 * 32 * 132 + 2 * 32 * 65 + 64)
