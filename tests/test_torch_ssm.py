"""The port's selective scan (the sequential oracle, the chunked scan, K5's
and K5-bwd's plain versions and the autograd Function) against the
reference, on the CPU.

The same numpy inputs from a seed go through both packages.  The
reference's TPU kernel runs in interpret mode, as its own
``tests/test_kernels.py`` runs it; its gradients are ``jax.vjp`` of its
sequential oracle ``ref.ssm_scan`` (what its default training
differentiates) and of its checkpointed-adjoint ``ssm_scan_ckpt``.
Tolerances, each with its reason:

  * the oracle's y and final state, with and without an initial state,
    the chunked scan and K5's plain forward (y and the chunk-start
    checkpoints): 1e-5 (float32, the same recurrence);
  * K5's plain forward against the reference's Pallas K5 in interpret
    mode: 5x the reference's tolerance (float32 2e-5, bfloat16 2e-2), as
    its test holds that kernel against its oracle (the Pallas kernel
    rounds y to bfloat16 before adding ``D x``, the oracle and the port
    after);
  * K5-bwd's plain version and the autograd Function against ``jax.vjp``
    of the oracle and of ``ssm_scan_ckpt``: 2e-4 abs on all six
    gradients, the reference's own bound for its checkpointed VJP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssm_vjp
from repro_torch.kernels import ops, ref, ssm_scan

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_ATOL = 2e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _inputs(seed, B, S, Din, N):
    """x, dt (> 0, a softplus-sized step), A (< 0), B, C, D: float32, as
    the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, Din)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, S, Din))) * 0.1 + 0.01).astype(
        np.float32)
    A = (-np.abs(rng.normal(size=(Din, N))) - 0.1).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    D = rng.normal(size=(Din,)).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _t(*xs):
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("with_initial", [False, True])
def test_oracle_matches_reference(with_initial):
    B, S, Din, N = 2, 37, 12, 8
    xs = _inputs(0, B, S, Din, N)
    initial = (np.random.default_rng(1).normal(size=(B, Din, N)).astype(
        np.float32) if with_initial else None)
    jy, jh = jref.ssm_scan(*_j(*xs), initial=None if initial is None
                           else jnp.asarray(initial))
    ty, th = ref.ssm_scan(*_t(*xs), initial=None if initial is None
                          else torch.from_numpy(initial))
    assert ty.dtype == torch.float32 and th.shape == (B, Din, N)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("S,chunk", [(37, 8), (32, 16), (5, 16)])
def test_chunked_scan_matches_reference(S, chunk):
    xs = _inputs(2, 2, S, 24, 8)
    jy, jh = jref.ssm_scan_chunked(*_j(*xs), chunk=chunk)
    ty, th = ref.ssm_scan_chunked(*_t(*xs), chunk=chunk)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)


@pytest.mark.parametrize("S,chunk", [(37, 8), (64, 32), (100, 32)])
def test_checkpointed_forward_matches_reference(S, chunk):
    """K5's plain forward: y as the oracle's, and the state at each chunk
    start as the reference's ``ssm_vjp._fwd_full`` saves it."""
    xs = _inputs(3, 2, S, 16, 16)
    jy, jckpt = ssm_vjp._fwd_full(*_j(*xs), chunk)
    ty, tckpt = ref.ssm_scan_fwd_ckpt(*_t(*xs), chunk=chunk)
    assert tckpt.shape == (-(-S // chunk), 2, 16, 16)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tckpt.numpy(), np.asarray(jckpt), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(tckpt[0].numpy(), 0.0)


@pytest.fixture
def interpret_backend():
    jops.set_backend("interpret")
    yield
    jops.set_backend("ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Din,N,bd,chunk", [
    (1, 16, 16, 8, 8, 8),
    (2, 32, 24, 8, 8, 16),
    (1, 40, 32, 16, 16, 8),   # ragged seq
    (2, 45, 20, 16, 8, 16),   # ragged seq and channels
])
def test_plain_forward_matches_reference_pallas_kernel(
        interpret_backend, B, S, Din, N, bd, chunk, dtype):
    x, dt, A, Bm, Cm, D = _inputs(4, B, S, Din, N)
    jdt = jnp.dtype(dtype)
    jx, jdt_, jB, jC = (jnp.asarray(v, jdt) for v in (x, dt, Bm, Cm))
    want = jops.ssm_scan(jx, jdt_, jnp.asarray(A), jB, jC, jnp.asarray(D),
                         block_d=bd, chunk=chunk)
    tdt = getattr(torch, dtype)
    tx, tdt_, tB, tC = (torch.from_numpy(np.array(v, np.float32)).to(tdt)
                        for v in (jx, jdt_, jB, jC))  # the same rounded values
    got = ops.ssm_scan(tx, tdt_, *_t(A), tB, tC, *_t(D), block_d=bd,
                       chunk=chunk)
    assert got.dtype == tdt and got.shape == (B, S, Din)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5 * TOL[dtype], rtol=5 * TOL[dtype])


BWD_CASES = [
    # (B, S, Din, N, chunk)
    (2, 37, 12, 8, 8),      # the reference's own case, ragged
    (1, 64, 16, 16, 32),    # the kernels' chunk, whole chunks
    (2, 100, 24, 16, 32),   # the kernels' chunk, ragged
    (1, 5, 8, 16, 32),      # shorter than a chunk
]


def _reference_vjps(xs, dy):
    """``jax.vjp`` of the oracle and of the checkpointed-adjoint scan (at
    its own test's chunk of 8, which it unrolls), each jitted."""
    def vjp(f):
        return jax.jit(lambda a, g: jax.vjp(f, *a)[1](g))(
            tuple(_j(*xs)), jnp.asarray(dy))

    oracle = vjp(lambda *a: jref.ssm_scan(*a)[0])
    ckpt = vjp(lambda *a: ssm_vjp.ssm_scan_ckpt(*a, 8))
    return ([np.asarray(g) for g in oracle], [np.asarray(g) for g in ckpt])


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_bwd_matches_reference_vjps(case):
    B, S, Din, N, chunk = case
    xs = _inputs(5, B, S, Din, N)
    dy = np.random.default_rng(6).normal(size=(B, S, Din)).astype(np.float32)
    t = _t(*xs)
    _, ckpts = ref.ssm_scan_fwd_ckpt(*t, chunk=chunk)
    got = ref.ssm_scan_bwd(*t, ckpts, torch.from_numpy(dy), chunk=chunk)
    for want in _reference_vjps(xs, dy):
        for name, a, b in zip(NAMES, got, want):
            assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL, rtol=0,
                                       err_msg=name)


def test_plain_bwd_keeps_each_input_dtype():
    """dx and ddt in x's and dt's dtype (bfloat16 on the model's path), the
    others in their inputs' (float32), as ``_bwd_vjp`` returns them."""
    x, dt, A, Bm, Cm, D = _t(*_inputs(7, 1, 40, 16, 16))
    x, dt = x.bfloat16(), dt.bfloat16()
    y, ckpts = ref.ssm_scan_fwd_ckpt(x, dt, A, Bm, Cm, D)
    assert y.dtype == torch.bfloat16
    got = ref.ssm_scan_bwd(x, dt, A, Bm, Cm, D, ckpts, torch.ones_like(y))
    assert [g.dtype for g in got] == [torch.bfloat16] * 2 + [torch.float32] * 4


def test_autograd_function_matches_reference_vjp():
    """The Function the model trains through: on CPU tensors it runs the
    plain pair and launches nothing."""
    B, S, Din, N = 2, 70, 16, 16
    xs = _inputs(8, B, S, Din, N)
    dy = np.random.default_rng(9).normal(size=(B, S, Din)).astype(np.float32)
    want, _ = _reference_vjps(xs, dy)
    n0 = (ssm_scan.launches, ssm_scan.bwd_launches)
    t = [v.requires_grad_() for v in _t(*xs)]
    y = ops.ssm_scan(*t)
    jy, _ = jref.ssm_scan(*_j(*xs))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    got = torch.autograd.grad(y, t, torch.from_numpy(dy))
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)
    assert (ssm_scan.launches, ssm_scan.bwd_launches) == n0
    # without autograd the same y, through the plain forward alone
    with torch.no_grad():
        np.testing.assert_array_equal(ops.ssm_scan(*t).numpy(),
                                      y.detach().numpy())
