"""The port's mLSTM (K6's and K6-bwd's plain versions, the sequential
oracle, the recurrent step and the autograd Function) against the
reference, on the CPU.

The same numpy inputs from a seed go through both packages.  The
reference's chunked TPU kernel runs in interpret mode, as its own
``tests/test_kernels.py`` runs it; its gradient is ``jax.vjp`` of its
sequential oracle ``ref.mlstm_scan`` (the only mLSTM gradient it has).
Tolerances, each with its reason:

  * the sequential oracle, h and the final ``(C, n, m)``, with and
    without an initial state: 1e-5 (float32, the same recurrence);
  * ``mlstm_step`` continuing a scan: 1e-5 (the reference's own test);
  * ``mlstm_scan_chunked`` against the reference's Pallas K6 in
    interpret mode: 5x the reference's tolerance (float32 2e-5, bfloat16
    2e-2), as its test holds that kernel against its oracle;
  * ``mlstm_scan_bwd`` and the autograd Function against ``jax.vjp`` of
    the oracle: 1e-4 of each gradient's max |g| (float32; the chunkwise
    backward holds the stabiliser constant and sums in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mlstm_scan, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 1e-4


def _inputs(seed, B, H, S, D, DV=None, f_shift=1.0):
    rng = np.random.default_rng(seed)
    DV = DV or D
    q, k = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(B, H, S, DV)).astype(np.float32)
    ip = rng.normal(size=(B, H, S)).astype(np.float32)
    fp = (rng.normal(size=(B, H, S)) + f_shift).astype(np.float32)
    return q, k, v, ip, fp


def _t(*xs):
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in xs]


def _close_to_max(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("with_initial", [False, True])
def test_sequential_oracle_matches_reference(with_initial):
    B, H, S, D = 2, 2, 24, 8
    xs = _inputs(0, B, H, S, D)
    initial = None
    if with_initial:
        rng = np.random.default_rng(1)
        initial = (rng.normal(size=(B, H, D, D)).astype(np.float32),
                   rng.normal(size=(B, H, D)).astype(np.float32),
                   rng.normal(size=(B, H)).astype(np.float32))
    jh, jstate = jref.mlstm_scan(*map(jnp.asarray, xs), initial=None if
                                 initial is None else tuple(map(jnp.asarray,
                                                                initial)))
    th, tstate = ref.mlstm_scan(*_t(*xs), initial=None if initial is None
                                else tuple(_t(*initial)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    for name, a, b in zip("Cnm", tstate, jstate):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_mlstm_step_continues_scan():
    """Decode step from the scan's final state == one longer scan (the
    reference's ``test_mlstm_step_continues_scan``), and == the
    reference's step."""
    B, H, S, D = 1, 2, 16, 8
    xs = _inputs(2, B, H, S + 1, D, f_shift=0.0)
    q, k, v, ip, fp = _t(*xs)
    full, _ = ref.mlstm_scan(q, k, v, ip, fp)
    _, state = ref.mlstm_scan(q[:, :, :S], k[:, :, :S], v[:, :, :S],
                              ip[:, :, :S], fp[:, :, :S])
    h, new = ops.mlstm_step(q[:, :, S], k[:, :, S], v[:, :, S], ip[:, :, S],
                            fp[:, :, S], state)
    np.testing.assert_allclose(h.numpy(), full[:, :, S].numpy(), atol=1e-5)
    jq, jk, jv, jip, jfp = map(jnp.asarray, xs)
    _, jstate = jref.mlstm_scan(jq[:, :, :S], jk[:, :, :S], jv[:, :, :S],
                                jip[:, :, :S], jfp[:, :, :S])
    jh, jnew = jops.mlstm_step(jq[:, :, S], jk[:, :, S], jv[:, :, S],
                               jip[:, :, S], jfp[:, :, S], jstate)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    for a, b in zip(new, jnew):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


@pytest.fixture
def interpret_backend():
    jops.set_backend("interpret")
    yield
    jops.set_backend("ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,D,chunk", [
    (1, 2, 32, 16, 8),
    (2, 2, 48, 16, 16),
    (1, 4, 64, 32, 32),
    (2, 1, 40, 8, 16),  # ragged: S % chunk != 0
])
def test_chunked_matches_reference_pallas_kernel(interpret_backend, B, H, S,
                                                 D, chunk, dtype):
    q, k, v, ip, fp = _inputs(3, B, H, S, D)
    jdt = jnp.dtype(dtype)
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    want = jops.mlstm_scan(jq, jk, jv, jnp.asarray(ip), jnp.asarray(fp),
                           chunk=chunk)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.array(x, np.float32)).to(tdt)
                  for x in (jq, jk, jv))  # the same rounded values
    got, m, qn = ref.mlstm_scan_chunked(tq, tk, tv, *_t(ip, fp), chunk=chunk,
                                        with_stats=True)
    assert got.dtype == tdt and m.shape == qn.shape == (B, H, S)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5 * TOL[dtype], rtol=5 * TOL[dtype])
    # the last row's stabiliser is the oracle's final m
    _, (_, _, jm) = jref.mlstm_scan(jq, jk, jv, jnp.asarray(ip),
                                    jnp.asarray(fp))
    np.testing.assert_allclose(m[..., -1].numpy(), np.asarray(jm), atol=1e-5,
                               rtol=1e-5)


BWD_CASES = [
    # (B, H, S, D, DV, chunk)
    (1, 2, 24, 8, 8, 8),
    (2, 2, 48, 16, 16, 16),
    (2, 1, 40, 8, 16, 16),    # ragged, DV != D
    (1, 2, 100, 16, 8, 32),   # the kernels' chunk, ragged
]


def _reference_vjp(xs, dh):
    _, vjp = jax.vjp(lambda *a: jref.mlstm_scan(*a)[0],
                     *map(jnp.asarray, xs))
    return [np.asarray(g) for g in vjp(jnp.asarray(dh))]


@pytest.mark.parametrize("case", BWD_CASES)
def test_bwd_matches_reference_vjp(case):
    B, H, S, D, DV, chunk = case
    xs = _inputs(4, B, H, S, D, DV)
    dh = np.random.default_rng(5).normal(size=(B, H, S, DV)).astype(
        np.float32)
    want = _reference_vjp(xs, dh)
    t = _t(*xs)
    h, m, qn = ref.mlstm_scan_chunked(*t, chunk=chunk, with_stats=True)
    got = ref.mlstm_scan_bwd(*t, h, m, qn, torch.from_numpy(dh), chunk=chunk)
    for name, a, b in zip(("dq", "dk", "dv", "di", "df"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        _close_to_max(a.numpy(), b, GRAD_TOL, name)


def test_autograd_function_matches_reference_vjp():
    """The Function the model trains through: on CPU tensors it runs the
    plain pair and launches nothing."""
    B, H, S, D = 2, 2, 70, 16
    xs = _inputs(6, B, H, S, D)
    dh = np.random.default_rng(7).normal(size=(B, H, S, D)).astype(np.float32)
    want = _reference_vjp(xs, dh)
    n0 = (mlstm_scan.launches, mlstm_scan.bwd_launches)
    t = [x.requires_grad_() for x in _t(*xs)]
    h = ops.mlstm_scan(*t)
    jh, _ = jref.mlstm_scan(*map(jnp.asarray, xs))
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), atol=1e-5,
                               rtol=1e-5)
    got = torch.autograd.grad(h, t, torch.from_numpy(dh))
    for name, a, b in zip(("dq", "dk", "dv", "di", "df"), got, want):
        _close_to_max(a.numpy(), b, GRAD_TOL, name)
    assert (mlstm_scan.launches, mlstm_scan.bwd_launches) == n0
    # without autograd the same h, through the plain forward alone
    with torch.no_grad():
        np.testing.assert_array_equal(ops.mlstm_scan(*t).numpy(),
                                      h.detach().numpy())
