"""K5's and K5-bwd's order of operations, restated in PyTorch, against the
sequential scan, on the CPU.

The CUDA kernels (``csrc/ssm_scan.cu``, ``csrc/ssm_scan_bwd.cu``, their map
in ``csrc/ssm_common.cuh``) run only on the card.  This file restates their
arithmetic step for step: a warp of 32 lanes, each owning RUN = 8
consecutive steps of a 256-step pass; for each state n the lane composes
its (a, b) pairs in order, the warp scans the 32 composites in 5
shuffle-up levels (lane 0 folding in the state carried from the last
pass), and the lane walks its steps again; the checkpoint of each 32-step
chunk is the state the scan hands the chunk's first lane.  The backward
walks the passes in reverse, recomputes the states from the checkpoints
(a scan over the 4 lanes of a chunk), runs the adjoint as a reverse scan
of the maps e_{t+1} -> a_t (dy_t C_t + e_{t+1}) in 5 shuffle-down levels
(lane 31 folding in the carry from the later pass), sums over n in the
thread in n order, over a warp's lanes by a butterfly, over a block's 16
channels in order and over the blocks in order.

Held, at a small ragged size (two passes, the last ragged; a Din that is
not a multiple of the backward's 16-channel block) in three decay
regimes (hymba's mixed one, a near 0 and a near 1) and at N 8 and 16:
  * in float64, against a float64 sequential scan and its autograd
    gradients: 1e-9 of each output's max (the same sums in another
    order);
  * in float32, against the reference's sequential oracle ``ref.ssm_scan``
    and ``jax.vjp`` of it: y 2e-5 abs+rel and the checkpoints against the
    reference's ``ssm_vjp._fwd_full`` 2e-5 (the card's bounds for K5), the
    gradients 1e-4 of each gradient's max (the card's bound for K5-bwd in
    float32); and the float32 restatement's error against the float64
    scan within 4x the float32 sequential scan's own error plus 1e-6 of
    the output's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ref as jref
from repro.kernels import ssm_vjp
from repro_torch.kernels import ref, ssm_scan

RUN, LANES, CHUNK = 8, 32, 32
PASS = RUN * LANES
BLOCK = 16  # channels a block of K5-bwd sums dB and dC over
LOG2E = 1.4426950408889634
NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD")
# dt and -A: (low, width) of uniform draws, as the card tests draw them
DECAY = {"mixed": ((0.01, 0.2), (0.05, 2.0)),
         "strong": ((0.5, 1.0), (10.0, 20.0)),
         "weak": ((0.01, 0.2), (0.001, 0.01))}
CASES = [  # (B, S, Din, N, decay)
    (2, 300, 21, 16, "mixed"),
    (1, 300, 21, 16, "strong"),
    (1, 520, 21, 16, "weak"),
    (2, 300, 21, 8, "mixed"),
]
IDS = ["mixed", "strong-decay", "weak-decay", "N8"]


def _inputs(seed, B, S, Din, N, decay):
    (dt_lo, dt_w), (a_lo, a_w) = DECAY[decay]
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, Din))
    dt = rng.uniform(size=(B, S, Din)) * dt_w + dt_lo
    A = -rng.uniform(size=(Din, N)) * a_w - a_lo
    Bm = rng.normal(size=(B, S, N))
    Cm = rng.normal(size=(B, S, N))
    D = rng.normal(size=(Din,))
    dy = rng.normal(size=(B, S, Din))
    return [np.asarray(v, np.float32) for v in (x, dt, A, Bm, Cm, D, dy)]


def _lanes():
    return torch.arange(LANES)


def _shfl_up(v, d, width=LANES):
    """``__shfl_up_sync(v, d, width)`` over dim 1 (the lanes): lane l reads
    lane l - d of its width-lane segment, or keeps its own value."""
    lanes = _lanes()
    ok = lanes % width >= d
    out = v.clone()
    out[:, ok] = v[:, lanes[ok] - d]
    return out


def _shfl_down(v, d):
    lanes = _lanes()
    ok = lanes + d < LANES
    out = v.clone()
    out[:, ok] = v[:, lanes[ok] + d]
    return out


def _butterfly(v):
    """The sum over dim 1 (the lanes) by ``__shfl_xor_sync`` levels 16 ... 1,
    as every lane ends with it."""
    lanes = _lanes()
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ off]
    return v[:, 0]


def _runs(t, t0):
    """Steps [t0, t0 + PASS) of a padded (B, S, W) tensor as (B, lanes,
    RUN, W)."""
    return t[:, t0:t0 + PASS].reshape(t.shape[0], LANES, RUN, t.shape[-1])


def _padded(dtype, *xs):
    S = xs[0].shape[1]
    pad = -S % PASS
    return [F.pad(x.to(dtype), (0, 0, 0, pad)) for x in xs]


def _compose(a, bb):
    """Each lane's pairs composed in order: (prod a, the state after the run
    from a zero start)."""
    ac = torch.ones_like(a[:, :, 0])
    bc = torch.zeros_like(bb[:, :, 0])
    for i in range(RUN):
        bc = a[:, :, i] * bc + bb[:, :, i]
        ac = ac * a[:, :, i]
    return ac, bc


def _scan_up(ac, bc, width):
    """The inclusive scan of the lanes' composites within width-lane
    segments, level by level as the shuffles run."""
    lanes = _lanes()
    d = 1
    while d < width:
        ap, bp = _shfl_up(ac, d, width), _shfl_up(bc, d, width)
        m = (lanes % width >= d).view(1, LANES, 1, 1)
        bc, ac = torch.where(m, ac * bp + bc, bc), torch.where(m, ac * ap, ac)
        d *= 2
    return ac, bc


def _pairs(dtype, xr, dr, br, A):
    u = dr * xr
    a = torch.exp2(dr[..., None] * (A.to(dtype) * LOG2E))  # (B, L, R, Din, N)
    bb = u[..., None] * br[:, :, :, None, :]
    return u, a, bb


def scan_fwd(x, dt, A, Bm, Cm, D, dtype):
    """K5's order: ``(y, checkpoints)`` in ``dtype``."""
    Bsz, S, Din = x.shape
    N = A.shape[1]
    nck = -(-S // CHUNK)
    xf, dtf, bf, cf = _padded(dtype, x, dt, Bm, Cm)
    carry = torch.zeros((Bsz, Din, N), dtype=dtype)
    ckpt = torch.zeros((nck, Bsz, Din, N), dtype=dtype)
    ys = []
    for t0 in range(0, xf.shape[1], PASS):
        xr, dr, br, cr = (_runs(t, t0) for t in (xf, dtf, bf, cf))
        _, a, bb = _pairs(dtype, xr, dr, br, A)
        ac, bc = _compose(a, bb)
        bc[:, 0] = ac[:, 0] * carry + bc[:, 0]
        ac, bc = _scan_up(ac, bc, LANES)
        h = _shfl_up(bc, 1)
        h[:, 0] = carry
        carry = bc[:, LANES - 1]
        for lane in range(0, LANES, CHUNK // RUN):
            k = (t0 + lane * RUN) // CHUNK
            if k < nck:
                ckpt[k] = h[:, lane]
        y = torch.zeros((Bsz, LANES, RUN, Din), dtype=dtype)
        for i in range(RUN):
            h = a[:, :, i] * h + bb[:, :, i]
            for n in range(N):
                y[:, :, i] += h[..., n] * cr[:, :, i, n, None]
        ys.append((y + D.to(dtype) * xr).reshape(Bsz, PASS, Din))
    return torch.cat(ys, 1)[:, :S], ckpt


def scan_bwd(x, dt, A, Bm, Cm, D, ckpt, dy, dtype):
    """K5-bwd's order: ``(dx, ddt, dA, dB, dC, dD)`` in ``dtype``."""
    Bsz, S, Din = x.shape
    N = A.shape[1]
    nck = -(-S // CHUNK)
    xf, dtf, bf, cf, dyf = _padded(dtype, x, dt, Bm, Cm, dy)
    Af = A.to(dtype)
    lanes = _lanes()
    first = (lanes % (CHUNK // RUN) == 0).view(1, LANES, 1, 1)
    carry = torch.zeros((Bsz, Din, N), dtype=dtype)
    dA_b = torch.zeros((Bsz, Din, N), dtype=dtype)
    dD_lane = torch.zeros((Bsz, LANES, Din), dtype=dtype)
    dxs, ddts, dBs, dCs = [], [], [], []
    for t0 in reversed(range(0, xf.shape[1], PASS)):
        xr, dr, br, cr, dyr = (_runs(t, t0) for t in (xf, dtf, bf, cf, dyf))
        for i in range(RUN):
            dD_lane = dD_lane + dyr[:, :, i] * xr[:, :, i]
        u, a, bb = _pairs(dtype, xr, dr, br, A)
        g = dyr[..., None] * cr[:, :, :, None, :]
        ac, bc = _compose(a, bb)
        ar = ac
        h0 = torch.zeros_like(bc)
        for lane in range(0, LANES, CHUNK // RUN):
            k = (t0 + lane * RUN) // CHUNK
            if k < nck:
                h0[:, lane] = ckpt[k]
        bc = torch.where(first, ac * h0 + bc, bc)
        ac, bc = _scan_up(ac, bc, CHUNK // RUN)
        h_in = torch.where(first, h0, _shfl_up(bc, 1, CHUNK // RUN))
        hs, h = [], h_in
        for i in range(RUN):
            h = a[:, :, i] * h + bb[:, :, i]
            hs.append(h)
        er = torch.zeros_like(bc)
        for i in reversed(range(RUN)):
            er = a[:, :, i] * (g[:, :, i] + er)
        ea = ar
        er[:, LANES - 1] = ea[:, LANES - 1] * carry + er[:, LANES - 1]
        for d in (1, 2, 4, 8, 16):
            ap, bp = _shfl_down(ea, d), _shfl_down(er, d)
            m = (lanes + d < LANES).view(1, LANES, 1, 1)
            er, ea = (torch.where(m, ea * bp + er, er),
                      torch.where(m, ea * ap, ea))
        e = _shfl_down(er, 1)
        e[:, LANES - 1] = carry
        carry = er[:, 0]
        dA_lane = torch.zeros_like(bc)
        q_t, dh_t = [None] * RUN, [None] * RUN
        dB = torch.zeros((Bsz, LANES, RUN, Din, N), dtype=dtype)
        dC = torch.zeros_like(dB)
        for i in reversed(range(RUN)):
            dh = g[:, :, i] + e
            e = a[:, :, i] * dh
            da = dh * (hs[i - 1] if i > 0 else h_in)
            q = da * a[:, :, i]
            dA_lane = dA_lane + q * dr[:, :, i, :, None]
            q_t[i], dh_t[i] = q, dh
            dB[:, :, i] = dh * u[:, :, i, :, None]
            dC[:, :, i] = dyr[:, :, i, :, None] * hs[i]
        dA_b = dA_b + _butterfly(dA_lane)
        # the sums over n, in n order, in the thread
        ddt_acc = torch.zeros((Bsz, LANES, RUN, Din), dtype=dtype)
        ddtx = torch.zeros_like(ddt_acc)
        for n in range(N):
            for i in range(RUN):
                ddt_acc[:, :, i] += q_t[i][..., n] * Af[:, n]
                ddtx[:, :, i] += dh_t[i][..., n] * br[:, :, i, n, None]
        dxs.append((ddtx * dr + dyr * D.to(dtype)).reshape(Bsz, PASS, Din))
        ddts.append((ddt_acc + ddtx * xr).reshape(Bsz, PASS, Din))
        dBs.append(dB.reshape(Bsz, PASS, Din, N))
        dCs.append(dC.reshape(Bsz, PASS, Din, N))

    def whole(parts):
        return torch.cat(parts[::-1], 1)[:, :S]

    def channel_sum(v):
        """The sum over Din: the block's 16 channels in order, then the
        blocks in order."""
        v = F.pad(v, (0, 0, 0, -Din % BLOCK))
        v = v.reshape(v.shape[0], v.shape[1], -1, BLOCK, N)
        part = v[:, :, :, 0]
        for j in range(1, BLOCK):
            part = part + v[:, :, :, j]
        out = part[:, :, 0]
        for blk in range(1, part.shape[2]):
            out = out + part[:, :, blk]
        return out

    dA = dA_b[0]
    for b in range(1, Bsz):
        dA = dA + dA_b[b]
    dD_b = _butterfly(dD_lane)
    dD = dD_b[0]
    for b in range(1, Bsz):
        dD = dD + dD_b[b]
    return (whole(dxs), whole(ddts), dA, channel_sum(whole(dBs)),
            channel_sum(whole(dCs)), dD)


def _sequential64(x, dt, A, Bm, Cm, D):
    """The sequential scan in float64: ``(y, the state after every
    step)``."""
    x, dt, A, Bm, Cm, D = (t.double() for t in (x, dt, A, Bm, Cm, D))
    h = torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float64)
    ys, hs = [], []
    for t in range(x.shape[1]):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
        ys.append((h * Cm[:, t, None, :]).sum(-1))
        hs.append(h)
    return torch.stack(ys, 1) + x * D, torch.stack(hs, 1)


def _err_of_max(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scan_order_forward_matches_sequential_float64(case):
    xs = [torch.from_numpy(v) for v in _inputs(0, *case)[:6]]
    y, ckpt = scan_fwd(*xs, torch.float64)
    want_y, want_h = _sequential64(*xs)
    assert _err_of_max(y, want_y) <= 1e-9
    # the checkpoint of chunk k > 0 is the state after step 32 k - 1
    want_ck = want_h[:, CHUNK - 1::CHUNK].transpose(0, 1)[:ckpt.shape[0] - 1]
    assert _err_of_max(ckpt[1:], want_ck) <= 1e-9
    assert torch.equal(ckpt[0], torch.zeros_like(ckpt[0]))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scan_order_forward_matches_reference_float32(case):
    xs = _inputs(1, *case)[:6]
    ts = [torch.from_numpy(v) for v in xs]
    y, ckpt = scan_fwd(*ts, torch.float32)
    want_y, _ = jref.ssm_scan(*(jnp.asarray(v) for v in xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-5,
                               rtol=2e-5)
    _, want_ck = ssm_vjp._fwd_full(*(jnp.asarray(v) for v in xs), CHUNK)
    np.testing.assert_allclose(ckpt.numpy(), np.asarray(want_ck), atol=2e-5,
                               rtol=2e-5)
    # against the float64 scan: the scan order's float32 error is of the
    # sequential scan's own size
    want64, _ = _sequential64(*ts)
    seq = ref.ssm_scan(*ts)[0]
    assert _err_of_max(y, want64) <= 4 * _err_of_max(seq, want64) + 1e-6


def _grads64(xs, dy):
    ts = [t.double().requires_grad_() for t in xs]
    y, _ = _sequential64(*ts)
    return torch.autograd.grad(y, ts, dy.double())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scan_order_backward_matches_sequential_float64(case):
    *xs, dy = [torch.from_numpy(v) for v in _inputs(2, *case)]
    _, ckpt = scan_fwd(*xs, torch.float64)
    got = scan_bwd(*xs, ckpt, dy, torch.float64)
    want = _grads64(xs, dy)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert _err_of_max(g, w) <= 1e-9, name


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_scan_order_backward_matches_reference_float32(case):
    *xs, dy = _inputs(3, *case)
    ts = [torch.from_numpy(v) for v in xs]
    _, ckpt = scan_fwd(*ts, torch.float32)
    got = scan_bwd(*ts, ckpt, torch.from_numpy(dy), torch.float32)
    _, vjp = jax.vjp(lambda *a: jref.ssm_scan(*a)[0],
                     *(jnp.asarray(v) for v in xs))
    want = vjp(jnp.asarray(dy))
    want64 = _grads64(ts, torch.from_numpy(dy))
    plain = ref.ssm_scan_bwd(*ts, ref.ssm_scan_fwd_ckpt(*ts)[1],
                             torch.from_numpy(dy))
    for name, g, w, w64, p in zip(NAMES, got, want, want64, plain):
        w = torch.from_numpy(np.asarray(w))
        assert _err_of_max(g, w) <= 1e-4, name
        assert _err_of_max(g, w64) <= 4 * _err_of_max(p, w64) + 1e-6, name


def test_kernel_constants_are_the_restatement_s():
    assert ssm_scan.CHUNK == CHUNK == ref.SSM_CHUNK
    assert ssm_scan.CHANNELS == BLOCK
