"""K6 and K6-bwd on the tensor cores: their walk and rounding points, on
the CPU.

The bf16 path of K6 and K6-bwd (``csrc/mlstm_tc.cuh``) runs only on the
card.  It computes the forward and the three backward walks as one walk
with four operand assignments (the table in that header), and rounds to
bf16 at a few points where the plain pair (``ref.mlstm_scan_chunked``,
``ref.mlstm_scan_bwd``) keeps float32.  This file restates that walk in
plain PyTorch (here, not in the package), from the same table, and holds
it to the bounds the card's checks hold the kernels to: 2e-2 abs+rel for
h and qn and 2e-5 for m (``TOL``), 2e-2 of each gradient's max |g|
(``MLSTM_GRAD_TOL``).  So a wrong entry in the table fails here, and the
bounds are known to hold before the kernels run on the card.  The
emulated points, as the kernels do them:

  * bf16 q, k, v, dh enter float32 products exactly (wgmma multiplies
    bf16 and sums in float32); the 1/sqrt(D) scale is applied in float32
    after the product, never to a bf16 operand;
  * chunks of 64 rows; the state is carried in float32;
  * the three float32 operands of a product — P (the scores times the
    pair weights), the state's copy (the operand of the next chunk's
    product) and Z = zc * T — go to the tensor cores as a pair of bf16
    values, hi = bf16(x) and lo = bf16(x - hi), each product taken twice
    and summed in float32: about 16 bits of x;
  * P's row sums (K6's qn), n, q . n, the gates and the gate gradients
    stay in float32.

One rounding to bf16 at each of those three points would not hold the
bounds: where den is small, h and its gradients are large, and an error
of a bf16 ulp of a row's largest terms lands on its small entries
(``test_one_bf16_rounding_would_not_hold_the_bounds``).  Last, the path
rule over every width the rule names."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import mlstm_scan, ref

TOL = 2e-2        # chip_smoke.py TOL[bf16]: h and qn, abs+rel
M_TOL = 2e-5      # m: float32 on both paths
GRAD_TOL = 2e-2   # chip_smoke.py MLSTM_GRAD_TOL[bf16], of each max |g|
L = mlstm_scan.TC_CHUNK

# (B, H, S, D, DV, f_shift)
CASES = [
    (1, 2, 300, 128, 128, 1.0),
    (1, 1, 1000, 384, 384, 1.0),  # the training width
    (2, 1, 65, 64, 128, 1.0),
    (1, 2, 1000, 128, 128, 6.0),  # |qn| wins the denominator
    (1, 2, 1000, 128, 128, -6.0),  # e^-m wins it in most rows
    (1, 1, 1000, 384, 384, 6.0),
]
IDS = ["D128", "D384", "S65-D64-DV128", "f+6", "f-6", "D384-f+6"]


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    """x rounded once to bf16."""
    return x.to(torch.bfloat16).float()


def _pair(x):
    """What the kernels' hi/lo pair of bf16 values carries of x."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _inputs(B, H, S, D, DV, f_shift, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) + shift)
                                .astype(np.float32)).to(torch.bfloat16)
    q, k = t(B, H, S, D), t(B, H, S, D)
    v, dh = t(B, H, S, DV), t(B, H, S, DV)
    return q, k, v, t(B, H, S), t(B, H, S, shift=f_shift), dh


def _pad(x, Sp):
    return torch.nn.functional.pad(x, [0, 0] * (x.dim() - 3)
                                   + [0, Sp - x.shape[2]])


def _walk(mode, X, Y, T, U, log_i, log_f, m_saved, rden, dqn, scale, rnd):
    """One walk of ``csrc/mlstm_tc.cuh`` over every tile at once: X, Y, T, U
    (B, H, Sp, .) float32 holding bf16 values; the row arrays per chunk as
    the gate warp makes them; ``rnd`` what a float32 operand keeps on its
    way to the tensor cores.  Returns out, and K6's (m, qn) or DQ's and
    DK's per-row U . out."""
    rev = mode in ("DV", "DK")
    trans = rev
    B, H, Sp, _ = X.shape
    W_t, W_y = T.shape[-1], Y.shape[-1]
    St = torch.zeros(B, H, W_t, W_y)          # the state, float32
    n = torch.zeros(B, H, W_y if mode == "FWD" else W_t)
    m_prev = torch.full((B, H), ref.NEG_INF)
    out = torch.zeros(B, H, Sp, W_t)
    extra = [torch.zeros(B, H, Sp), torch.zeros(B, H, Sp)]
    starts = list(range(0, Sp, L))
    for c0 in (reversed(starts) if rev else starts):
        r = slice(c0, c0 + L)
        if mode != "FWD":
            m_prev = (m_saved[..., c0 - 1] if c0
                      else torch.full((B, H), ref.NEG_INF))
        m, iw, w, wk, decay = ref._mlstm_chunk_weights(log_i[..., r],
                                                       log_f[..., r], m_prev)
        if mode == "FWD":
            m_prev = m[..., -1]
        Xc, Yc, Tc = X[:, :, r], Y[:, :, r], T[:, :, r]
        rd, dn = (rden[..., r], dqn[..., r]) if mode != "FWD" else (0, 0)
        s = Xc @ Yc.transpose(-1, -2)
        if trans:   # scores [key row, query column]: weights transposed
            w = w.transpose(-1, -2)
        col = (lambda x: x[..., None, :]) if trans else (lambda x: x[..., None])
        if mode == "FWD":
            P = s * scale * w
        elif mode == "DV":
            P = s * scale * w * col(rd)
        elif mode == "DQ":
            P = (s * col(rd) + col(dn)) * w
        else:
            P = scale * (s * col(rd) + col(dn)) * w
        oc = {"FWD": scale * iw, "DV": wk, "DQ": iw * rd, "DK": wk}[mode]
        zc = {"FWD": wk, "DV": scale * iw * rd, "DQ": wk,
              "DK": scale * iw * rd}[mode]
        o = oc[..., None] * (Xc @ rnd(St).transpose(-1, -2))
        if mode == "DQ":
            o = o + (iw * dn)[..., None] * n[..., None, :]
        if mode == "DK":
            o = o + wk[..., None] * n[..., None, :]
        o = o + rnd(P) @ Tc
        if mode == "FWD":
            qn = scale * iw * (Xc @ n[..., None])[..., 0] + P.sum(-1)
            extra[0][:, :, r], extra[1][:, :, r] = m, qn
            o = o / torch.maximum(qn.abs(), torch.exp(-m))[..., None]
            n = decay[..., None] * n + (wk[..., None] * Yc).sum(-2)
        elif mode in ("DQ", "DK"):
            dot = (U[:, :, r] * o).sum(-1)
            extra[0][:, :, r] = dot * scale if mode == "DQ" else dot
            nc = wk if mode == "DQ" else scale * iw * dn
            n = decay[..., None] * n + (nc[..., None] * Tc).sum(-2)
        out[:, :, r] = o
        St = (decay[..., None, None] * St
              + rnd(zc[..., None] * Tc).transpose(-1, -2) @ Yc)
    return out, extra


def _emulate_fwd(q, k, v, i_pre, f_pre, rnd=_pair):
    B, H, S, D = q.shape
    Sp = -(-S // L) * L
    log_i, log_f = ref._mlstm_gates(i_pre.float(), f_pre.float(), L)
    X, Y, T = (_pad(x.float(), Sp) for x in (q, k, v))
    out, (m, qn) = _walk("FWD", X, Y, T, None, log_i, log_f, None, None,
                         None, D ** -0.5, rnd)
    return out[:, :, :S].to(v.dtype), m[..., :S], qn[..., :S]


def _emulate_bwd(q, k, v, i_pre, f_pre, h, m, qn, dh, rnd=_pair):
    B, H, S, D = q.shape
    Sp = -(-S // L) * L
    scale = D ** -0.5
    log_i, log_f = ref._mlstm_gates(i_pre.float(), f_pre.float(), L)
    den = torch.maximum(qn.abs(), torch.exp(-m))
    delta = (dh.float() * h.float()).sum(-1)
    sgn = torch.where(qn.abs() > torch.exp(-m), torch.sign(qn), 0.0)
    rden, dqn = (_pad(x[..., None], Sp)[..., 0]
                 for x in (1.0 / den, -delta / den * sgn))
    qp, kp, vp, dhp = (_pad(x.float(), Sp) for x in (q, k, v, dh))
    args = (log_i, log_f, m, rden, dqn, scale, rnd)
    dv, _ = _walk("DV", kp, qp, dhp, None, *args)
    dq, (qdq, _) = _walk("DQ", dhp, vp, kp, qp, *args)
    dk, (kdk, _) = _walk("DK", vp, dhp, qp, kp, *args)
    d_b = (qdq - kdk)[..., :S]
    d_logf = torch.flip(torch.cumsum(torch.flip(d_b, [-1]), -1), [-1])
    d_f = d_logf * torch.sigmoid(-f_pre.float())
    return ((dq[:, :, :S] * scale).to(q.dtype), dk[:, :, :S].to(k.dtype),
            dv[:, :, :S].to(v.dtype), kdk[..., :S].to(i_pre.dtype),
            d_f.to(f_pre.dtype))


def _close_to_max(got, want, tol, name):
    scale = float(want.float().abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{name}: max err {err} > {tol} * {scale}"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_forward_holds_the_card_bounds(case):
    q, k, v, i_pre, f_pre, _ = _inputs(*case)
    h, m, qn = _emulate_fwd(q, k, v, i_pre, f_pre)
    want = ref.mlstm_scan_chunked(q, k, v, i_pre, f_pre, chunk=L,
                                  with_stats=True)
    torch.testing.assert_close(h.float(), want[0].float(), atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(m, want[1], atol=M_TOL, rtol=M_TOL)
    torch.testing.assert_close(qn, want[2], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_backward_holds_the_card_bounds(case):
    q, k, v, i_pre, f_pre, dh = _inputs(*case)
    h, m, qn = ref.mlstm_scan_chunked(q, k, v, i_pre, f_pre, chunk=L,
                                      with_stats=True)
    got = _emulate_bwd(q, k, v, i_pre, f_pre, h, m, qn, dh)
    want = ref.mlstm_scan_bwd(q, k, v, i_pre, f_pre, h, m, qn, dh, chunk=L)
    for name, a, b in zip(("dq", "dk", "dv", "di", "df"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        _close_to_max(a, b, GRAD_TOL, name)


def test_emulated_walk_without_rounding_is_the_plain_version():
    """With no rounding (inputs in float32, ``rnd`` the identity) the walk
    is the plain pair to float32 precision: the table's operands and
    coefficients are the plain algebra's."""
    q, k, v, i_pre, f_pre, dh = (x.float() for x in
                                 _inputs(1, 2, 150, 64, 128, 1.0, seed=1))
    exact = lambda x: x  # noqa: E731
    h, m, qn = _emulate_fwd(q, k, v, i_pre, f_pre, exact)
    want = ref.mlstm_scan_chunked(q, k, v, i_pre, f_pre, chunk=L,
                                  with_stats=True)
    for a, b in zip((h, m, qn), want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    got = _emulate_bwd(q, k, v, i_pre, f_pre, *want, dh, exact)
    want = ref.mlstm_scan_bwd(q, k, v, i_pre, f_pre, *want, dh, chunk=L)
    for name, a, b in zip(("dq", "dk", "dv", "di", "df"), got, want):
        _close_to_max(a, b, 1e-4, name)


def test_one_bf16_rounding_would_not_hold_the_bounds():
    """Why the kernels carry P, the state's copy and Z as hi/lo pairs: at
    the training width with long memory (f_pre + 6: |qn| wins, den small
    in rows where qn nears 0), one bf16 rounding at each point puts h
    off by more than the bound; the pair holds it (the case above)."""
    q, k, v, i_pre, f_pre, _ = _inputs(1, 1, 1000, 384, 384, 6.0)
    want = ref.mlstm_scan_chunked(q, k, v, i_pre, f_pre, chunk=L)
    errs = []
    for rnd in (_bf16, _pair):
        h = _emulate_fwd(q, k, v, i_pre, f_pre, rnd)[0].float()
        errs.append(float(((h - want.float()).abs()
                           / (1 + want.float().abs())).max()))
    assert errs[0] > TOL > errs[1], errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_path_rule(dtype):
    """bf16 with D and DV multiples of 64 in [64, 384] takes the tensor
    cores and chunks of 64; everything else the FMAs and chunks of 32."""
    for D in range(8, 392, 8):
        for DV in range(8, 392, 8):
            tc = (dtype == torch.bfloat16 and D % 64 == 0 and DV % 64 == 0)
            assert mlstm_scan.tensor_core_path(dtype, D, DV) == tc
            assert mlstm_scan.kernel_chunk(dtype, D, DV) == (
                mlstm_scan.TC_CHUNK if tc else mlstm_scan.CHUNK)
