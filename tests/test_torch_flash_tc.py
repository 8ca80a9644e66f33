"""K1 and K1-bwd on the tensor cores: their rounding points, on the CPU.

The bf16 path of K1 and K1-bwd (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``) runs only on the card.  Its arithmetic
differs from the plain pair (``ref.attention_fwd``/``ref.attention_bwd``,
float32 throughout) at a few rounding points, which this file emulates in
plain PyTorch (here, not in the package) and holds to the bounds the card
checks hold the kernels to: 2e-2 abs+rel for the output and the LSE
(``TOL``), 2e-2 abs+rel for dq, dk, dv (``GRAD_TOL``).  The emulated
points, as the kernels do them:

  * bf16 q, k, v, dO enter float32 products exactly (wgmma multiplies
    bf16 and sums in float32); the scale is applied to S in float32 after
    the product;
  * the forward's online softmax walks kv tiles of 128 rows with
    log2(e)-scaled scores, rounds P to bf16 before P V, and keeps the
    running max and sum in float32;
  * the backward recomputes P^T = exp(scale S^T - lse) in float32 and
    rounds P^T and dS^T to bf16 before dV += P^T dO and dK += dS^T Q, and
    dS to bf16 before dQ += dS K.

The shapes are qwen2-like (D 128, G 6), hymba-like (D 64, G 5, a
window), ragged (D 96), a q_offset continuation and non-causal, at S <=
512, so that the bounds are known to hold before the kernels run on the
card.  Last, the path rule itself over every (dtype, head dim) the
configs use or the rule names."""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attention, ref

TOL = 2e-2       # chip_smoke.py TOL[bf16]: output and LSE, abs+rel
GRAD_TOL = 2e-2  # chip_smoke.py GRAD_TOL[bf16]: dq, dk, dv, abs+rel
BN = 128         # K1's kv tile on the tensor cores
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# (B, S, T, H, KH, D, causal, window, q_offset)
CASES = [
    (1, 512, 512, 12, 2, 128, True, 0, 0),
    (1, 512, 512, 10, 2, 64, True, 100, 0),
    (2, 333, 333, 4, 2, 96, True, 0, 0),
    (1, 72, 200, 12, 2, 128, True, 0, 128),
    (2, 33, 100, 4, 4, 64, False, 0, 0),
]
IDS = ["qwen2-like", "hymba-like-window", "ragged-D96", "offset", "cross"]


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, T, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    shapes = ((B, S, H, D), (B, T, KH, D), (B, T, KH, D), (B, S, H, D))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(torch.bfloat16) for s in shapes]


def _live(S, T, causal, window, q_offset):
    qpos = q_offset + torch.arange(S)[:, None]
    kpos = torch.arange(T)[None, :]
    live = torch.ones((S, T), dtype=torch.bool)
    if causal:
        live &= qpos >= kpos
    if window > 0:
        live &= qpos - kpos < window
    return live


def _per_head(x, G):
    """k or v ``(B, T, KH, D)`` as float32 ``(B, T, H, D)``: KV head
    ``h // G`` for query head h."""
    return x.float().repeat_interleave(G, dim=2)


def emulate_fwd(q, k, v, *, causal, window, q_offset):
    """K1 on the tensor cores: ``(out bf16 (B, S, H, D), lse float32
    (B, S, H))`` with the kernel's rounding points."""
    B, S, H, D = q.shape
    T, G = k.shape[1], H // k.shape[2]
    kf, vf = _per_head(k, G), _per_head(v, G)
    x = torch.einsum("bshd,bthd->bhst", q.float(), kf) * (D ** -0.5 * LOG2E)
    x = torch.where(_live(S, T, causal, window, q_offset), x, ref.NEG_INF)
    m = torch.full((B, H, S), ref.NEG_INF)
    l = torch.zeros((B, H, S))
    o = torch.zeros((B, H, S, D))
    for k0 in range(0, T, BN):
        xt = x[..., k0:k0 + BN]
        m_new = torch.maximum(m, xt.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(xt - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhst,bthd->bhsd", p.to(torch.bfloat16).float(),
                          vf[:, k0:k0 + BN])
        o = o * alpha[..., None] + pv
        m = m_new
    out = o / l.clamp_min(1e-30)[..., None]
    lse = m * LN2 + torch.log(l.clamp_min(1e-30))
    return (out.permute(0, 2, 1, 3).to(torch.bfloat16),
            lse.permute(0, 2, 1).contiguous())


def emulate_bwd(q, k, v, out, lse, do, *, causal, window, q_offset):
    """K1-bwd on the tensor cores: ``(dq, dk, dv)`` in bf16 with the
    kernels' rounding points."""
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = D ** -0.5
    qf, dof = q.float(), do.float()
    kf, vf = _per_head(k, G), _per_head(v, G)
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)       # (B, H, S)
    s = torch.einsum("bshd,bthd->bhst", qf, kf)
    p = torch.exp2(s * (scale * LOG2E)
                   - (lse.permute(0, 2, 1) * LOG2E)[..., None])
    p = torch.where(_live(S, T, causal, window, q_offset), p, 0.0)
    dp = torch.einsum("bshd,bthd->bhst", dof, vf)
    ds = p * (dp - delta[..., None])
    pb, dsb = (x.to(torch.bfloat16).float() for x in (p, ds))
    dv = torch.einsum("bhst,bshd->bthd", pb, dof)
    dk = torch.einsum("bhst,bshd->bthd", dsb, qf) * scale
    dq = torch.einsum("bhst,bthd->bshd", dsb, kf) * scale
    dk, dv = (x.reshape(B, T, KH, G, D).sum(3) for x in (dk, dv))
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _close(got, want, tol, name):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol,
                               msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_forward_within_the_card_bounds(case):
    B, S, T, H, KH, D, causal, window, q_offset = case
    q, k, v, _ = _inputs(B, S, T, H, KH, D)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = emulate_fwd(q, k, v, **mask)
    want_out, want_lse = ref.attention_fwd(q, k, v, **mask)
    _close(out, want_out, TOL, "out")
    _close(lse, want_lse, TOL, "lse")
    # the emulation rounds where the plain version does not
    assert not torch.equal(out, want_out)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emulated_backward_within_the_card_bounds(case):
    B, S, T, H, KH, D, causal, window, q_offset = case
    q, k, v, do = _inputs(B, S, T, H, KH, D, seed=1)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = emulate_fwd(q, k, v, **mask)
    got = emulate_bwd(q, k, v, out, lse, do, **mask)
    want = ref.attention_bwd(q, k, v, out, lse, do, **mask)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _close(a, b, GRAD_TOL, name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("head_dim", [40, 64, 80, 96, 128, 136, 256])
def test_path_rule(dtype, head_dim):
    """bf16 at a head dim that is a multiple of 16 in [64, 128] takes the
    tensor cores; float32 (TF32 would break its bounds), other widths and
    other dtypes take the FMA kernels."""
    want = dtype == torch.bfloat16 and head_dim in (64, 80, 96, 128)
    assert flash_attention.tensor_core_path(dtype, head_dim) is want


@pytest.mark.parametrize("arch", sorted(a for a, c in ARCHS.items()
                                        if c.family != "ssm"))
def test_every_attention_config_takes_the_tensor_cores(arch):
    cfg = ARCHS[arch]
    assert flash_attention.tensor_core_path(getattr(torch, cfg.dtype),
                                            cfg.head_dim)
