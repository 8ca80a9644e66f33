"""The port's MoE training path against the reference, on the CPU.

The same numpy inputs from a seed go through both packages.  The
reference runs its default ``ref`` kernel backend (its expert FFN is the
einsum over the capacity buffer), or its Pallas K4 in interpret mode
where a test says so; the port runs on CPU tensors, where K4 and its
backward take their plain versions through the same calls as on the
card.  The models are ``reduced(phi3.5-moe)`` (LayerNorm) and
``reduced(qwen3-moe)`` (RMSNorm): 2 layers, d_model 64, 4 experts, top-2,
d_ff 128, in float32, with the reference's weights bridged through numpy
and the router moved off its init (std 0.5) so that routing depends on
the tokens.  At seq 40 and batch 2 the capacity is 25 slots an expert a
row.  Tolerances, each with its reason:

  * ``param_count`` and the parameter tree: exact;
  * K4's plain version against the reference's oracle ``ref.moe_gmm``:
    1e-5 (float32, the same products summed in other orders), rows past
    ``sum(sizes)`` included (both give them the last expert's product);
  * K4's plain version against the Pallas K4 in interpret mode: 5x the
    reference's kernel tolerance, on the rows ``< sum(sizes)`` only (the
    Pallas kernel, like the port's K4, writes zeros past them);
  * ``MoeGmm``'s backward against ``jax.vjp`` of the einsum: 2e-4;
  * ``apply_moe``: output 1e-5 and aux loss 1e-6 (float32), with
    capacity factor 0.05 (most entries dropped) and with a zero router
    (every probability ties, so the order of ties decides the routing);
  * the loss: rtol 1e-5; every gradient leaf within 1e-4 of that leaf's
    max |g|; the 5-step loss curve of the train step: rtol 1e-4;
  * remat full against none in the port: 1e-6;
  * resume from the port's own checkpoint and from the reference's, and
    the reference's from the port's: bit-identical.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import DataConfig as JDataConfig
from repro.data import make_stream as jmake_stream
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.parallel.sharding import Plan as JPlan
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import jit_train_step, make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_train_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import moe_gmm, ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, lm, moe
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                               make_train_step)
from repro_torch.tree import flatten

BATCH, SEQ, STEPS = 2, 40, 5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # the reference's kernel tolerance


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in xs]


# ---------------------------------------------------------------------------
# configs
def test_param_count_and_tree_match_reference():
    for alias, arch, total in (("phi35-moe", ARCHS[0], 41_872_793_600),
                               ("qwen3-moe", ARCHS[1], 231_742_361_600)):
        cfg, jcfg = get_config(alias), jget_config(arch)
        assert cfg == get_config(arch) and cfg.family == "moe"
        assert cfg.param_count() == jcfg.param_count() == total
        small = reduced(cfg)
        assert small.param_count() == jreduced(jcfg).param_count()
        jparams, _ = jbuild_model(jreduced(jcfg)).init(jax.random.PRNGKey(0))
        want = {k: v.shape for k, v in flatten(
            jax.tree.map(np.asarray, jparams))}
        got = {k: tuple(v.shape)
               for k, v in flatten(build_model(small, "cpu").init(seed=0))}
        assert got == want
    shapes = lm.param_shapes(get_config("phi35-moe"))
    assert shapes["blocks/router"][0] == (32, 4096, 16)
    assert shapes["blocks/moe_wg"][0] == (32, 16, 4096, 6400)
    assert shapes["blocks/moe_wd"][0] == (32, 16, 6400, 4096)
    assert "blocks/mlp_wu" not in shapes


# ---------------------------------------------------------------------------
# K4's plain version
GMM_CASES = [
    # (M, D, F, sizes): the reference's kernel-test shapes, ragged groups
    (32, 8, 16, None),
    (64, 16, 24, None),
    (48, 8, 8, None),
    (16, 8, 8, [0, 16, 0, 0]),          # empty groups
    (40, 8, 12, [10, 0, 20, 0, 0]),     # rows past sum(sizes), empty last
    (40, 8, 12, [0, 12, 0, 5]),         # rows past sum(sizes)
]


def _gmm_inputs(seed, M, D, F, sizes, E=4):
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = rng.multinomial(M, np.ones(E) / E)
    sizes = np.asarray(sizes, np.int32)
    x = rng.normal(size=(M, D)).astype(np.float32)
    w = rng.normal(size=(len(sizes), D, F)).astype(np.float32)
    return x, sizes, w


@pytest.mark.parametrize("M,D,F,sizes", GMM_CASES)
def test_plain_moe_gmm_matches_reference_oracle(M, D, F, sizes):
    x, sizes, w = _gmm_inputs(0, M, D, F, sizes)
    want = jref.moe_gmm(jnp.asarray(x), jnp.asarray(sizes), jnp.asarray(w))
    n0 = moe_gmm.launches
    got = ops.moe_gmm(*_t(x), torch.from_numpy(sizes), *_t(w))
    assert moe_gmm.launches == n0  # the plain version on a CPU tensor
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the transposed read of w gives the same product
    wt = torch.from_numpy(w).transpose(1, 2).contiguous()
    again = ref.moe_gmm(*_t(x), sizes.tolist(), wt, transpose_w=True)
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6)


@pytest.fixture
def interpret_backend():
    jops.set_backend("interpret")
    yield
    jops.set_backend("ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,D,F,sizes,bm", [
    (32, 8, 16, None, 8),
    (48, 8, 8, None, 16),               # ragged M
    (40, 8, 12, [10, 0, 20, 0], 8),     # rows past sum(sizes)
])
def test_plain_moe_gmm_matches_reference_pallas_kernel(
        interpret_backend, M, D, F, sizes, bm, dtype):
    """Rows ``< sum(sizes)`` agree.  On the rows past it the Pallas kernel
    writes zeros (as the port's K4 does), while the plain version follows
    the oracle and gives them the last expert's product."""
    x, sizes, w = _gmm_inputs(1, M, D, F, sizes)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want = np.asarray(jops.moe_gmm(jx, jnp.asarray(sizes), jw, block_m=bm),
                      np.float32)
    tdt = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(np.array(v, np.float32)).to(tdt)
              for v in (jx, jw))  # the same rounded values
    got = ops.moe_gmm(tx, torch.from_numpy(sizes), tw, block_m=bm)
    assert got.dtype == tdt and got.shape == (M, F)
    n = int(sizes.sum())
    np.testing.assert_allclose(got.float().numpy()[:n], want[:n],
                               atol=5 * TOL[dtype], rtol=5 * TOL[dtype])
    if n < M:
        np.testing.assert_array_equal(want[n:], 0.0)
        last = (tx[n:].float() @ tw[-1].float()).to(tdt).float().numpy()
        np.testing.assert_array_equal(got.float().numpy()[n:], last)


@pytest.mark.parametrize("sizes", [[6, 6, 6, 6], [5, 0, 11, 8]])
def test_moe_gmm_backward_matches_jax_vjp(sizes):
    """Equal groups (the capacity buffer's layout: dW by one batched
    product) and ragged ones (dW by a loop over the groups), against
    ``jax.vjp`` of the einsum over the groups."""
    rng = np.random.default_rng(2)
    E, D, F = len(sizes), 12, 20
    M = sum(sizes)
    x = rng.normal(size=(M, D)).astype(np.float32)
    w = rng.normal(size=(E, D, F)).astype(np.float32)
    dy = rng.normal(size=(M, F)).astype(np.float32)
    eid = np.repeat(np.arange(E), sizes)
    onehot = jnp.asarray(np.eye(E, dtype=np.float32)[eid])

    def einsum(xx, ww):
        return jnp.einsum("me,md,edf->mf", onehot, xx, ww)

    want, vjp = jax.vjp(einsum, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = (t.requires_grad_() for t in _t(x, w))
    got = ops.moe_gmm(tx, sizes, tw)
    tdx, tdw = torch.autograd.grad(got, (tx, tw), torch.from_numpy(dy))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-4)
    np.testing.assert_allclose(_np(tdx), np.asarray(jdx), atol=2e-4)
    np.testing.assert_allclose(_np(tdw), np.asarray(jdw), atol=2e-4)


# ---------------------------------------------------------------------------
# the MoE layer
def _moe_params(seed, cfg, router_std=0.5):
    rng = np.random.default_rng(seed)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {"router": router_std * rng.normal(size=(D, E)),
            "moe_wg": 0.1 * rng.normal(size=(E, D, F)),
            "moe_wu": 0.1 * rng.normal(size=(E, D, F)),
            "moe_wd": 0.1 * rng.normal(size=(E, F, D))}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", ["routed", "drops", "ties"])
def test_apply_moe_matches_reference(arch, case):
    over = dict(dtype="float32")
    if case == "drops":
        over["moe_capacity_factor"] = 0.05  # capacity 2 of 40 tokens a row
    cfg = reduced(get_config(arch), **over)
    jcfg = jreduced(jget_config(arch), **over)
    p = _moe_params(3, cfg, router_std=0.0 if case == "ties" else 0.5)
    x = np.random.default_rng(4).normal(size=(BATCH, SEQ, cfg.d_model))
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    want, jaux = jmoe.apply_moe(jp, jnp.asarray(x, jnp.float32), jcfg)
    tp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    got, aux = moe.apply_moe(tp, _t(x)[0], cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)
    probs = torch.softmax(_t(x)[0] @ tp["router"], dim=-1)
    ids = moe.top_k(probs, cfg.top_k)
    plan = moe.dispatch_plan(ids, cfg.num_experts,
                             moe.moe_capacity(cfg, SEQ))
    dropped = int((plan["tok_slot"] == plan["slot_tok"].numel()).sum())
    kept = int((plan["slot_tok"] < BATCH * SEQ).sum())
    assert dropped + kept == BATCH * SEQ * cfg.top_k
    if case == "routed":
        assert len(torch.unique(ids)) == cfg.num_experts
        assert dropped <= BATCH * SEQ * cfg.top_k // 20
    elif case == "drops":  # capacity 2: at most 2 of each row's 80 entries
        assert moe.moe_capacity(cfg, SEQ) == 2    # an expert are kept
        assert kept <= BATCH * cfg.num_experts * 2
    else:  # every probability ties: experts 0 and 1, the lower index first
        assert torch.equal(ids, torch.tensor([0, 1]).expand_as(ids))
        assert dropped == BATCH * (2 * SEQ - 2 * moe.moe_capacity(cfg, SEQ))


def test_dispatch_plan_is_the_reference_sort():
    """Each kept (token, k) entry sits in the slot the reference's stable
    sort gives it, and each slot points back at its entry."""
    rng = np.random.default_rng(5)
    B, S, K, E, C = 2, 30, 2, 4, 9
    ids = torch.from_numpy(np.stack([np.stack([rng.permutation(E)[:K]
                                               for _ in range(S)])
                                     for _ in range(B)]))
    plan = moe.dispatch_plan(ids, E, C)
    for b in range(B):
        flat = ids[b].reshape(-1).numpy()
        order = np.argsort(flat, kind="stable")
        seen = {}
        for j, m in enumerate(order):
            e = flat[m]
            pos = seen.setdefault(e, 0)
            seen[e] += 1
            slot = plan["tok_slot"][b * S + m // K, m % K]
            if pos < C:
                assert slot == e * B * C + b * C + pos
                assert plan["slot_entry"][slot] == b * S * K + m
                assert plan["slot_tok"][slot] == b * S + m // K
            else:
                assert slot == E * B * C
    filled = plan["slot_entry"] < B * S * K
    assert int(filled.sum()) == int((plan["tok_slot"] < E * B * C).sum())


# ---------------------------------------------------------------------------
# the model, the train step and resume
class Ref:
    """The reference's reduced MoE config (float32) train state and step,
    the router moved off its init."""

    def __init__(self, arch):
        self.cfg = jreduced(jget_config(arch), dtype="float32")
        self.model = jbuild_model(self.cfg)
        self.opt = JOptimizerConfig(**OPT)
        state = jax.jit(lambda key: jinit_train_state(
            self.model, key, self.opt))(jax.random.PRNGKey(0))
        blocks = state["params"]["blocks"]
        blocks["router"] = jnp.asarray(0.5 * np.random.default_rng(6).normal(
            size=blocks["router"].shape), jnp.float32)
        self.state = state
        self.step = jit_train_step(jmake_train_step(
            self.model, self.opt, JPlan(remat="none")), donate=False)
        self.stream = jmake_stream(self.cfg, JShapeConfig(
            "t", SEQ, BATCH, "train"), JDataConfig(seed=0, vocab_size=256))
        self.arch = arch

    def np_state(self, state=None):
        return jax.tree.map(np.asarray, self.state if state is None else state)

    def tokens(self, step):
        return {"tokens": jnp.asarray(self.stream.batch_at(step)["tokens"])}


@pytest.fixture(scope="module", params=ARCHS, ids=["phi35", "qwen3"])
def ref_(request):
    return Ref(request.param)


@pytest.fixture(scope="module")
def phi():
    return Ref(ARCHS[0])


def _port(r, state=None, plan=None):
    cfg = reduced(get_config(r.arch), dtype="float32")
    model = build_model(cfg, device="cpu")
    tstate = from_jax_train_state(r.np_state(state), cfg, "cpu")
    step = make_train_step(model, OptimizerConfig(**OPT),
                           plan or Plan(remat="none"))
    return model, tstate, step


def _batch(r, step):
    return {k: torch.from_numpy(v) for k, v in r.stream.batch_at(step).items()}


def _assert_states_equal(a, b):
    for (ka, x), (kb, y) in zip(flatten(a), flatten(b)):
        assert ka == kb and x.dtype == y.dtype and torch.equal(x, y), ka


def test_loss_and_gradients_match_reference(ref_):
    tokens = ref_.tokens(0)
    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(
        lambda p: ref_.model.loss(p, tokens, remat="none"), has_aux=True))(
        ref_.state["params"])
    model, tstate, _ = _port(ref_)
    params = tstate["params"]
    leaves = [p.requires_grad_() for _, p in flatten(params)]
    n0 = moe_gmm.launches
    tl, tmetrics = model.loss(params, _batch(ref_, 0), remat="none")
    tg = torch.autograd.grad(tl, leaves)
    assert moe_gmm.launches == n0  # the plain version on CPU tensors
    assert float(tmetrics["aux"].detach()) > 0
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for name in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(_np(tmetrics[name]), _np(jmetrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for (key, want), got in zip(flatten(jax.tree.map(np.asarray, jg)), tg):
        scale = float(np.abs(want).max())
        assert scale > 0, key  # every leaf, the router's included
        np.testing.assert_allclose(_np(got), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=key)


def test_loss_curve_matches_reference(ref_):
    _, tstate, tstep = _port(ref_)
    jstate = ref_.state
    for i in range(STEPS):
        jstate, jm = ref_.step(jstate, ref_.tokens(i))
        tstate, tm = tstep(tstate, _batch(ref_, i))
        for name in ("loss", "aux", "lr", "grad_norm"):
            np.testing.assert_allclose(_np(tm[name]), _np(jm[name]),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS


def test_remat_full_does_not_change_the_step(phi):
    results = []
    for plan in (Plan(remat="none"), Plan(remat="full")):
        _, state, step = _port(phi, plan=plan)
        for i in range(2):
            state, metrics = step(state, _batch(phi, i))
        results.append((state, metrics))
    (a, ma), (b, mb) = results
    for name in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(_np(mb[name]), _np(ma[name]), atol=1e-6)
    for (key, x), (_, y) in zip(flatten(a), flatten(b)):
        np.testing.assert_allclose(_np(y), _np(x), atol=1e-6, err_msg=key)


def test_resume_from_port_checkpoint_is_exact(phi, tmp_path):
    """4 steps unbroken against 2, a save and restore through the port's
    Checkpointer into a state of another seed, and 2 more: bit for bit."""
    model, _, step = _port(phi)
    opt = OptimizerConfig(**OPT)

    def run(state, steps):
        for i in steps:
            state, _ = step(state, _batch(phi, i))
        return state

    a = run(init_train_state(model, 0, opt), range(4))
    b = run(init_train_state(model, 0, opt), range(2))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, b)
    b, saved = ck.restore(init_train_state(model, 1, opt))
    assert saved == 1
    _assert_states_equal(a, run(b, range(2, 4)))


def test_resume_from_reference_checkpoint_is_exact(phi, tmp_path):
    """The reference's Checkpointer writes its MoE train state after two
    steps; the port restores it bit for bit (the state the bridge gives),
    and its next step equals the reference's."""
    jstate = phi.state
    for i in range(2):
        jstate, _ = phi.step(jstate, phi.tokens(i))
    JCheckpointer(str(tmp_path)).save(1, jstate, blocking=True)
    _, like, tstep = _port(phi)
    restored, saved = Checkpointer(str(tmp_path)).restore(like)
    assert saved == 1 and int(restored["step"]) == 2
    _, bridged, _ = _port(phi, state=jstate)
    _assert_states_equal(restored, bridged)
    jnext, jm = phi.step(jstate, phi.tokens(2))
    tnext, tm = tstep(restored, _batch(phi, 2))
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-4)
    _assert_states_equal(tnext, tstep(bridged, _batch(phi, 2))[0])
    for (key, a), (_, b) in zip(flatten(tnext["params"]), flatten(
            jax.tree.map(np.asarray, jnext["params"]))):
        np.testing.assert_allclose(_np(a), b, atol=1e-5, err_msg=key)


def test_reference_restores_port_checkpoint(phi, tmp_path):
    """The other way: the port's MoE checkpoint after two steps restores
    into the reference's train state bit for bit."""
    _, tstate, tstep = _port(phi)
    for i in range(2):
        tstate, _ = tstep(tstate, _batch(phi, i))
    Checkpointer(str(tmp_path)).save(1, tstate, blocking=True)
    restored, saved = JCheckpointer(str(tmp_path)).restore(phi.state)
    assert saved == 1
    for (key, a), (_, b) in zip(flatten(jax.tree.map(np.asarray, restored)),
                                flatten(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                      err_msg=key)


def test_serving_paths_raise(phi):
    """The MoE decoders serve (prefill, the dense and paged caches, the
    engine); the one refusal the reference keeps is padded prefill
    (``lens``): capacity depends on the padded length."""
    model, state, _ = _port(phi)
    params = state["params"]
    tokens = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="lens"):
        model.prefill(params, tokens, lens=torch.tensor([3]))
    assert not model.supports_padded_prefill()
    assert model.supports_paged_cache() and model.supports_speculative()
    logits, cache = model.prefill(model.serving_params(params), tokens,
                                  max_seq=8)
    assert logits.shape == (1, model.cfg.vocab_size)
    assert cache["k"].shape[:3] == (model.cfg.num_layers, 1, 8)
    ServeEngine(model, params, engine="paged", spec_k=2)


def test_train_cli_runs_reduced_moe(tmp_path, capsys):
    argv = ["train", "--arch", "phi35-moe", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "24", "--runs-dir", str(tmp_path)]
    with mock.patch("sys.argv", argv):
        train_cli.main()
    out = capsys.readouterr().out
    assert "step 2 loss=" in out and "steps=3" in out
    assert np.isfinite(float(out.split("step 2 loss=")[1].split()[0]))
    assert float(out.split("(aux ")[1].split(")")[0]) > 0
