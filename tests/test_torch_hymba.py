"""The port's hymba-1.5b training path against the reference, on the CPU.

``reduced(hymba-1.5b)`` (2 layers: layer 0 global, layer 1 a window of
16; d_model 64, 4/2 heads of 16, d_inner 128, state 16, vocab 256) in
float32, with the reference's weights bridged through numpy and the SSM
parameters moved off their init (A, the dt bias, D, the fuse vectors,
larger B/C/dt projections) so that the scan shapes the output.  The
sequence (40) is longer than the window, so both attention branches
differ.  The reference runs its default ``ref`` kernel backend (its scan
is the sequential oracle under autodiff), the port runs on CPU tensors
(K5 and K5-bwd take their plain pair through the same autograd Function).
Tolerances, each with its reason:

  * the config's ``param_count`` and the parameter tree: exact;
  * the SSM heads alone (``apply_ssm``): 1e-5 (float32);
  * the loss: rtol 1e-5; every gradient leaf within 1e-4 of that leaf's
    max |g| (float32; the checkpointed adjoint against autodiff through
    the oracle, flash attention's backward against autodiff — the same
    sums in other orders);
  * the 5-step loss curve of the train step: rtol 1e-4 at every step
    (differences compound through AdamW's normalised updates);
  * remat full and dots against none in the port: 1e-6;
  * resume from the port's own checkpoint and from the reference's:
    bit-identical.
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
from repro.models import build_model as jbuild_model
from repro.models import recurrent as jrec
from repro.parallel.sharding import Plan as JPlan
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import jit_train_step, make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_train_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ssm_scan
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, lm, recurrent
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                               make_train_step)
from repro_torch.tree import flatten

BATCH, SEQ, STEPS = 2, 40, 5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
# (name, mean, std) of the block parameters moved off their init
MOVED = (("ssm_A_log", 0.0, 0.5), ("ssm_b_dt", 1.0, 1.0), ("ssm_D", 0.0, 1.0),
         ("ssm_conv_w", 0.0, 0.3), ("ssm_w_B", 0.0, 0.1),
         ("ssm_w_C", 0.0, 0.1), ("ssm_w_dt1", 0.0, 0.1),
         ("ssm_w_dt2", 0.0, 0.1), ("fuse_attn", 1.0, 0.3),
         ("fuse_ssm", 1.0, 0.3))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


class Ref:
    """The reference's reduced hymba-1.5b (float32) train state and step."""

    def __init__(self):
        self.cfg = jreduced(jget_config("hymba-1.5b"), dtype="float32")
        self.model = jbuild_model(self.cfg)
        self.opt = JOptimizerConfig(**OPT)
        state = jax.jit(lambda key: jinit_train_state(
            self.model, key, self.opt))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        blocks = state["params"]["blocks"]
        for name, mean, std in MOVED:
            blocks[name] = jnp.asarray(
                mean + std * rng.standard_normal(blocks[name].shape),
                jnp.float32)
        self.state = state
        self.step = jit_train_step(jmake_train_step(
            self.model, self.opt, JPlan(remat="none")), donate=False)
        self.stream = jmake_stream(self.cfg, JShapeConfig(
            "t", SEQ, BATCH, "train"), JDataConfig(seed=0, vocab_size=256))

    def np_state(self, state=None):
        return jax.tree.map(np.asarray, self.state if state is None else state)

    def tokens(self, step):
        return {"tokens": jnp.asarray(self.stream.batch_at(step)["tokens"])}


@pytest.fixture(scope="module")
def ref():
    return Ref()


def _cfg():
    return reduced(get_config("hymba-1.5b"), dtype="float32")


def _port(ref_, state=None, plan=None):
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    tstate = from_jax_train_state(ref_.np_state(state), cfg, "cpu")
    step = make_train_step(model, OptimizerConfig(**OPT),
                           plan or Plan(remat="none"))
    return model, tstate, step


def _batch(ref_, step):
    return {k: torch.from_numpy(v)
            for k, v in ref_.stream.batch_at(step).items()}


def _assert_states_equal(a, b):
    for (ka, x), (kb, y) in zip(flatten(a), flatten(b)):
        assert ka == kb and x.dtype == y.dtype and torch.equal(x, y), ka


def test_config_and_parameter_tree_match_reference(ref):
    full, jfull = get_config("hymba"), jget_config("hymba-1.5b")
    assert full == get_config("hymba-1.5b") and full.family == "hybrid"
    assert full.param_count() == jfull.param_count() == 1_641_630_400
    small = reduced(full)
    assert (small.num_layers, small.d_model, small.num_heads,
            small.num_kv_heads, small.head_dim, small.sliding_window,
            small.global_attn_layers) == (2, 64, 4, 2, 16, 16, (0,))
    assert small.param_count() == jreduced(jfull).param_count()
    want = {k: v.shape for k, v in flatten(ref.np_state()["params"])}
    got = {k: tuple(v.shape)
           for k, v in flatten(build_model(small, "cpu").init(seed=0))}
    assert got == want
    # full depth: the layer axes, d_inner 3200, state 16, dt rank 16
    shapes = lm.param_shapes(full)
    assert shapes["blocks/ssm_w_in"][0] == (32, 1600, 3200)
    assert shapes["blocks/ssm_A_log"][0] == (32, 3200, 16)
    assert shapes["blocks/ssm_w_dt2"][0] == (32, 16, 3200)
    assert shapes["blocks/attn_wk"][0] == (32, 1600, 5, 64)
    assert 1.6e9 < sum(np.prod(s) for s, _ in shapes.values()) < 1.7e9
    # global attention at layers 0, 15 and 31, a 2048 window elsewhere
    windows = [lm.layer_window(full, i) for i in range(32)]
    assert [i for i, w in enumerate(windows) if w == 0] == [0, 15, 31]
    assert set(windows) == {0, 2048}
    assert [lm.layer_window(small, i) for i in range(2)] == [0, 16]


def test_ssm_heads_match_reference(ref):
    """``apply_ssm`` alone on the moved parameters of layer 1."""
    cfg = _cfg()
    jp = jax.tree.map(lambda a: a[1], ref.state["params"]["blocks"])
    xn = np.random.default_rng(2).normal(size=(BATCH, SEQ, 64)).astype(
        np.float32)
    want = jrec.apply_ssm(jp, jnp.asarray(xn), ref.cfg)
    _, tstate, _ = _port(ref)
    tp = lm.layers(cfg, tstate["params"]["blocks"])[1]
    n0 = ssm_scan.launches
    got = recurrent.apply_ssm(tp, torch.from_numpy(xn), cfg)
    assert ssm_scan.launches == n0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_loss_and_gradients_match_reference(ref):
    tokens = ref.tokens(0)
    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(
        lambda p: ref.model.loss(p, tokens, remat="none"), has_aux=True))(
        ref.state["params"])
    model, tstate, _ = _port(ref)
    params = tstate["params"]
    leaves = [p.requires_grad_() for _, p in flatten(params)]
    n0 = (ssm_scan.launches, ssm_scan.bwd_launches)
    tl, tmetrics = model.loss(params, _batch(ref, 0), remat="none")
    tg = torch.autograd.grad(tl, leaves)
    assert (ssm_scan.launches, ssm_scan.bwd_launches) == n0  # plain pair
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for name in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(_np(tmetrics[name]), _np(jmetrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for (key, want), got in zip(flatten(jax.tree.map(np.asarray, jg)), tg):
        scale = float(np.abs(want).max())
        assert scale > 0, key  # every leaf, the SSM's included, gets a gradient
        np.testing.assert_allclose(_np(got), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=key)


def test_window_changes_the_loss(ref):
    """Layer 1's window of 16 matters at seq 40: with it made global the
    loss moves (so the parity above covers both attention branches)."""
    model, tstate, _ = _port(ref)
    batch = _batch(ref, 0)
    with torch.no_grad():
        base = float(model.loss(tstate["params"], batch)[0])
        with mock.patch.object(lm, "layer_window", lambda cfg, i: 0):
            flat = float(model.loss(tstate["params"], batch)[0])
    assert abs(base - flat) > 1e-4, (base, flat)


def test_loss_curve_matches_reference(ref):
    _, tstate, tstep = _port(ref)
    jstate = ref.state
    for i in range(STEPS):
        jstate, jm = ref.step(jstate, ref.tokens(i))
        tstate, tm = tstep(tstate, _batch(ref, i))
        for name in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(_np(tm[name]), _np(jm[name]),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS


def test_remat_full_does_not_change_the_step(ref):
    results = []
    for plan in (Plan(remat="none"), Plan(remat="full")):
        _, state, step = _port(ref, plan=plan)
        for i in range(2):
            state, metrics = step(state, _batch(ref, i))
        results.append((state, metrics))
    (a, ma), (b, mb) = results
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(mb[name]), _np(ma[name]), atol=1e-6)
    for (key, x), (_, y) in zip(flatten(a), flatten(b)):
        np.testing.assert_allclose(_np(y), _np(x), atol=1e-6, err_msg=key)


def test_remat_dots_raises(ref):
    """Remat dots, refused until the port saved the block's products,
    now runs: two steps equal remat none's (the reference's loss and
    gradients at dots: tests/test_torch_remat_dots.py)."""
    results = []
    for plan in (Plan(remat="none"), Plan(remat="dots")):
        _, state, step = _port(ref, plan=plan)
        for i in range(2):
            state, metrics = step(state, _batch(ref, i))
        results.append((state, metrics))
    (a, ma), (b, mb) = results
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(mb[name]), _np(ma[name]), atol=1e-6)
    for (key, x), (_, y) in zip(flatten(a), flatten(b)):
        np.testing.assert_allclose(_np(y), _np(x), atol=1e-6, err_msg=key)


def test_resume_from_port_checkpoint_is_exact(ref, tmp_path):
    """4 steps unbroken against 2, a save and restore through the port's
    Checkpointer into a state of another seed, and 2 more: bit for bit."""
    model, _, step = _port(ref)
    opt = OptimizerConfig(**OPT)

    def run(state, steps):
        for i in steps:
            state, _ = step(state, _batch(ref, i))
        return state

    a = run(init_train_state(model, 0, opt), range(4))
    b = run(init_train_state(model, 0, opt), range(2))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, b)
    b, saved = ck.restore(init_train_state(model, 1, opt))
    assert saved == 1
    _assert_states_equal(a, run(b, range(2, 4)))


def test_resume_from_reference_checkpoint_is_exact(ref, tmp_path):
    """The reference's Checkpointer writes its train state after two
    steps; the port restores it bit for bit (the same state the bridge
    gives), and its next step equals the reference's."""
    jstate = ref.state
    for i in range(2):
        jstate, _ = ref.step(jstate, ref.tokens(i))
    JCheckpointer(str(tmp_path)).save(1, jstate, blocking=True)
    _, like, tstep = _port(ref)
    restored, saved = Checkpointer(str(tmp_path)).restore(like)
    assert saved == 1 and int(restored["step"]) == 2
    _, bridged, _ = _port(ref, state=jstate)
    _assert_states_equal(restored, bridged)
    jnext, jm = ref.step(jstate, ref.tokens(2))
    tnext, tm = tstep(restored, _batch(ref, 2))
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-4)
    _assert_states_equal(tnext, tstep(bridged, _batch(ref, 2))[0])
    for (key, a), (_, b) in zip(flatten(tnext["params"]), flatten(
            jax.tree.map(np.asarray, jnext["params"]))):
        np.testing.assert_allclose(_np(a), b, atol=1e-5, err_msg=key)


def test_reference_restores_port_checkpoint(ref, tmp_path):
    """The other way: the port's checkpoint after two steps restores into
    the reference's train state bit for bit."""
    _, tstate, tstep = _port(ref)
    for i in range(2):
        tstate, _ = tstep(tstate, _batch(ref, i))
    Checkpointer(str(tmp_path)).save(1, tstate, blocking=True)
    restored, saved = JCheckpointer(str(tmp_path)).restore(ref.state)
    assert saved == 1
    for (key, a), (_, b) in zip(flatten(jax.tree.map(np.asarray, restored)),
                                flatten(tstate)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy(),
                                      err_msg=key)


def test_serving_paths_raise(ref):
    """hymba serves on the fused engine; the refusals the reference
    keeps raise its ``ValueError``: padded prefill (the state would carry
    pad steps), the paged cache and speculation (the state has no pages
    and cannot roll back rejected drafts)."""
    model, state, _ = _port(ref)
    params = state["params"]
    tokens = torch.ones((1, 4), dtype=torch.int32)
    for call, what in ((lambda: model.prefill(params, tokens,
                                              lens=torch.tensor([3])), "lens"),
                       (lambda: model.init_paged_cache(1, 4, 8, 2), "paged"),
                       (lambda: ServeEngine(model, params, engine="paged"),
                        "paged"),
                       (lambda: ServeEngine(model, params, spec_k=2),
                        "speculative"),
                       (lambda: model.verify_step(params,
                                                  model.init_cache(1, 8),
                                                  tokens), "speculative")):
        with pytest.raises(ValueError, match=what):
            call()
    assert not model.supports_paged_cache()
    assert not model.supports_speculative()
    assert not model.supports_padded_prefill()
    assert ServeEngine(model, params).engine == "fused"


def test_train_cli_runs_reduced_hymba(tmp_path, capsys):
    argv = ["train", "--arch", "hymba-1.5b", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "24", "--runs-dir", str(tmp_path)]
    with mock.patch("sys.argv", argv):
        train_cli.main()
    out = capsys.readouterr().out
    assert "step 2 loss=" in out and "steps=3" in out
    assert np.isfinite(float(out.split("step 2 loss=")[1].split()[0]))
