"""The port's xLSTM training path against the reference, on the CPU.

``reduced(xlstm-125m)`` (2 layers: one group of one mLSTM and one sLSTM
block, d_model 64, 4 heads, vocab 256) in float32, with the reference's
weights bridged through numpy and its gates moved off their init so that
the stabilisers work.  The reference runs its default ``ref`` kernel
backend (its mLSTM is the sequential oracle under autodiff), the port
runs on CPU tensors (K6 and K6-bwd take their plain pair through the
same autograd Function; the sLSTM is its loop).  Tolerances, each with
its reason:

  * the config's ``param_count`` and the parameter tree: exact;
  * the loss: rtol 1e-5; every gradient leaf within 1e-4 of that leaf's
    max |g| (float32; the chunkwise mLSTM backward holds the stabiliser
    constant, the sLSTM's input projection is one product before the
    loop — the same sums in other orders);
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
from repro.parallel.sharding import Plan as JPlan
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import jit_train_step, make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_params, from_jax_train_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import mlstm_scan
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, lm
from repro_torch.serve import ServeEngine
from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                               make_train_step)
from repro_torch.tree import flatten

BATCH, SEQ, STEPS = 2, 24, 5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
# gates moved off their init: varied input gates, forget gates near 0.5
GATE_SCALES = {"mlstm/b_i": 1.0, "mlstm/b_f": 0.5, "mlstm/w_i": 0.3,
               "mlstm/w_f": 0.3, "slstm/b_gates": 0.5, "slstm/r_gates": 0.2}


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
    """The reference's reduced xlstm-125m (float32) train state and step."""

    def __init__(self, **over):
        self.cfg = jreduced(jget_config("xlstm-125m"), dtype="float32",
                            **over)
        self.model = jbuild_model(self.cfg)
        self.opt = JOptimizerConfig(**OPT)
        state = jax.jit(lambda key: jinit_train_state(
            self.model, key, self.opt))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        blocks = state["params"]["blocks"]
        for path, scale in GATE_SCALES.items():
            group, name = path.split("/")
            if group in blocks:
                blocks[group][name] = jnp.asarray(
                    scale * rng.standard_normal(blocks[group][name].shape),
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


def _port(ref_, state=None, plan=None):
    cfg = reduced(get_config("xlstm-125m"), dtype="float32",
                  slstm_every=ref_.cfg.slstm_every)
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
    full, jfull = get_config("xlstm"), jget_config("xlstm-125m")
    assert full.name == "xlstm-125m" and full.family == "ssm"
    assert full.param_count() == jfull.param_count()
    small = reduced(full)
    assert small.slstm_every == 2 and small.num_layers == 2
    assert small.param_count() == jreduced(jfull).param_count()
    want = {k: v.shape for k, v in flatten(ref.np_state()["params"])}
    got = {k: tuple(v.shape)
           for k, v in flatten(build_model(small, "cpu").init(seed=0))}
    assert got == want
    # 9 mLSTM and 3 sLSTM blocks at full depth, with their layer axes
    shapes = lm.param_shapes(full)
    assert shapes["blocks/mlstm/w_q"][0] == (9, 4, 384, 384)
    assert shapes["blocks/slstm/r_gates"][0] == (3, 4, 4, 192, 192)
    assert 0.09e9 < sum(np.prod(s) for s, _ in shapes.values()) < 0.11e9


def test_bridge_refuses_unexpected_and_misshapen_trees(ref):
    cfg = reduced(get_config("xlstm-125m"), dtype="float32")
    params = ref.np_state()["params"]
    bad = dict(params, blocks=dict(params["blocks"], extra={"w": np.zeros(2)}))
    with pytest.raises(KeyError, match="unexpected parameters"):
        from_jax_params(bad, cfg, "cpu")
    slstm = dict(params["blocks"]["slstm"])
    del slstm["r_gates"]
    with pytest.raises(KeyError, match="missing parameters"):
        from_jax_params(dict(params, blocks=dict(params["blocks"],
                                                 slstm=slstm)), cfg, "cpu")
    mlstm = dict(params["blocks"]["mlstm"], w_q=np.zeros((1, 4, 32, 16),
                                                         np.float32))
    with pytest.raises(ValueError, match="w_q"):
        from_jax_params(dict(params, blocks=dict(params["blocks"],
                                                 mlstm=mlstm)), cfg, "cpu")


def _loss_and_grads_match(ref_):
    tokens = ref_.tokens(0)
    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(
        lambda p: ref_.model.loss(p, tokens, remat="none"), has_aux=True))(
        ref_.state["params"])
    model, tstate, _ = _port(ref_)
    params = tstate["params"]
    leaves = [p.requires_grad_() for _, p in flatten(params)]
    n0 = (mlstm_scan.launches, mlstm_scan.bwd_launches)
    tl, tmetrics = model.loss(params, _batch(ref_, 0), remat="none")
    tg = torch.autograd.grad(tl, leaves)
    assert (mlstm_scan.launches, mlstm_scan.bwd_launches) == n0  # plain pair
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for name in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(_np(tmetrics[name]), _np(jmetrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for (key, want), got in zip(flatten(jax.tree.map(np.asarray, jg)), tg):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=key)


def test_loss_and_gradients_match_reference(ref):
    _loss_and_grads_match(ref)


def test_mlstm_only_stack_matches_reference():
    """``slstm_every=0``: two mLSTM blocks and no sLSTM."""
    _loss_and_grads_match(Ref(slstm_every=0))


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


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_does_not_change_the_step(ref, remat):
    """Remat full, and dots (which the xLSTM takes as full, as the
    reference does), against none: the same loss and update."""
    results = []
    for plan in (Plan(remat="none"), Plan(remat=remat)):
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


def test_serving_paths_raise(ref):
    """The xLSTM serves on the fused engine; the refusals the reference
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


def test_train_cli_runs_reduced_xlstm(tmp_path, capsys):
    argv = ["train", "--arch", "xlstm-125m", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "16", "--runs-dir", str(tmp_path)]
    with mock.patch("sys.argv", argv):
        train_cli.main()
    out = capsys.readouterr().out
    assert "step 2 loss=" in out and "steps=3" in out
    assert np.isfinite(float(out.split("step 2 loss=")[1].split()[0]))
