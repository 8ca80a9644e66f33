"""The port's training path against the reference, on the CPU.

Numpy inputs from a seed go through both packages: the reference runs
with its default ``ref`` kernel backend (at these sizes its attention is
plain ``ref.attention`` under autodiff), the port on CPU tensors (K1 and
K1-bwd take their plain pair through the same autograd Function).
Tolerances, each with its reason:

  * ``lr_at``: 1e-7 absolute (float32 arithmetic on both sides);
  * one ``adamw_update`` with clipping active and with bfloat16 moments:
    1e-6 (float32 arithmetic in the same op order; bfloat16 moments are
    compared after both round them);
  * ``batch_at``: byte-identical (the same numpy code);
  * loss on ``reduced(qwen2-1.5b, dtype="float32")``: rtol 1e-5; every
    gradient leaf within 1e-4 of that leaf's max |g| (float32, other
    summation orders through two layers and the vocabulary projection);
  * the 5-step loss curve of the train step: rtol 1e-4 at every step
    (differences compound through AdamW's normalised updates);
  * microbatch 2 vs 1, and remat full and dots vs none in the port: 1e-6;
  * resume from the port's own checkpoint: bit-identical.
"""
import os
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
from repro.train import optimizer as jopt
from repro_torch.bridge import from_jax_train_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, make_stream
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import build_model
from repro_torch.train import (OptimizerConfig, Plan, adamw_init,
                               adamw_update, init_train_state,
                               keep_input_state, lr_at, make_train_step)
from repro_torch.train import optimizer as topt
from repro_torch.tree import flatten, tree_map

BATCH, SEQ, STEPS = 4, 32, 5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# optimizer
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=40, schedule=schedule)
    steps = np.arange(0, 46, dtype=np.int32)
    want = np.asarray(jopt.lr_at(JOptimizerConfig(**kw), jnp.asarray(steps)))
    got = lr_at(OptimizerConfig(**kw), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def _opt_trees(rng, moment_dtype):
    shapes = {"a": (6, 5), "b": {"c": (7,), "d": (3, 4, 2)}}

    def mk(shape, scale):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def tree(scale):
        return {"a": mk(shapes["a"], scale),
                "b": {"c": mk(shapes["b"]["c"], scale),
                      "d": mk(shapes["b"]["d"], scale)}}

    params, grads = tree(1.0), tree(3.0)  # global norm ~ 16 > clip 1
    m, v = tree(0.1), tree(0.1)
    v = jax.tree.map(np.abs, v)
    if moment_dtype == "bfloat16":  # moments that bfloat16 holds exactly
        m, v = (jax.tree.map(lambda x: np.asarray(
            jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)), t)
            for t in (m, v))
    return params, grads, m, v


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    cfg = dict(lr=1e-2, clip_norm=1.0, weight_decay=0.1, warmup_steps=2,
               total_steps=20, moment_dtype=moment_dtype)
    params, grads, m, v = _opt_trees(np.random.default_rng(0), moment_dtype)
    jdt = jnp.dtype(moment_dtype)
    jstate = {"m": jax.tree.map(lambda x: jnp.asarray(x, jdt), m),
              "v": jax.tree.map(lambda x: jnp.asarray(x, jdt), v),
              "count": jnp.asarray(3, jnp.int32)}
    jp, js, jm = jopt.adamw_update(jax.tree.map(jnp.asarray, grads), jstate,
                                   jax.tree.map(jnp.asarray, params),
                                   JOptimizerConfig(**cfg))
    tdt = getattr(torch, moment_dtype)
    def tt(tree, dt=torch.float32):
        return tree_map(lambda x: torch.from_numpy(x.copy()).to(dt), tree)

    tparams = tt(params)
    tstate = {"m": tt(m, tdt), "v": tt(v, tdt),
              "count": torch.tensor(3, dtype=torch.int32)}
    tp, ts, tm = adamw_update(tt(grads), tstate, tparams,
                              OptimizerConfig(**cfg))
    assert tp is tparams and ts is tstate  # updated in place
    assert float(tm["grad_norm"]) > 1.0  # clipping is active
    for name in ("lr", "grad_norm"):
        np.testing.assert_allclose(_np(tm[name]), _np(jm[name]), rtol=1e-6)
    assert int(ts["count"]) == int(js["count"]) == 4
    for (key, a), (_, b) in zip(flatten(tp), flatten(jax.tree.map(
            np.asarray, jp))):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, err_msg=key)
    for part in ("m", "v"):
        for (key, a), (_, b) in zip(flatten(ts[part]), flatten(
                jax.tree.map(np.asarray, js[part]))):
            assert a.dtype == tdt
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-6,
                                       err_msg=f"{part}/{key}")


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_row_blocks_do_not_change_the_update(moment_dtype):
    """The update walks a leaf in blocks of rows (``_BLOCK_ELEMS``, so its
    temporaries stay small beside a large leaf): blocks of 8 elements give
    the one-block update bit for bit."""
    cfg = OptimizerConfig(lr=1e-2, clip_norm=1.0, weight_decay=0.1,
                          warmup_steps=2, total_steps=20,
                          moment_dtype=moment_dtype)
    params, grads, m, v = _opt_trees(np.random.default_rng(0), moment_dtype)
    tdt = getattr(torch, moment_dtype)

    def run():
        def tt(tree, dt=torch.float32):
            return tree_map(lambda x: torch.from_numpy(x.copy()).to(dt), tree)
        p = tt(params)
        state = {"m": tt(m, tdt), "v": tt(v, tdt),
                 "count": torch.tensor(3, dtype=torch.int32)}
        adamw_update(tt(grads), state, p, cfg)
        return flatten({"p": p, "m": state["m"], "v": state["v"]})

    whole = run()
    with mock.patch.object(topt, "_BLOCK_ELEMS", 8):
        assert len(topt._row_blocks(torch.zeros(6, 5))) == 6
        blocked = run()
    for (key, a), (_, b) in zip(whole, blocked):
        assert torch.equal(a, b), key


def test_clip_and_norm_match_reference():
    _, grads, _, _ = _opt_trees(np.random.default_rng(1), "float32")
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 2.0)
    tc, tn = topt.clip_by_global_norm(
        tree_map(torch.from_numpy, grads), 2.0)
    np.testing.assert_allclose(_np(tn), _np(jn), rtol=1e-6)
    for (key, a), (_, b) in zip(flatten(tc), flatten(jax.tree.map(
            np.asarray, jc))):
        np.testing.assert_allclose(_np(a), b, atol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# data
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_batches_are_byte_identical_to_the_reference(seed):
    jcfg = jreduced(jget_config("qwen2-1.5b"))
    tcfg = reduced(get_config("qwen2-1.5b"))
    jstream = jmake_stream(jcfg, JShapeConfig("t", 48, 4, "train"),
                           JDataConfig(seed=seed, vocab_size=200))
    tstream = make_stream(tcfg, ShapeConfig("t", 48, 4, "train"),
                          DataConfig(seed=seed, vocab_size=200))
    for step in (0, 1, 5):
        a, b = jstream.batch_at(step), tstream.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (seed, step, k)


# ---------------------------------------------------------------------------
# loss, gradients and the train step against the reference
class Ref:
    """The reference's reduced qwen2-1.5b (float32) train state and step."""

    def __init__(self):
        self.cfg = jreduced(jget_config("qwen2-1.5b"), dtype="float32")
        self.model = jbuild_model(self.cfg)
        self.opt = JOptimizerConfig(**OPT)
        state = jax.jit(lambda key: jinit_train_state(
            self.model, key, self.opt))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)  # biases off their zero init
        blocks = state["params"]["blocks"]
        for name in ("attn_bq", "attn_bk", "attn_bv"):
            blocks[name] = jnp.asarray(
                0.1 * rng.standard_normal(blocks[name].shape), jnp.float32)
        self.state = state
        self.step = jit_train_step(jmake_train_step(
            self.model, self.opt, JPlan(remat="none")), donate=False)
        self.stream = jmake_stream(self.cfg, JShapeConfig(
            "t", SEQ, BATCH, "train"), JDataConfig(seed=0, vocab_size=256))

    def np_state(self, state=None):
        return jax.tree.map(np.asarray, self.state if state is None else state)


@pytest.fixture(scope="module")
def ref():
    return Ref()


def _port(ref_, state=None, plan=None):
    cfg = reduced(get_config("qwen2-1.5b"), dtype="float32")
    model = build_model(cfg, device="cpu")
    tstate = from_jax_train_state(ref_.np_state(state), cfg, "cpu")
    step = make_train_step(model, OptimizerConfig(**OPT),
                           plan or Plan(remat="none"))
    return model, tstate, step


def _batch(ref_, step):
    return {k: torch.from_numpy(v)
            for k, v in ref_.stream.batch_at(step).items()}


def test_loss_and_gradients_match_reference(ref):
    batch = ref.stream.batch_at(0)
    jparams = ref.state["params"]

    def jloss(p):
        return ref.model.loss(p, {"tokens": jnp.asarray(batch["tokens"])},
                              remat="none")

    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams)
    model, tstate, _ = _port(ref)
    params = tstate["params"]
    leaves = [p.requires_grad_() for _, p in flatten(params)]
    tl, tmetrics = model.loss(params, _batch(ref, 0), remat="none")
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for name in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(_np(tmetrics[name]), _np(jmetrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for (key, want), got in zip(flatten(jax.tree.map(np.asarray, jg)), tg):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, atol=1e-4 * scale,
                                   rtol=0, err_msg=key)


def test_loss_curve_matches_reference(ref):
    _, tstate, tstep = _port(ref)
    jstate = ref.state
    for i in range(STEPS):
        jstate, jm = ref.step(jstate, {"tokens": jnp.asarray(
            ref.stream.batch_at(i)["tokens"])})
        tstate, tm = tstep(tstate, _batch(ref, i))
        for name in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(_np(tm[name]), _np(jm[name]),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS
    assert int(tstate["opt"]["count"]) == STEPS


@pytest.mark.parametrize("knob", ["microbatch", "remat", "dots"])
def test_plan_knobs_do_not_change_the_step(ref, knob):
    """Microbatch 2 against 1, and remat full and dots against none: the
    same loss metric for the last microbatch, the same update."""
    plan = {"microbatch": Plan(remat="none", microbatch=2),
            "remat": Plan(remat="full"), "dots": Plan(remat="dots")}[knob]
    results = []
    for p in (Plan(remat="none"), plan):
        _, state, step = _port(ref, plan=p)
        for i in range(2):
            state, metrics = step(state, _batch(ref, i))
        results.append((state, metrics))
    (a, ma), (b, mb) = results
    for name in ("grad_norm", "lr"):
        np.testing.assert_allclose(_np(mb[name]), _np(ma[name]), atol=1e-6)
    for (key, x), (_, y) in zip(flatten(a), flatten(b)):
        np.testing.assert_allclose(_np(y), _np(x), atol=1e-6, err_msg=key)
    if knob != "microbatch":
        np.testing.assert_allclose(_np(mb["loss"]), _np(ma["loss"]),
                                   atol=1e-6)


def test_unported_train_paths_raise(ref):
    """The train paths that raised before the parallel layer was ported
    now run: a step on a mesh (here the local mesh of one process, bit
    for bit the unsharded step) and gradient compression (here with the
    reference's own Plan: the step's error is non-zero after one step);
    an unknown remat policy and an unknown ``moe_impl`` still raise (the
    latter the reference's assertion).  The multi-rank meshes are
    tests/test_torch_parallel.py's."""
    model, state, step = _port(ref)
    # remat dots runs (tests/test_torch_remat_dots.py); an unknown policy
    # raises
    with pytest.raises(ValueError, match="none, full or dots"):
        model.loss(state["params"], _batch(ref, 0), remat="everything")
    copy = tree_map(lambda x: x.detach().clone(), state)
    a, ma = step(state, _batch(ref, 0))
    mesh = local_mesh("cpu")
    b, mb = make_train_step(model, OptimizerConfig(**OPT),
                            Plan(remat="none"), mesh=mesh)(copy,
                                                           _batch(ref, 0))
    for name in ("loss", "ce", "tokens", "grad_norm", "lr"):
        assert torch.equal(ma[name], mb[name]), name
    for (key, x), (_, y) in zip(flatten(a), flatten(b)):
        assert torch.equal(x, y), key
    st = init_train_state(model, 0, OptimizerConfig(**OPT),
                          Plan(compress_grads=True))
    cstep = make_train_step(model, OptimizerConfig(**OPT),
                            JPlan(compress_grads=True, remat="none"))
    st, m = cstep(st, _batch(ref, 0))
    assert np.isfinite(float(m["loss"]))
    assert any(bool(e.abs().max() > 0) for _, e in flatten(st["grad_err"]))
    with pytest.raises(AssertionError):
        make_train_step(model, OptimizerConfig(), Plan(moe_impl="a2a"))


# ---------------------------------------------------------------------------
# checkpointer: the reference's tests/test_checkpoint.py cases, mirrored
def _state(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(4, 8)).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    return {
        "params": {"w": torch.from_numpy(w),
                   "b": torch.from_numpy(b).to(torch.bfloat16)},
        "opt": {"m": {"w": torch.zeros((4, 8))},
                "count": torch.tensor(3, dtype=torch.int32)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves_equal(a, b):
    for (ka, x), (kb, y) in zip(flatten(a), flatten(b)):
        assert ka == kb and x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y), ka


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    state = _state()
    ck.save(7, state, blocking=True)
    restored, step = ck.restore(state)
    assert step == 7
    _leaves_equal(state, restored)


def test_checkpoint_async_save_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1), blocking=False)
    ck.wait()
    assert ck.latest_step() == 1


def test_checkpoint_rotation_keeps_last_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(s), blocking=True)
    assert ck._steps() == [3, 4]


def test_checkpoint_atomic_commit_ignores_partial_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(5, _state(), blocking=True)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a save killed midway
    assert ck.latest_step() == 5
    _, step = ck.restore(_state())
    assert step == 5


def test_checkpoint_restore_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(), blocking=True)
    bad = _state()
    bad["params"]["w"] = torch.zeros((2, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(bad)


def test_checkpoint_restore_latest_of_many(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    for s in (2, 9, 4):
        ck.save(s, _state(s), blocking=True)
    _, step = ck.restore(_state())
    assert step == 9


def test_checkpoints_cross_between_the_packages(tmp_path):
    """Either package restores what the other wrote: same keys, same
    values, bfloat16 included."""
    state = _state(3)
    Checkpointer(str(tmp_path / "port"), keep=1).save(7, state, blocking=True)
    like = {k: v for k, v in flatten(state)}
    jstate, step = JCheckpointer(str(tmp_path / "port")).restore(
        _jax_like(state))
    assert step == 7
    for key, x in flatten(jstate):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      _np(like[key]), err_msg=key)
    JCheckpointer(str(tmp_path / "ref")).save(8, _jax_like(state),
                                              blocking=True)
    restored, step = Checkpointer(str(tmp_path / "ref")).restore(state)
    assert step == 8
    _leaves_equal(state, restored)


def _jax_like(state):
    def conv(x):
        if x.dtype == torch.bfloat16:
            return jnp.asarray(x.float().numpy(), jnp.bfloat16)
        return jnp.asarray(x.numpy())
    return tree_map(conv, state)


def test_restore_from_reference_checkpoint_then_step(ref, tmp_path):
    """The reference's Checkpointer writes its train state after two
    steps; the port restores it and its next step equals the
    reference's."""
    jstate = ref.state
    for i in range(2):
        jstate, _ = ref.step(jstate, {"tokens": jnp.asarray(
            ref.stream.batch_at(i)["tokens"])})
    JCheckpointer(str(tmp_path)).save(1, jstate, blocking=True)
    model, like, tstep = _port(ref)
    tstate, step = Checkpointer(str(tmp_path)).restore(like)
    assert step == 1 and int(tstate["step"]) == 2
    jnext, jm = ref.step(jstate, {"tokens": jnp.asarray(
        ref.stream.batch_at(2)["tokens"])})
    tnext, tm = tstep(tstate, _batch(ref, 2))
    np.testing.assert_allclose(_np(tm["loss"]), _np(jm["loss"]), rtol=1e-4)
    for (key, a), (_, b) in zip(flatten(tnext["params"]), flatten(
            jax.tree.map(np.asarray, jnext["params"]))):
        np.testing.assert_allclose(_np(a), b, rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_resume_is_bit_identical(ref, tmp_path):
    """4 steps unbroken against 2 steps, a save and restore into a fresh
    state through the port's Checkpointer, and 2 more."""
    _, a, step = _port(ref)
    losses_a = []
    for i in range(4):
        a, m = step(a, _batch(ref, i))
        losses_a.append(_np(m["loss"]))
    _, b, step = _port(ref)
    losses_b = []
    for i in range(2):
        b, m = step(b, _batch(ref, i))
        losses_b.append(_np(m["loss"]))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, b)
    _, fresh, step = _port(ref)
    b, start = ck.restore(fresh)
    for i in range(start + 1, 4):
        b, m = step(b, _batch(ref, i))
        losses_b.append(_np(m["loss"]))
    assert [x.tobytes() for x in losses_a] == [x.tobytes() for x in losses_b]
    _leaves_equal(tree_map(torch.Tensor.detach, a),
                  tree_map(torch.Tensor.detach, b))


def test_keep_input_state_leaves_the_callers_state(ref):
    _, state, step = _port(ref)
    before = tree_map(lambda x: x.detach().clone(), state)
    new, _ = keep_input_state(step)(state, _batch(ref, 0))
    _leaves_equal(tree_map(torch.Tensor.detach, state), before)
    assert int(new["step"]) == 1 and int(state["step"]) == 0


def test_train_cli_on_the_cpu_resumes(tmp_path, capsys):
    runs = str(tmp_path / "runs")
    argv = ["train", "--device", "cpu", "--steps", "3", "--batch", "2",
            "--seq", "16", "--ckpt-every", "2", "--runs-dir", runs]
    with mock.patch("sys.argv", argv):
        train_cli.main()
    out = capsys.readouterr().out
    assert "steps=3 loss" in out and "device=cpu" in out
    assert sorted(os.listdir(os.path.join(runs, "ckpt"))) == [
        "step_00000001", "step_00000002"]
    argv[argv.index("--steps") + 1] = "4"
    with mock.patch("sys.argv", argv):
        train_cli.main()
    out = capsys.readouterr().out
    assert "restored step 2" in out and "steps=1 loss" in out


def test_init_train_state_layout():
    cfg = reduced(get_config("qwen2-1.5b"))
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, 0,
                             OptimizerConfig(moment_dtype="bfloat16"))
    keys = [k for k, _ in flatten(state)]
    assert "opt/m/blocks/attn_wq" in keys and "opt/count" in keys
    assert state["opt"]["v"]["embed"].dtype == torch.bfloat16
    assert state["params"]["embed"].dtype == torch.float32
    fresh = adamw_init(state["params"], OptimizerConfig())
    assert fresh["m"]["final_g"].dtype == torch.float32
