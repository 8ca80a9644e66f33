"""The port's whisper-large-v3 (the encoder-decoder) against the reference,
on the CPU.

``reduced(whisper-large-v3)`` (2 encoder and 2 decoder layers, d_model
64, 4 heads of 16, 8 stub frames, vocab 256) in float32, with the
reference's weights bridged through numpy and the layer norms' gains and
biases moved off their init.  The reference runs its default ``ref``
kernel backend, the port runs on CPU tensors (K1 and K1-bwd take their
plain pair through the same autograd Function).  Tolerances, each with
its reason:

  * the config's ``param_count`` and the parameter tree: exact;
  * ``sinusoidal``, ``encode``, the logits, prefill and two decode steps:
    2e-5 (float32: the same products summed in other orders);
  * the loss: rtol 1e-5; every gradient leaf within 2e-5 of that leaf's
    max |g| (float32; flash attention's backward against autodiff);
  * the 5-step loss curve of the train step: rtol 1e-4 at every step
    (differences compound through AdamW's normalised updates);
  * remat full against none: 1e-6; resume: bit-identical;
  * the engine's greedy tokens, and the template's checks: identical; the
    template's losses (bf16 compute): rtol 1e-4.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core import ProvenanceStore as JStore
from repro.core import REGISTRY as JREGISTRY
from repro.core import run_workflow as jrun_workflow
from repro.data import DataConfig as JDataConfig
from repro.data import make_stream as jmake_stream
from repro.models import build_model as jbuild_model
from repro.models import encdec as jencdec
from repro.parallel.sharding import Plan as JPlan
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import jit_train_step, make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_params, from_jax_train_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import REGISTRY, ProvenanceStore, run_workflow, stages
from repro_torch.kernels import flash_attention, flash_attention_bwd
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, encdec
from repro_torch.models.api import param_shapes
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _cache_batch_axes
from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                               make_train_step)
from repro_torch.tree import flatten

ARCH = "whisper-large-v3"
BATCH, SEQ, STEPS = 2, 12, 5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
TOL = 2e-5


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
    """The reference's reduced whisper (float32): weights with the norms
    moved off their init, its train state and step, and its stream."""

    def __init__(self):
        self.cfg = jreduced(jget_config(ARCH), dtype="float32")
        self.model = jbuild_model(self.cfg)
        self.opt = JOptimizerConfig(**OPT)
        state = jax.jit(lambda key: jinit_train_state(
            self.model, key, self.opt))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(1)
        for path, leaf in flatten(state["params"]):
            if path.split("/")[-1].startswith(("norm", "final", "enc_final")):
                moved = 0.3 * rng.standard_normal(leaf.shape)
                self._set(state["params"], path,
                          jnp.asarray(np.asarray(leaf) + moved, jnp.float32))
        self.state = state
        self.step = jit_train_step(jmake_train_step(
            self.model, self.opt, JPlan(remat="none")), donate=False)
        self.stream = jmake_stream(self.cfg, JShapeConfig(
            "t", SEQ, BATCH, "train"), JDataConfig(seed=0, vocab_size=256))

    @staticmethod
    def _set(tree, path, value):
        *head, last = path.split("/")
        for k in head:
            tree = tree[k]
        tree[last] = value

    @property
    def params(self):
        return self.state["params"]

    def np_state(self, state=None):
        return jax.tree.map(np.asarray, self.state if state is None else state)

    def batch(self, step):
        """The stream's batch, frames scaled up so the encoder matters."""
        raw = self.stream.batch_at(step)
        return {"tokens": raw["tokens"], "frames": raw["frames"] * 50.0}


@pytest.fixture(scope="module")
def ref():
    return Ref()


def _cfg():
    return reduced(get_config(ARCH), dtype="float32")


def _port(ref_, state=None, plan=None):
    cfg = _cfg()
    model = build_model(cfg, device="cpu")
    tstate = from_jax_train_state(ref_.np_state(state), cfg, "cpu")
    step = make_train_step(model, OptimizerConfig(**OPT),
                           plan or Plan(remat="none"))
    return model, tstate, step


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _assert_states_equal(a, b):
    for (ka, x), (kb, y) in zip(flatten(a), flatten(b)):
        assert ka == kb and x.dtype == y.dtype and torch.equal(x, y), ka


def test_config_and_parameter_tree_match_reference(ref):
    full, jfull = get_config("whisper"), jget_config(ARCH)
    assert full == get_config(ARCH) and full.is_encoder_decoder
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count() == 1_534_807_040
    assert reduced(full).param_count() == jreduced(jfull).param_count()
    want = {k: v.shape for k, v in flatten(ref.np_state()["params"])}
    got = {k: tuple(v.shape)
           for k, v in flatten(build_model(_cfg(), "cpu").init(seed=0))}
    assert got == want
    shapes = param_shapes(full)
    assert shapes["enc_blocks/attn_wq"][0] == (32, 1280, 20, 64)
    assert shapes["blocks/xattn_wo"][0] == (32, 20, 64, 1280)
    assert shapes["blocks/norm3_b"][0] == (32, 1280)
    assert "lm_head" not in shapes  # the tied head
    assert 1.5e9 < sum(np.prod(s) for s, _ in shapes.values()) < 1.6e9


def test_sinusoidal_matches_reference():
    """2e-5 at the reduced tests' positions; at the full shapes' positions
    (1499 frames, 4095 tokens) within four float32 ulps of the angle
    (``pos * 2**-23 * 4``): the two libraries' ``exp`` differ in the last
    bit of a frequency, and the angle multiplies that by the position."""
    small = np.array([[0, 3, 11], [7, 15, 12]], np.int32)
    large = np.array([[1499, 1000], [4095, 2048]], np.int32)
    for d in (64, 1280):
        for pos, atol in ((small, TOL), (large, 4095 * 2.0 ** -23 * 4)):
            want = np.asarray(jencdec.sinusoidal(jnp.asarray(pos), d))
            got = encdec.sinusoidal(torch.from_numpy(pos), d)
            assert got.shape == (2, pos.shape[1], d)
            np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0)


def test_encode_and_logits_match_reference(ref):
    batch = ref.batch(0)
    _, tstate, _ = _port(ref)
    cfg, params = _cfg(), tstate["params"]
    want = jencdec.encode(ref.params, ref.cfg, jnp.asarray(batch["frames"]))
    n0 = flash_attention.launches
    with torch.no_grad():
        got = encdec.encode(params, cfg, torch.from_numpy(batch["frames"]))
        logits, aux = encdec.forward_train(params, cfg, _tbatch(batch)["tokens"],
                                           _tbatch(batch))
    assert flash_attention.launches == n0  # the plain version on the CPU
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL, rtol=TOL)
    jlogits, _ = jencdec.forward_train(ref.params, ref.cfg,
                                       jnp.asarray(batch["tokens"]),
                                       _jbatch(batch))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=TOL,
                               rtol=TOL)
    assert float(aux) == 0.0


def test_loss_and_gradients_match_reference(ref):
    batch = ref.batch(0)
    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(
        lambda p: ref.model.loss(p, _jbatch(batch)), has_aux=True))(ref.params)
    model, tstate, _ = _port(ref)
    params = tstate["params"]
    leaves = [p.requires_grad_() for _, p in flatten(params)]
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    tl, tmetrics = model.loss(params, _tbatch(batch))
    tg = torch.autograd.grad(tl, leaves)
    assert (flash_attention.launches, flash_attention_bwd.launches) == n0
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for name in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(_np(tmetrics[name]), _np(jmetrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    for (key, want), got in zip(flatten(jax.tree.map(np.asarray, jg)), tg):
        scale = float(np.abs(want).max())
        assert scale > 0, key  # the encoder's leaves too
        np.testing.assert_allclose(_np(got), want, atol=TOL * scale, rtol=0,
                                   err_msg=key)


def test_prefill_and_decode_match_reference(ref):
    """Prefill 10 tokens, then two decode steps, against the reference's
    (and against the train forward's logits at those positions, the
    teacher-forcing check of the reference's own model tests)."""
    batch = ref.batch(1)
    tokens, frames = batch["tokens"], batch["frames"]
    S = 10
    model, tstate, _ = _port(ref)
    params = model.serving_params(tstate["params"])
    jl, jc = ref.model.prefill(ref.params, jnp.asarray(tokens[:, :S]),
                               {"frames": jnp.asarray(frames)}, max_seq=16)
    with torch.no_grad():
        tl, tc = model.prefill(params, torch.from_numpy(tokens[:, :S]),
                               {"frames": torch.from_numpy(frames)},
                               max_seq=16)
        full, _ = encdec.forward_train(tstate["params"], _cfg(),
                                       torch.from_numpy(tokens),
                                       _tbatch(batch))
    assert set(tc) == {"k", "v", "xk", "xv", "pos"}
    assert tuple(tc["xk"].shape) == (2, BATCH, 8, 2, 16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(tl), _np(full[:, S - 1]), atol=TOL,
                               rtol=TOL)
    for name in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   atol=TOL, rtol=TOL, err_msg=name)
    for t in (S, S + 1):
        nt = tokens[:, t:t + 1]
        jl, jc = ref.model.decode_step(ref.params, jc, jnp.asarray(nt))
        with torch.no_grad():
            tl, tc = model.decode_step(params, tc, torch.from_numpy(nt))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(_np(tl), _np(full[:, t]), atol=TOL,
                                   rtol=TOL)
    assert tc["pos"].tolist() == [S + 2] * BATCH


def test_loss_curve_matches_reference(ref):
    _, tstate, tstep = _port(ref)
    jstate = ref.state
    for i in range(STEPS):
        jstate, jm = ref.step(jstate, _jbatch(ref.batch(i)))
        tstate, tm = tstep(tstate, _tbatch(ref.batch(i)))
        for name in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(_np(tm[name]), _np(jm[name]),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
    assert int(tstate["step"]) == int(jstate["step"]) == STEPS


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_does_not_change_the_step(ref, remat):
    """Remat full (and dots, which is full for the encoder-decoder, as in
    the reference) checkpoints the decoder blocks only."""
    results = []
    for plan in (Plan(remat="none"), Plan(remat=remat)):
        _, state, step = _port(ref, plan=plan)
        for i in range(2):
            state, metrics = step(state, _tbatch(ref.batch(i)))
        results.append((state, metrics))
    (a, ma), (b, mb) = results
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(_np(mb[name]), _np(ma[name]), atol=1e-6)
    for (key, x), (_, y) in zip(flatten(a), flatten(b)):
        np.testing.assert_allclose(_np(y), _np(x), atol=1e-6, err_msg=key)
    calls = []
    with mock.patch.object(encdec, "checkpoint",
                           lambda fn, *a, **k: calls.append(fn) or fn(*a)):
        model, state, _ = _port(ref)
        model.loss(state["params"], _tbatch(ref.batch(0)), remat=remat)
    assert calls == [encdec._dec_block_train] * 2  # 2 decoder blocks


def test_resume_from_port_checkpoint_is_exact(ref, tmp_path):
    """4 steps unbroken against 2, a save and restore through the port's
    Checkpointer into a state of another seed, and 2 more: bit for bit."""
    model, _, step = _port(ref)
    opt = OptimizerConfig(**OPT)

    def run(state, steps):
        for i in steps:
            state, _ = step(state, _tbatch(ref.batch(i)))
        return state

    a = run(init_train_state(model, 0, opt), range(4))
    b = run(init_train_state(model, 0, opt), range(2))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, b)
    b, saved = ck.restore(init_train_state(model, 1, opt))
    assert saved == 1
    _assert_states_equal(a, run(b, range(2, 4)))


def _requests(request_cls, rng, lens):
    return [request_cls(uid=i, prompt=rng.integers(1, 256, n).astype(np.int32),
                        max_new_tokens=6,
                        extra={"frames": rng.standard_normal(
                            (8, 64)).astype(np.float32)})
            for i, n in enumerate(lens)]


def test_engine_exact_length_groups_match_reference(ref):
    """Requests of mixed prompt lengths on the fused engine: groups of
    equal length (no padding for the encoder-decoder), greedy tokens
    identical to the reference engine's; the cross cache is inserted by
    row like the self-attention cache."""
    lens = [5, 7, 5, 9, 7, 5, 11]
    jeng = JServeEngine(ref.model, ref.params, max_batch=4, max_seq=32,
                        eos_id=-1)
    for r in _requests(JRequest, np.random.default_rng(3), lens):
        jeng.submit(r)
    want = {c.uid: c.tokens for c in jeng.run()}
    model, tstate, _ = _port(ref)
    eng = ServeEngine(model, tstate["params"], max_batch=4, max_seq=32,
                      eos_id=-1)
    assert _cache_batch_axes(model, 32) == {"k": 1, "v": 1, "xk": 1,
                                            "xv": 1, "pos": 0}
    reqs = _requests(Request, np.random.default_rng(3), lens)
    sig = (("frames", (8, 64), "<f4"),)
    assert [eng._group_key(r) for r in reqs[:2]] == [("exact", 5, sig),
                                                     ("exact", 7, sig)]
    for r in reqs:
        eng.submit(r)
    got = {c.uid: c.tokens for c in eng.run()}
    assert got == want and len(got) == len(lens)
    assert len({tuple(t) for t in got.values()}) > 1


def test_serving_refusals_that_stay(ref):
    """As in the reference: no paged engine (the cross cache has no
    per-position pages), no speculation, no padded prefill."""
    model, tstate, _ = _port(ref)
    params = tstate["params"]
    assert not model.supports_paged_cache()
    assert not model.supports_speculative()
    assert not model.supports_padded_prefill()
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, params, engine="paged")
    with pytest.raises(ValueError, match="speculative"):
        ServeEngine(model, params, spec_k=2)
    tokens = torch.ones((1, 4), dtype=torch.int32)
    frames = torch.zeros((1, 8, 64))
    with pytest.raises(ValueError, match="lens"):
        model.prefill(params, tokens, {"frames": frames},
                      lens=torch.tensor([4]))
    with pytest.raises(ValueError, match="encoder-decoder"):
        model.verify_step(params, model.init_cache(1, 8), tokens)


def test_input_specs_name_the_frames():
    model = build_model(_cfg(), device="cpu")
    specs = model.input_specs(ShapeConfig("t", 12, 3, "train"))
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "tokens": (3, 12), "frames": (3, 8, 64)}
    assert all(v.device.type == "meta" for v in specs.values())
    dec = model.input_specs(ShapeConfig("d", 16, 2, "decode"))
    assert tuple(dec["cache"]["xk"].shape) == (2, 2, 8, 2, 16)


def test_template_runs_like_the_reference(tmp_path):
    """``train-whisper-large-v3`` at its reduced scale through both
    packages' ``run_workflow`` from the same (bridged) initial state:
    the same losses (bf16 compute, rtol 1e-4) and the same checks."""

    def bridged(model, seed, opt_cfg, rt_plan):
        jcfg = jreduced(jget_config(ARCH))
        js = jinit_train_state(jbuild_model(jcfg), jax.random.PRNGKey(seed),
                               JOptimizerConfig(**dataclasses.asdict(opt_cfg)))
        return from_jax_train_state(jax.tree.map(np.asarray, js), model.cfg,
                                    model.device)

    name = f"train-{ARCH}"
    want = jrun_workflow(JREGISTRY.get(name), JStore(f"{tmp_path}/ref"),
                         steps_override=6)
    with mock.patch.object(stages, "init_train_state_for", bridged):
        got = run_workflow(REGISTRY.get(name),
                           ProvenanceStore(f"{tmp_path}/port"),
                           steps_override=6, device="cpu")
    assert got.ok and want.ok
    assert {k: v[0] for k, v in got.checks.items()} \
        == {k: v[0] for k, v in want.checks.items()}
    losses = [np.array([r["loss"] for r in res.record.metrics()
                        if "loss" in r]) for res in (want, got)]
    assert len(losses[1]) == 6
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def test_train_cli_runs_reduced_whisper(tmp_path, capsys):
    argv = ["train", "--arch", "whisper", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "16", "--remat", "full",
            "--runs-dir", str(tmp_path)]
    with mock.patch("sys.argv", argv):
        train_cli.main()
    out = capsys.readouterr().out
    assert "step 2 loss=" in out and "steps=3" in out
    assert np.isfinite(float(out.split("step 2 loss=")[1].split()[0]))
