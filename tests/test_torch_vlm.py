"""The port's phi-3-vision-4.2b (the VLM: the dense decoder with an
image-embedding prefix) against the reference, on the CPU.

``reduced(phi-3-vision-4.2b)`` (2 layers, d_model 64, 4/2 heads of 16,
4 stub image embeddings, vocab 256) in float32, with the reference's
weights bridged through numpy.  The reference runs its default ``ref``
kernel backend, the port runs on CPU tensors (the kernels' plain
versions).  Tolerances, each with its reason:

  * the config's ``param_count`` and the parameter tree: exact;
  * the embedding with its image overlay: exact (a copy);
  * the logits, prefill (plain and padded) and two decode steps: 2e-5
    (float32: the same products summed in other orders);
  * the masked loss: rtol 1e-5; every gradient leaf within 2e-5 of that
    leaf's max |g|;
  * the 5-step loss curve of the train step: rtol 1e-4 at every step;
    resume: bit-identical;
  * the engines' greedy tokens, and the template's checks: identical; the
    template's losses (bf16 compute): rtol 1e-4.

Speculation (n-gram and a draft model, fused and paged): greedy tokens
identical to the reference engine's and to the port's without it.

The reference's paged engine shares prompt pages by the prompt's tokens
alone, so a request whose tokens equal another's but whose image differs
decodes against the other's image pages; the port folds the image's
bytes into the sharing key (a difference by design, ROADMAP §3).
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
from repro.models import lm as jlm
from repro.parallel.sharding import Plan as JPlan
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import OptimizerConfig as JOptimizerConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import jit_train_step, make_train_step as jmake_train_step
from repro_torch.bridge import from_jax_train_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import REGISTRY, ProvenanceStore, run_workflow, stages
from repro_torch.launch import train as train_cli
from repro_torch.models import build_model, lm
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import OptimizerConfig, Plan, make_train_step
from repro_torch.tree import flatten

ARCH = "phi-3-vision-4.2b"
BATCH, SEQ, STEPS, N_IMG = 2, 12, 5, 4
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
    """The reference's reduced phi-3-vision (float32): its train state and
    step, and its stream (tokens and image embeddings)."""

    def __init__(self):
        self.cfg = jreduced(jget_config(ARCH), dtype="float32")
        self.model = jbuild_model(self.cfg)
        self.opt = JOptimizerConfig(**OPT)
        self.state = jax.jit(lambda key: jinit_train_state(
            self.model, key, self.opt))(jax.random.PRNGKey(0))
        self.step = jit_train_step(jmake_train_step(
            self.model, self.opt, JPlan(remat="none")), donate=False)
        self.stream = jmake_stream(self.cfg, JShapeConfig(
            "t", SEQ, BATCH, "train"), JDataConfig(seed=0, vocab_size=256))

    @property
    def params(self):
        return self.state["params"]

    def np_state(self, state=None):
        return jax.tree.map(np.asarray, self.state if state is None else state)

    def batch(self, step):
        """The stream's batch, image embeddings scaled to the token
        embeddings' size."""
        raw = self.stream.batch_at(step)
        return {"tokens": raw["tokens"],
                "image_embeds": raw["image_embeds"] * 5.0}


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


def test_config_and_parameter_tree_match_reference(ref):
    full, jfull = get_config("phi3-vision"), jget_config(ARCH)
    assert full == get_config(ARCH) and full.family == "vlm"
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count() == 3_821_079_552
    assert (full.head_dim, full.num_image_tokens) == (96, 576)
    want = {k: v.shape for k, v in flatten(ref.np_state()["params"])}
    got = {k: tuple(v.shape)
           for k, v in flatten(build_model(_cfg(), "cpu").init(seed=0))}
    assert got == want
    shapes = lm.param_shapes(full)
    assert shapes["blocks/attn_wq"][0] == (32, 3072, 32, 96)
    assert shapes["lm_head"][0] == (3072, 32064)


def test_image_overlay_matches_reference(ref):
    """The first ``num_image_tokens`` positions take the image embeddings
    (the reference's ``test_vlm_image_overlay`` and more): the same
    embedding as the reference's, no overlay on a sequence shorter than
    the image, and the image moves the loss."""
    batch = ref.batch(0)
    _, tstate, _ = _port(ref)
    params, cfg = tstate["params"], _cfg()
    for S in (SEQ, N_IMG, N_IMG - 1):
        tokens = batch["tokens"][:, :S]
        want = jlm.embed_tokens(ref.params, ref.cfg, jnp.asarray(tokens),
                                _jbatch(batch))
        got = lm.embed_tokens(params, cfg, torch.from_numpy(tokens),
                              _tbatch(batch))
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    got = lm.embed_tokens(params, cfg, torch.from_numpy(batch["tokens"]),
                          _tbatch(batch))
    np.testing.assert_array_equal(_np(got[:, :N_IMG]), batch["image_embeds"])
    model = build_model(cfg, device="cpu")
    with torch.no_grad():
        base = float(model.loss(params, _tbatch(batch))[0])
        moved = dict(batch, image_embeds=batch["image_embeds"] + 1.0)
        assert float(model.loss(params, _tbatch(moved))[0]) != base


def test_loss_mask_and_gradients_match_reference(ref):
    """The masked loss (the predictions at positions < n_img - 1 left
    out), its metrics and every gradient leaf against
    ``jax.value_and_grad``; the masked targets do not move the loss."""
    batch = ref.batch(0)
    (jl, jmetrics), jg = jax.jit(jax.value_and_grad(
        lambda p: ref.model.loss(p, _jbatch(batch)), has_aux=True))(ref.params)
    model, tstate, _ = _port(ref)
    params = tstate["params"]
    leaves = [p.requires_grad_() for _, p in flatten(params)]
    tl, tmetrics = model.loss(params, _tbatch(batch))
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5)
    for name in ("loss", "ce", "aux", "tokens"):
        np.testing.assert_allclose(_np(tmetrics[name]), _np(jmetrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    assert float(tmetrics["tokens"]) == BATCH * (SEQ - N_IMG)
    for (key, want), got in zip(flatten(jax.tree.map(np.asarray, jg)), tg):
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, atol=TOL * scale, rtol=0,
                                   err_msg=key)
    # the targets at positions 1 .. n_img - 2 are never predicted
    flipped = dict(batch, tokens=batch["tokens"].copy())
    flipped["tokens"][:, 1:N_IMG - 1] = 7
    with torch.no_grad():
        again = float(model.loss(params, _tbatch(flipped))[0])
    assert again == pytest.approx(float(tl.detach()), rel=1e-6)


def test_prefill_and_decode_with_images_match_reference(ref):
    """Prefill with the image embeddings (whole rows, then a padded batch
    with per-row ``lens``) and two decode steps, against the reference."""
    batch = ref.batch(1)
    tokens, img = batch["tokens"], batch["image_embeds"]
    model, tstate, _ = _port(ref)
    params = model.serving_params(tstate["params"])
    extra_j, extra_t = {"image_embeds": jnp.asarray(img)}, \
        {"image_embeds": torch.from_numpy(img)}
    lens = np.array([10, 7], np.int32)
    for row_lens in (None, lens):
        S = 10
        jl, jc = ref.model.prefill(
            ref.params, jnp.asarray(tokens[:, :S]), extra_j, max_seq=16,
            lens=None if row_lens is None else jnp.asarray(row_lens))
        with torch.no_grad():
            tl, tc = model.prefill(
                params, torch.from_numpy(tokens[:, :S]), extra_t, max_seq=16,
                lens=None if row_lens is None else torch.from_numpy(row_lens))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
        for t in (S, S + 1):
            nt = tokens[:, t:t + 1]
            jl, jc = ref.model.decode_step(ref.params, jc, jnp.asarray(nt))
            with torch.no_grad():
                tl, tc = model.decode_step(params, tc, torch.from_numpy(nt))
            np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL,
                                       rtol=TOL)


def test_loss_curve_and_resume_match_reference(ref, tmp_path):
    """5 steps within rtol 1e-4 of the reference's; then the state after
    2 steps saved and restored resumes bit for bit."""
    _, tstate, tstep = _port(ref)
    jstate = ref.state
    states = []
    for i in range(STEPS):
        jstate, jm = ref.step(jstate, _jbatch(ref.batch(i)))
        tstate, tm = tstep(tstate, _tbatch(ref.batch(i)))
        states.append({k: v for k, v in flatten(tstate)})
        for name in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(_np(tm[name]), _np(jm[name]),
                                       rtol=1e-4, err_msg=f"{name} step {i}")
    _, state, step = _port(ref)
    for i in range(2):
        state, _ = step(state, _tbatch(ref.batch(i)))
    ck = Checkpointer(str(tmp_path), keep=1)
    ck.save(1, state)
    state, saved = ck.restore(_port(ref)[1])
    assert saved == 1
    for i in range(2, STEPS):
        state, _ = step(state, _tbatch(ref.batch(i)))
    for key, x in flatten(state):
        assert torch.equal(x, states[-1][key]), key


def _requests(request_cls, prompts, images, max_new=6):
    return [request_cls(uid=i, prompt=p, max_new_tokens=max_new,
                        extra={"image_embeds": img})
            for i, (p, img) in enumerate(zip(prompts, images))]


def _image(rng):
    return (5.0 * rng.standard_normal((N_IMG, 64))).astype(np.float32)


@pytest.fixture(scope="module")
def burst():
    rng = np.random.default_rng(4)
    lens = [5, 7, 12, 9, 20, 5, 17]
    return ([rng.integers(1, 256, n).astype(np.int32) for n in lens],
            [_image(rng) for _ in lens])


def _run(engine_cls, request_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, max_batch=4, max_seq=40, eos_id=-1,
                     page_size=4, **kw)
    for r in reqs:
        eng.submit(r)
    return {c.uid: c.tokens for c in eng.run()}, eng


@pytest.mark.parametrize("engine", ["fused", "paged"])
def test_engine_tokens_match_reference(ref, burst, engine):
    """Image requests of mixed prompt lengths, admitted in padded groups
    keyed by the image's shape: greedy tokens identical to the reference
    engine's."""
    want, _ = _run(JServeEngine, JRequest, ref.model, ref.params,
                   _requests(JRequest, *burst), engine=engine)
    model, tstate, _ = _port(ref)
    got, eng = _run(ServeEngine, Request, model, tstate["params"],
                    _requests(Request, *burst), engine=engine)
    assert got == want and len(got) == len(burst[0])
    key = eng._group_key(_requests(Request, *burst)[0])
    assert key == ("pad", 8, (("image_embeds", (N_IMG, 64), "<f4"),))
    if engine == "paged":
        assert eng.pool.pages_in_use == 0


def test_paged_prefix_sharing_keeps_images_apart(ref):
    """Two requests with the same 12 tokens: with different images each
    gets its own run's tokens (no page shared); with the same image they
    share the full prompt pages and still decode the same tokens.  The
    reference's paged engine shares the pages in the first case too."""
    rng = np.random.default_rng(5)
    prompt = rng.integers(1, 256, 12).astype(np.int32)
    img_a, img_b = _image(rng), _image(rng)
    model, tstate, _ = _port(ref)
    params = tstate["params"]
    solo = [_run(ServeEngine, Request, model, params,
                 _requests(Request, [prompt], [img]), engine="fused")[0][0]
            for img in (img_a, img_b)]
    assert solo[0] != solo[1]
    got, eng = _run(ServeEngine, Request, model, params,
                    _requests(Request, [prompt] * 2, [img_a, img_b]),
                    engine="paged")
    assert [got[0], got[1]] == solo
    assert eng.pool.prefix_hits == 0
    got, eng = _run(ServeEngine, Request, model, params,
                    _requests(Request, [prompt] * 2, [img_a, img_a]),
                    engine="paged")
    assert [got[0], got[1]] == [solo[0], solo[0]]
    assert eng.pool.prefix_hits == 12 // 4
    want, jeng = _run(JServeEngine, JRequest, ref.model, ref.params,
                      _requests(JRequest, [prompt] * 2, [img_a, img_b]),
                      engine="paged")
    assert jeng.pool.prefix_hits == 12 // 4 and want[1] == want[0] != solo[1]


def _spec_tokens(ref_, burst, engine, draft: bool):
    """``(reference's, port's, port's without speculation)`` tokens of
    the burst at spec_k 3: n-gram drafts, or a reduced phi-3-vision draft
    on the target's weights (prefilled without the images, as the
    reference's ``_admit_draft``)."""
    model, tstate, _ = _port(ref_)
    jkw = tkw = {}
    if draft:
        jkw = dict(draft=ref_.model, draft_params=ref_.params)
        tkw = dict(draft=model, draft_params=tstate["params"])
    want, _ = _run(JServeEngine, JRequest, ref_.model, ref_.params,
                   _requests(JRequest, *burst, max_new=10), engine=engine,
                   spec_k=3, **jkw)
    got, eng = _run(ServeEngine, Request, model, tstate["params"],
                    _requests(Request, *burst, max_new=10), engine=engine,
                    spec_k=3, **tkw)
    plain, _ = _run(ServeEngine, Request, model, tstate["params"],
                    _requests(Request, *burst, max_new=10), engine=engine)
    return want, got, plain, eng


def test_speculation_waits(ref, burst):
    """VLM speculation, refused until the port's verify took image
    requests, now runs: n-gram drafts on the fused and the paged engine
    give the reference engine's greedy tokens (and the port's own without
    speculation); verify steps take no extra input."""
    for engine in ("fused", "paged"):
        want, got, plain, eng = _spec_tokens(ref, burst, engine, False)
        assert got == want == plain and len(got) == len(burst[0])
        assert eng.spec_accepted > 0
        if engine == "paged":
            assert eng.pool.pages_in_use == 0


@pytest.mark.parametrize("engine", ["fused", "paged"])
def test_draft_speculation_matches_reference(ref, burst, engine):
    want, got, plain, eng = _spec_tokens(ref, burst, engine, True)
    assert got == want == plain and len(got) == len(burst[0])
    assert 0 < eng.spec_accepted < eng.spec_proposed


def test_input_specs_name_the_image():
    model = build_model(_cfg(), device="cpu")
    specs = model.input_specs(ShapeConfig("t", 12, 3, "train"))
    assert {k: tuple(v.shape) for k, v in specs.items()} == {
        "tokens": (3, 12), "image_embeds": (3, N_IMG, 64)}


def test_template_runs_like_the_reference(tmp_path):
    """``train-phi-3-vision-4.2b`` at its reduced scale through both
    packages' ``run_workflow`` from the same (bridged) initial state:
    the same losses (bf16 compute, rtol 1e-4) and the same checks."""

    def bridged(model, seed, opt_cfg, rt_plan):
        js = jinit_train_state(jbuild_model(jreduced(jget_config(ARCH))),
                               jax.random.PRNGKey(seed),
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


def test_train_cli_runs_reduced_vlm(tmp_path, capsys):
    argv = ["train", "--arch", "phi3-vision", "--device", "cpu", "--steps",
            "3", "--batch", "2", "--seq", "16", "--runs-dir", str(tmp_path)]
    with mock.patch("sys.argv", argv):
        train_cli.main()
    out = capsys.readouterr().out
    assert "step 2 loss=" in out and "steps=3" in out
    assert np.isfinite(float(out.split("step 2 loss=")[1].split()[0]))
