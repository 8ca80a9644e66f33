"""The legacy engine, and temperature draws, against the reference on the
CPU.

``engine="legacy"`` is the reference's per-slot baseline: one request a
slot prefilled at batch 1, one decode step for all slots whose full
``(B, V)`` logits go to the host, then one host sample a slot.
On bridged weights in float32 its greedy tokens are identical to the
JAX legacy engine's for reduced qwen2-1.5b (ragged prompts, more
requests than slots), reduced phi-3-vision (image requests) and reduced
phi3.5-moe (a family with exact-length prefill), and to the port's own
fused engine on the same requests; each decode step moves ``B * V``
elements to the host.

Temperature draws are not the reference's bits (the fused engine keys a
stream by slot and position, the legacy engine draws from one serial
host generator), so they are held to the reference's law: pooled token
histograms of the port's engine and the JAX engine of the same kind at
temperature 0.8 (a 32-token vocabulary, 8 seeds, 8 requests of 8 tokens
in one admission, the same prompts every seed, 512 draws a side) lie
within total variation 0.25, the limit of the port's speculative-sampling
test. The tied embedding is scaled by ``LOGIT_SCALE`` so that each draw's
law is far from uniform; at init a 32-token law is nearly flat and two
correct samplers differ by about 0.17 from noise alone, as much as a
sampler that ignores the logits. Two controls must exceed the limit: the
port's engine at temperature 1.6, and uniform draws. Measured on the
CPU: sound 0.0957 (fused) and 0.1484 (legacy); temperature 1.6 0.6074
and 0.4961; uniform 0.6934 and 0.6777. Over two other prompt sets the
sound readings stayed at or under 0.1484 and the controls at or over
0.4531. A legacy sampler that ignores the logits read 0.6367 here, and
one that doubles the temperature 0.4961.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine
from test_torch_model import jax_params_randomized, one_torch_thread  # noqa: F401
from test_torch_serve_families import pair
import test_torch_vlm

TV_LIMIT = 0.25
LOGIT_SCALE = 5.0


def _run(engine_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, eos_id=-1, **kw)
    for r in reqs:
        eng.submit(r)
    return {c.uid: list(c.tokens) for c in eng.run()}, eng


@pytest.fixture(scope="module")
def qwen2():
    jcfg = jreduced(jget_config("qwen2-1.5b"), dtype="float32")
    tcfg = reduced(get_config("qwen2-1.5b"), dtype="float32")
    np_params = jax_params_randomized(jcfg)
    return (jbuild_model(jcfg), jax.tree.map(jnp.asarray, np_params),
            build_model(tcfg, device="cpu"),
            from_jax_params(np_params, tcfg, device="cpu"))


def _ragged(cls, n=11, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(1, 256, int(ln)).astype(np.int32),
                max_new_tokens=int(new))
            for i, (ln, new) in enumerate(zip(rng.integers(2, 21, n),
                                              rng.integers(1, 10, n)))]


def test_greedy_tokens_match_reference_and_fused(qwen2):
    jmodel, jparams, model, tparams = qwen2
    kw = dict(max_batch=4, max_seq=32)
    want, _ = _run(JServeEngine, jmodel, jparams, _ragged(JRequest),
                   engine="legacy", **kw)
    got, eng = _run(ServeEngine, model, tparams, _ragged(Request),
                    engine="legacy", **kw)
    fused, _ = _run(ServeEngine, model, tparams, _ragged(Request),
                    engine="fused", **kw)
    assert got == want == fused and len(got) == 11
    assert eng.d2h_transfers > 0
    assert eng.d2h_elems == eng.d2h_transfers * 4 * model.cfg.vocab_size
    assert eng.chunk_steps_total == eng.d2h_transfers


def test_image_requests_match_reference():
    r = test_torch_vlm.Ref()
    model, tstate, _ = test_torch_vlm._port(r)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n in (5, 7, 12, 9, 20)]
    images = [test_torch_vlm._image(rng) for _ in prompts]
    kw = dict(engine="legacy", max_batch=2, max_seq=40)
    want, _ = _run(JServeEngine, r.model, r.params, test_torch_vlm._requests(
        JRequest, prompts, images), **kw)
    got, _ = _run(ServeEngine, model, tstate["params"],
                  test_torch_vlm._requests(Request, prompts, images), **kw)
    assert got == want and len(got) == 5
    # the image decides the tokens
    other, _ = _run(ServeEngine, model, tstate["params"],
                    test_torch_vlm._requests(Request, prompts, images[::-1]),
                    **kw)
    assert other != got


def test_exact_length_family_matches_reference():
    p = pair("phi3.5-moe-42b-a6.6b")
    rng = np.random.default_rng(5)
    lens = [6, 9, 6, 9, 4, 7]

    def reqs(cls):
        return [cls(uid=i, prompt=q, max_new_tokens=6)
                for i, q in enumerate(prompts)]

    prompts = [rng.integers(1, 256, n).astype(np.int32) for n in lens]
    kw = dict(engine="legacy", max_batch=4, max_seq=24)
    want, _ = _run(JServeEngine, p.jmodel, p.jparams, reqs(JRequest), **kw)
    got, _ = _run(ServeEngine, p.model, p.master, reqs(Request), **kw)
    assert got == want and len(got) == len(lens)
    assert len({tuple(t) for t in got.values()}) > 1


def test_the_references_refusals(qwen2):
    _, _, model, tparams = qwen2
    with pytest.raises(ValueError, match="decode_chunk > 1"):
        ServeEngine(model, tparams, engine="legacy", decode_chunk=2)
    with pytest.raises(ValueError, match="fused or paged engine"):
        ServeEngine(model, tparams, engine="legacy", spec_k=2)
    eng = ServeEngine(model, tparams, engine="legacy", max_batch=2,
                      max_seq=16)
    assert eng.pool is None and eng.cache["k"].shape[1:3] == (2, 16)
    assert eng.step_chunk() == 1  # idle: step_chunk falls back to step


def _pooled(engine_cls, request_cls, model, params, engine, temperature):
    """Token histogram over 8 seeds; also each seed's tokens."""
    toks, runs = [], []
    for seed in range(8):
        rng = np.random.default_rng(12)  # the same prompts every seed
        reqs = [request_cls(uid=i, prompt=rng.integers(1, 32, 8),
                            max_new_tokens=8, temperature=temperature)
                for i in range(8)]
        done, _ = _run(engine_cls, model, params, reqs, engine=engine,
                       max_batch=8, max_seq=32, seed=seed)
        runs.append([t for uid in sorted(done) for t in done[uid]])
        toks += runs[-1]
    assert len(toks) == 8 * 8 * 8
    return np.bincount(toks, minlength=32) / len(toks), runs


@pytest.mark.parametrize("engine", ["fused", "legacy"])
def test_temperature_draws_match_reference_law(engine):
    jcfg = jreduced(jget_config("qwen2-1.5b"), dtype="float32", vocab_size=32)
    tcfg = reduced(get_config("qwen2-1.5b"), dtype="float32", vocab_size=32)
    assert jcfg.tie_embeddings
    np_params = jax_params_randomized(jcfg)
    np_params["embed"] = np_params["embed"] * LOGIT_SCALE
    model = build_model(tcfg, device="cpu")
    tparams = from_jax_params(np_params, tcfg, device="cpu")
    want, _ = _pooled(JServeEngine, JRequest, jbuild_model(jcfg),
                      jax.tree.map(jnp.asarray, np_params), engine, 0.8)
    got, runs = _pooled(ServeEngine, Request, model, tparams, engine, 0.8)
    hot, _ = _pooled(ServeEngine, Request, model, tparams, engine, 1.6)

    def tv(p):
        return 0.5 * np.abs(want - p).sum()

    assert len({tuple(r) for r in runs}) > 1  # random, not a greedy run
    assert tv(got) < TV_LIMIT, tv(got)
    # the controls: a wrong temperature, and draws that ignore the logits
    assert tv(hot) > TV_LIMIT, tv(hot)
    assert tv(np.full(32, 1 / 32)) > TV_LIMIT
