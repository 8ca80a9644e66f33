"""Speculative decoding, PyTorch port vs the JAX reference, on the CPU.

The proposer, the history buffer and the greedy acceptance rule must give
exactly the reference's outputs on the same numpy inputs.  The rejection
sampler draws other bits than the reference (PyTorch generators, not
``fold_in``), so it is held to the target law with the reference's own
total-variation limits (``tests/test_speculative.py``: 0.03 for the first
emitted token, 0.05 for the second given the first draft survived).

The engine's greedy tokens on bridged weights (reduced qwen2-1.5b in
float32, biases and gains randomized) equal the reference engine's for
the fused and paged engines at ``spec_k`` 0, 2 and 4 with the n-gram
proposer, and with a reduced qwen1.5-4b draft model.  The reference's
own suite holds its speculative tokens equal to its ``spec_k = 0``
tokens, so one reference run is the oracle for every case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import speculate as jspec
from repro.serve.engine import smoke_serve as jsmoke_serve
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, speculate
from repro_torch.serve import Request, ServeEngine, smoke_serve
from test_torch_model import jax_params_randomized, one_torch_thread  # noqa: F401

# the workload of the reference's speculative engine tests, with a longer
# budget so that rounds accept and reject
SMOKE = dict(num_requests=6, max_batch=3, max_seq=64, vocab_size=256,
             prompt_len=8, max_new_tokens=12)


def _tv(counts, probs):
    return 0.5 * np.abs(counts / counts.sum() - probs).sum()


# ===========================================================================
# proposer and history: exact against the reference
# ===========================================================================
def test_ngram_propose_matches_reference():
    rng = np.random.default_rng(0)
    cap, n, k = 24, 3, 4
    # a small alphabet makes matches common; rows of every length, the
    # short ones (below n + 1) included
    hist = rng.integers(1, 4, (16, cap)).astype(np.int32)
    hist[0, :8] = [7, 8, 9, 4, 5, 7, 8, 9]
    lens = np.concatenate([[8], rng.integers(0, cap + 1, 15)]).astype(np.int32)
    for b, ln in enumerate(lens):
        hist[b, ln:] = 0
    for nn in (1, n):
        want = np.asarray(jspec.ngram_propose(
            jnp.asarray(hist), jnp.asarray(lens), k=k, n=nn))
        got = speculate.ngram_propose(torch.from_numpy(hist),
                                      torch.from_numpy(lens), k=k, n=nn)
        np.testing.assert_array_equal(got.numpy(), want)
    assert list(got[0].numpy()) == [4, 5, 7, 8]


def test_update_history_matches_reference():
    rng = np.random.default_rng(1)
    B, cap, K = 6, 10, 4
    hist = rng.integers(1, 50, (B, cap)).astype(np.int32)
    pos = np.asarray([0, 3, 7, 9, 5, 2], np.int32)  # near the end: clamped
    emitted = rng.integers(50, 99, (B, K)).astype(np.int32)
    m = np.asarray([4, 2, 3, 1, 0, 4], np.int32)
    active = np.asarray([True, True, True, True, True, False])
    want = np.asarray(jspec.update_history(
        jnp.asarray(hist), jnp.asarray(pos), jnp.asarray(emitted),
        jnp.asarray(m), jnp.asarray(active)))
    got = speculate.update_history(
        torch.from_numpy(hist.copy()), torch.from_numpy(pos),
        torch.from_numpy(emitted), torch.from_numpy(m),
        torch.from_numpy(active))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bonus", [True, False])
def test_greedy_accept_and_emit_matches_reference(bonus):
    rng = np.random.default_rng(2)
    B, k, V = 64, 4, 11
    logits = rng.normal(size=(B, k + 1, V)).astype(np.float32)
    tgt = logits.argmax(-1)
    # drafts agree with the target for a random prefix, then diverge
    drafts = tgt[:, :k].copy().astype(np.int32)
    cut = rng.integers(0, k + 1, B)
    for b in range(B):
        if cut[b] < k:
            drafts[b, cut[b]] = (tgt[b, cut[b]] + 1) % V
    q = rng.dirichlet(np.ones(V), (B, k)).astype(np.float32)
    want = jspec.accept_and_emit(
        jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(q),
        jnp.zeros(B), jax.random.PRNGKey(0), jnp.arange(B),
        jnp.zeros(B, jnp.int32), bonus=bonus)
    for q_probs, greedy_only in ((torch.from_numpy(q), False), (None, True)):
        got = speculate.accept_and_emit(
            torch.from_numpy(logits), torch.from_numpy(drafts), q_probs,
            np.zeros(B, np.float32), seed=0, slots=range(B),
            pos0=torch.zeros(B, dtype=torch.int32), bonus=bonus,
            greedy_only=greedy_only)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ===========================================================================
# rejection sampler: the target law, with the reference's TV limits
# ===========================================================================
def _spec_round(N, V, k, temp, seed, *, delta):
    """One verify round over N slots sharing the same target and draft
    distributions; returns (emitted, accepted, p)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 1.5, (k + 1, V)).astype(np.float32)
    p = torch.softmax(torch.from_numpy(logits) / temp, dim=-1).numpy()
    if delta:
        drafts = np.broadcast_to(rng.integers(0, V, k), (N, k))
        q = None
    else:
        qn = np.exp(rng.normal(0, 1.0, (k, V)))
        qn /= qn.sum(-1, keepdims=True)
        drafts = np.stack([rng.choice(V, N, p=qn[j]) for j in range(k)], 1)
        q = torch.from_numpy(qn.astype(np.float32)).expand(N, k, V)
    emitted, _, acc = speculate.accept_and_emit(
        torch.from_numpy(logits).expand(N, k + 1, V),
        torch.from_numpy(np.ascontiguousarray(drafts, np.int32)), q,
        np.full(N, temp, np.float32), seed=seed + 99, slots=range(N),
        pos0=torch.zeros(N, dtype=torch.int32), bonus=delta)
    return emitted.numpy(), acc.numpy(), p


@pytest.mark.parametrize("delta", [False, True], ids=["model-q", "delta-q"])
def test_rejection_sampler_matches_target(delta):
    N, V, k = 20000, 8, 3
    emitted, acc, p = _spec_round(N, V, k, 0.9, seed=5 if delta else 3,
                                  delta=delta)
    assert _tv(np.bincount(emitted[:, 0], minlength=V), p[0]) < 0.03
    if not delta:
        sub = emitted[acc >= 1, 1]
        assert sub.size > 2000
        assert _tv(np.bincount(sub, minlength=V), p[1]) < 0.05


# ===========================================================================
# engine: greedy tokens against the reference engine
# ===========================================================================
@pytest.fixture(scope="module")
def setup():
    """Bridged target (reduced qwen2-1.5b) and draft (reduced qwen1.5-4b,
    its own init) in float32, and the reference engine's greedy tokens
    on the smoke workload."""
    out = {}
    for name, arch, seed in (("target", "qwen2-1.5b", 0),
                             ("draft", "qwen1.5-4b", 7)):
        jcfg = jreduced(jget_config(arch), dtype="float32")
        tcfg = reduced(get_config(arch), dtype="float32")
        np_params = jax_params_randomized(jcfg, seed)
        out[name] = (jbuild_model(jcfg), jax.tree.map(jnp.asarray, np_params),
                     build_model(tcfg, device="cpu"),
                     from_jax_params(np_params, tcfg, device="cpu"))
    jmodel, jparams, _, _ = out["target"]
    done, _ = jsmoke_serve(jmodel, jparams, engine="fused", decode_chunk=2,
                           **SMOKE)
    out["jax_tokens"] = _tokens(done)
    return out


def _tokens(done):
    return {c.uid: tuple(c.tokens) for c in done}


@pytest.mark.parametrize("engine", ["fused", "paged"])
@pytest.mark.parametrize("spec_k", [0, 2, 4])
def test_greedy_tokens_match_reference_engine(setup, engine, spec_k):
    _, _, model, tparams = setup["target"]
    done, stats = smoke_serve(model, tparams, engine=engine, decode_chunk=2,
                              spec_k=spec_k, **SMOKE)
    assert _tokens(done) == setup["jax_tokens"]
    if spec_k:
        # the n-gram proposer drafts something the target keeps
        assert 0 < stats["spec_accept_rate"] <= 1
        assert stats["spec_tokens_per_round"] > 1
    if engine == "paged":
        assert stats["pages_in_use"] == 0


@pytest.mark.parametrize("engine", ["fused", "paged"])
def test_draft_model_greedy_tokens_match_reference_engine(setup, engine):
    _, _, model, tparams = setup["target"]
    _, _, draft, dparams = setup["draft"]
    done, stats = smoke_serve(model, tparams, engine=engine, decode_chunk=2,
                              spec_k=2, draft=draft, draft_params=dparams,
                              **SMOKE)
    assert _tokens(done) == setup["jax_tokens"]
    assert 0 <= stats["spec_accept_rate"] <= 1


def test_draft_model_proposes_what_the_reference_draft_proposes(setup):
    """The draft path's proposals themselves: the same draft weights in
    both packages, prefilled on the same prompts, draft the same greedy
    tokens (the engines' outputs alone would not show a wrong draft)."""
    jdraft, jdparams, draft, dparams = setup["draft"]
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 256, (3, 8)).astype(np.int32)
    jlog, jc = jax.jit(jdraft.prefill, static_argnames=("max_seq",))(
        jdparams, jnp.asarray(tokens), max_seq=16)
    tlog, tc = draft.prefill(draft.serving_params(dparams),
                             torch.from_numpy(tokens), max_seq=16)
    eng = ServeEngine(setup["target"][2], setup["target"][3], max_batch=3,
                      max_seq=16, spec_k=4, draft=draft, draft_params=dparams)
    eng._draft_cache = tc
    eng.temps[:] = 0
    last = tlog.argmax(-1).to(torch.int32)
    got, q = eng._draft_propose(last, tc["pos"].clone(), greedy_only=True)
    assert q is None
    want, cur = [], jnp.asarray(np.asarray(jlog).argmax(-1), jnp.int32)
    jstep = jax.jit(jdraft.decode_step)
    for _ in range(4):
        lg, jc = jstep(jdparams, jc, cur[:, None])
        cur = jnp.argmax(lg, -1).astype(jnp.int32)
        want.append(np.asarray(cur))
    np.testing.assert_array_equal(got.numpy(), np.stack(want, 1))
    np.testing.assert_array_equal(last.numpy(),
                                  np.asarray(jlog).argmax(-1))


# ===========================================================================
# engine contracts
# ===========================================================================
def test_paged_spec_no_page_leak_and_counters(setup):
    _, _, model, tparams = setup["target"]
    eng = ServeEngine(model, tparams, max_batch=3, max_seq=64,
                      engine="paged", page_size=16, spec_k=4)
    rng = np.random.default_rng(2)
    for i in range(5):
        eng.submit(Request(uid=i, prompt=rng.integers(1, 256, 8),
                           max_new_tokens=10))
    done = eng.run()
    assert len(done) == 5
    stats = eng.kv_stats()
    assert stats["pages_in_use"] == 0
    assert stats["spec_rounds"] > 0
    # each request's first token comes from admission, the rest from rounds
    assert stats["spec_tokens"] == sum(len(c.tokens) for c in done) - len(done)
    assert 0.0 <= stats["spec_accept_rate"] <= 1.0
    assert stats["spec_proposed"] == 4 * stats["spec_rounds"]
    assert stats["spec_tokens_per_round"] == (stats["spec_tokens"]
                                              / stats["spec_rounds"])


@pytest.mark.parametrize("engine", ["fused", "paged"])
def test_submit_margin_includes_spec_k(setup, engine):
    """A verify pass entered one token before the budget writes spec_k
    rows past it: submit reserves them."""
    _, _, model, tparams = setup["target"]
    eng = ServeEngine(model, tparams, max_batch=2, max_seq=32, spec_k=4,
                      engine=engine, page_size=8)
    prompt = np.arange(1, 9, dtype=np.int32)
    with pytest.raises(ValueError, match="spec_k"):
        eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=25))
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=21))  # fits
    plain = ServeEngine(model, tparams, max_batch=2, max_seq=32,
                        engine=engine, page_size=8)
    plain.submit(Request(uid=0, prompt=prompt, max_new_tokens=25))


def test_spec_validation_errors(setup):
    _, _, model, tparams = setup["target"]
    _, _, draft, dparams = setup["draft"]
    kw = dict(max_batch=2, max_seq=64)
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        ServeEngine(model, tparams, spec_k=-1, **kw)
    with pytest.raises(ValueError, match="requires spec_k"):
        ServeEngine(model, tparams, draft=draft, draft_params=dparams, **kw)
    with pytest.raises(ValueError, match="draft_params"):
        ServeEngine(model, tparams, spec_k=2, draft=draft, **kw)
    with pytest.raises(ValueError, match="spec_ngram_n"):
        ServeEngine(model, tparams, spec_k=2, spec_ngram_n=0, **kw)
    bad = build_model(reduced(get_config("qwen2-1.5b"), vocab_size=128),
                      device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(model, tparams, spec_k=2, draft=bad,
                    draft_params=bad.init(1), **kw)
    with pytest.raises(ValueError, match="requires the fused or paged"):
        ServeEngine(model, tparams, engine="legacy", spec_k=2, **kw)


def test_parked_slot_past_the_cache_end_matches_reference(setup):
    """A slot that retires early keeps decoding (dead work) while another
    runs on; its position passes the dense cache's end, where the
    reference drops the write.  The port's write must not fault and the
    live slot's tokens must equal the reference's."""
    jmodel, jparams, model, tparams = setup["target"]
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    reqs = [(0, np.arange(1, 13, dtype=np.int32), 2),   # plen 12: retires
            (1, np.arange(20, 24, dtype=np.int32), 13)]  # plen 4: runs on
    out = {}
    for name, cls, rcls, params, mdl in (
            ("jax", JServeEngine, JRequest, jparams, jmodel),
            ("torch", ServeEngine, Request, tparams, model)):
        eng = cls(mdl, params, max_batch=2, max_seq=16, eos_id=-1)
        for uid, prompt, new in reqs:
            eng.submit(rcls(uid=uid, prompt=prompt, max_new_tokens=new))
        out[name] = _tokens(eng.run())
    assert out["torch"] == out["jax"]
    assert len(out["torch"][1]) == 13


def test_temperature_distribution_parity():
    """Lossless at temperature, statistically: pooled token histograms
    with and without speculation agree (same prompts, many seeds) on a
    32-token vocabulary, under the reference's limit."""
    cfg = reduced(get_config("qwen2-1.5b"), vocab_size=32)
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    pooled = []
    for spec_k in (0, 3):
        eng = ServeEngine(model, params, max_batch=4, max_seq=64,
                          engine="fused", decode_chunk=2, spec_k=spec_k)
        toks, prev = [], 0
        for seed in range(8):
            eng.seed = seed
            rng = np.random.default_rng(12)  # the same prompts every seed
            for i in range(4):
                eng.submit(Request(uid=seed * 100 + i,
                                   prompt=rng.integers(1, 32, 8),
                                   max_new_tokens=12, temperature=0.8))
            done = eng.run()
            for c in done[prev:]:
                toks.extend(c.tokens)
            prev = len(done)
        pooled.append(np.asarray(toks))
    t0, t1 = pooled
    assert min(t0.size, t1.size) > 200
    h0 = np.bincount(t0, minlength=32)
    h1 = np.bincount(t1, minlength=32)
    tv = 0.5 * np.abs(h0 / h0.sum() - h1 / h1.sum()).sum()
    assert tv < 0.25, f"spec vs plain pooled TV {tv:.3f}"
