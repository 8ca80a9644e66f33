"""Serving parity, PyTorch port vs the JAX reference, on the CPU.

On bridged weights (reduced qwen2-1.5b in float32, biases and gains
randomized), the port's ``ServeEngine`` gives exactly the reference
engine's greedy tokens — fused and paged, one token or four per host
transfer — on the serving bench's own workload
(``benchmarks/serve_bench.py``: 32 requests of 8 prompt tokens and 32
new tokens, 16 slots, pages of 16).  The paged engine reproduces the
bench's hardware-independent contracts: prefix hit rate 0.9375 (60/64)
on the shared-prefix burst with no page left in use after the drain,
and 6.0x fewer KV bytes per live token than the dense engine at 50%
slot occupancy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine, smoke_serve
from test_torch_model import jax_params_randomized, one_torch_thread  # noqa: F401

# benchmarks/serve_bench.py
MAX_BATCH = 16
REQUESTS = 32
PROMPT_LEN = 8
MAX_NEW = 32
PAGE_SIZE = 16
MAX_SEQ = PROMPT_LEN + MAX_NEW + 8


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("qwen2-1.5b"), dtype="float32")
    tcfg = reduced(get_config("qwen2-1.5b"), dtype="float32")
    np_params = jax_params_randomized(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = build_model(tcfg, device="cpu")
    tparams = from_jax_params(np_params, tcfg, device="cpu")
    return jbuild_model(jcfg), jparams, model, tparams


def _burst(request_cls):
    rng = np.random.default_rng(0)
    return [request_cls(uid=i, prompt=rng.integers(1, 256, PROMPT_LEN),
                        max_new_tokens=MAX_NEW) for i in range(REQUESTS)]


def _tokens(done):
    return {c.uid: tuple(c.tokens) for c in done}


@pytest.fixture(scope="module")
def jax_tokens(setup):
    """The reference engine's greedy tokens on the bench burst."""
    jmodel, jparams, _, _ = setup
    eng = JServeEngine(jmodel, jparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                       eos_id=-1, engine="fused")
    for r in _burst(JRequest):
        eng.submit(r)
    return _tokens(eng.run())


@pytest.mark.parametrize("engine,chunk", [("fused", 1), ("fused", 4),
                                          ("paged", 1), ("paged", 4)])
def test_greedy_tokens_match_reference_engine(setup, jax_tokens, engine, chunk):
    _, _, model, tparams = setup
    eng = ServeEngine(model, tparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                      eos_id=-1, engine=engine, decode_chunk=chunk,
                      page_size=PAGE_SIZE)
    for r in _burst(Request):
        eng.submit(r)
    got = _tokens(eng.run())
    assert len(got) == REQUESTS
    assert all(len(t) == MAX_NEW for t in got.values())
    assert got == jax_tokens
    if engine == "paged":
        assert eng.pool.pages_in_use == 0
    # one (B,) token row per decode step (or per chunk): never logits
    assert eng.d2h_elems == eng.d2h_transfers * MAX_BATCH * chunk


def test_prefix_sharing_hit_rate_and_no_leak(setup):
    """Every request extends one common two-page prompt: the first request
    of each admission wave misses both pages, the rest hit — 60/64."""
    _, _, model, tparams = setup
    eng = ServeEngine(model, tparams, max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                      eos_id=-1, engine="paged", page_size=PAGE_SIZE)
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, 256, 2 * PAGE_SIZE)
    for i in range(REQUESTS):
        eng.submit(Request(
            uid=i, prompt=np.concatenate([prefix, rng.integers(1, 256, 4)]),
            max_new_tokens=8))
    done = eng.run()
    assert len(done) == REQUESTS
    assert (eng.pool.prefix_hits, eng.pool.prefix_lookups) == (60, 64)
    assert eng.pool.hit_rate == 0.9375
    assert eng.pool.pages_in_use == 0


def test_paged_kv_bytes_ratio_at_half_occupancy(setup):
    _, _, model, tparams = setup
    stats = {}
    for engine in ("fused", "paged"):
        eng = ServeEngine(model, tparams, max_batch=MAX_BATCH,
                          max_seq=MAX_SEQ, eos_id=-1, engine=engine,
                          page_size=PAGE_SIZE)
        rng = np.random.default_rng(0)
        for i in range(MAX_BATCH // 2):
            eng.submit(Request(uid=i, prompt=rng.integers(1, 256, PROMPT_LEN),
                               max_new_tokens=PAGE_SIZE - PROMPT_LEN))
        eng.step()
        stats[engine] = eng.kv_stats()
    ratio = (stats["fused"]["kv_bytes_per_live_token"]
             / stats["paged"]["kv_bytes_per_live_token"])
    assert ratio == pytest.approx(6.0, abs=1e-12)


def test_smoke_serve_and_temperature_streams(setup):
    """smoke_serve answers every request; a temperature run is
    reproducible from its seed and differs from greedy."""
    _, _, model, tparams = setup
    kw = dict(num_requests=6, vocab_size=256, max_batch=4, max_seq=32,
              prompt_len=5, max_new_tokens=6, page_size=8)
    done, stats = smoke_serve(model, tparams, engine="paged", **kw)
    assert stats["requests"] == 6 and stats["pages_in_use"] == 0
    assert stats["tokens"] == sum(len(c.tokens) for c in done)
    hot = [_tokens(smoke_serve(model, tparams, temperature=1.5, seed=7,
                               **kw)[0]) for _ in range(2)]
    greedy = _tokens(smoke_serve(model, tparams, seed=7, **kw)[0])
    assert hot[0] == hot[1] and hot[0] != greedy


def test_unported_paths_raise(setup):
    _, _, model, tparams = setup
    with pytest.raises(NotImplementedError, match="legacy"):
        ServeEngine(model, tparams, engine="legacy")
    # speculative decoding is ported: the engine builds on both engines
    for engine in ("fused", "paged"):
        eng = ServeEngine(model, tparams, spec_k=2, engine=engine)
        assert eng.spec_k == 2 and eng.hist.shape == (8, 256)
    # whisper is built by the port; the paged engine refuses its cross
    # cache, as the reference's does
    whisper = build_model(reduced(get_config("whisper")), device="cpu")
    assert whisper.cfg.name == "whisper-large-v3-smoke"
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(whisper, whisper.init(seed=0), engine="paged")
    # the MoE decoders train in the port; their serving raises
    moe = build_model(reduced(get_config("qwen3-moe")), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE serving"):
        ServeEngine(moe, moe.init(seed=0))
    eng = ServeEngine(model, tparams, max_batch=2, max_seq=16, engine="paged",
                      page_size=8)
    with pytest.raises(ValueError, match="KV pages"):
        eng.submit(Request(uid=0, prompt=np.ones(10, np.int32),
                           max_new_tokens=10))
    assert torch.all(eng.cache["page_table"] == -1)
