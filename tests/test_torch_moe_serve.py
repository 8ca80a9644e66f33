"""MoE serving: the port's engines against the reference's, on the CPU.

phi3.5-moe and qwen3-moe at reduced width in float32 on bridged weights
(``test_torch_serve_families.Pair``).  Requests of two prompt lengths
are admitted in exact-length groups (a MoE decoder takes no padded
prefill: capacity depends on the row's length).  The greedy tokens of
the fused engine, the paged engine and the paged engine with ``spec_k``
2 are identical to the reference engine's in the same mode.
Speculative tokens are held against the reference's speculative tokens,
never against plain decode: a verify pass routes ``k + 1`` rows with the
capacity of ``k + 1`` tokens, so an expert can drop a token that
one-token decode keeps, in both packages.
"""
import numpy as np
import pytest

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _cache_batch_axes
from test_torch_serve_families import one_torch_thread, pair  # noqa: F401

LENS = [6, 9, 6, 9, 6]
MAX_NEW = 6
KW = dict(max_batch=4, max_seq=24, eos_id=-1, page_size=8)


def _requests(cls, seed=5):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(1, 256, n).astype(np.int32),
                max_new_tokens=MAX_NEW) for i, n in enumerate(LENS)]


def _run(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, **KW, **kw)
    for r in _requests(request_cls):
        eng.submit(r)
    return {c.uid: list(c.tokens) for c in eng.run()}, eng


@pytest.mark.parametrize("mode", [dict(engine="fused"), dict(engine="paged"),
                                  dict(engine="paged", spec_k=2)],
                         ids=["fused", "paged", "paged-spec2"])
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "qwen3-moe-235b-a22b"],
                         ids=["phi35-moe", "qwen3-moe"])
def test_engine_tokens_match_reference(arch, mode):
    p = pair(arch)
    want, _ = _run(JServeEngine, JRequest, p.jmodel, p.jparams, **mode)
    got, eng = _run(ServeEngine, Request, p.model, p.master, **mode)
    assert got == want and len(got) == len(LENS)
    assert len({tuple(t) for t in got.values()}) > 1
    keys = sorted({eng._group_key(r)[:2] for r in _requests(Request)})
    assert keys == [("exact", 6), ("exact", 9)]
    if mode["engine"] == "paged":
        assert eng.pool.pages_in_use == 0
    else:
        assert _cache_batch_axes(p.model, 24) == {"k": 1, "v": 1, "pos": 0}
