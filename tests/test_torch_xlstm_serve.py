"""xLSTM serving: the port's engine against the reference's, on the CPU.

Reduced xlstm-125m (one group of an mLSTM and an sLSTM block) in float32
on bridged weights (``test_torch_serve_families.Pair``).  Requests of two
prompt lengths are admitted in exact-length groups (a recurrent state
would carry pad steps), and each group's prefilled states are inserted
into the batch cache along their batch axes, which are not 0: 2 for the
grouped mLSTM states ``(groups, slstm_every - 1, B, ...)`` and 1 for the
sLSTM's ``(groups, B, ...)``.  The fused engine's greedy tokens are
identical to the reference engine's, one token or three per host
transfer.
"""
import numpy as np
import pytest

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import _cache_batch_axes
from test_torch_serve_families import one_torch_thread, pair  # noqa: F401

ARCH = "xlstm-125m"
LENS = [7, 12, 7, 12, 7]
KW = dict(max_batch=4, max_seq=24, eos_id=-1)


def _requests(cls, seed=8):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(1, 256, n).astype(np.int32),
                max_new_tokens=8) for i, n in enumerate(LENS)]


def _run(engine_cls, request_cls, model, params, **kw):
    eng = engine_cls(model, params, **KW, **kw)
    for r in _requests(request_cls):
        eng.submit(r)
    return {c.uid: list(c.tokens) for c in eng.run()}, eng


@pytest.fixture(scope="module")
def want():
    p = pair(ARCH)
    return _run(JServeEngine, JRequest, p.jmodel, p.jparams)[0]


@pytest.mark.parametrize("chunk", [1, 3])
def test_engine_tokens_match_reference(want, chunk):
    p = pair(ARCH)
    got, eng = _run(ServeEngine, Request, p.model, p.master,
                    decode_chunk=chunk)
    assert got == want and len(got) == len(LENS)
    assert len({tuple(t) for t in got.values()}) > 1
    assert sorted({eng._group_key(r)[:2] for r in _requests(Request)}) == [
        ("exact", 7), ("exact", 12)]


def test_cache_batch_axes():
    axes = _cache_batch_axes(pair(ARCH).model, 24)
    assert axes == {"mlstm/C": 2, "mlstm/m": 2, "mlstm/n": 2, "pos": 0,
                    "slstm/c": 1, "slstm/h": 1, "slstm/m": 1, "slstm/n": 1}
