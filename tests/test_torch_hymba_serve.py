"""hymba serving: the port against the reference, on the CPU.

Reduced hymba-1.5b (layer 0 global, layer 1 a window of 16) in float32 on
bridged weights with its SSM parameters moved off their init
(``test_torch_serve_families.Pair``).

  * Prompts past the window (20 and 24 tokens, two exact-length groups),
    16 new tokens each, so decode goes on around the window layer's ring:
    the fused engine's greedy tokens are identical to the reference
    engine's.
  * Prompts shorter than the window: the reference's decode counts the
    ring's empty slots (``slot_pos`` -1) as valid and attends to their
    zero K/V (its mask ``slot_pos <= pos``, ``attention.py:126``), so it
    disagrees with its own ``forward_train`` (ROADMAP §3, faults in the
    reference).  The port's prefill and decode logits are held against
    the reference's ``forward_train`` at the same positions, through the
    window's edge, within 2e-5; one test shows the reference's decode
    missing that mark.  No test here takes the reference's decode of a
    short prompt as its oracle.
  * A serve template for hymba, registered as a user registers one, runs
    through both packages' ``run_workflow`` with the same completions,
    its smoke prompts lengthened past the window (at the stage's 8
    tokens the reference's decode is the faulty one).
"""
import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import torch

from repro.core import workflow as jworkflow
from repro.core.provenance import ProvenanceStore as JStore
from repro.models import lm as jlm
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import engine as jengine
from repro_torch.core import stages, workflow
from repro_torch.core.provenance import ProvenanceStore
from repro_torch.models import lm
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import _cache_batch_axes
from test_torch_serve_families import one_torch_thread  # noqa: F401
from test_torch_serve_families import TOL, _np, pair, prompts
from test_torch_workflow import bridged_serve_params

ARCH = "hymba-1.5b"
WINDOW = 16


def _requests(cls, lens, max_new, seed=6):
    rng = np.random.default_rng(seed)
    return [cls(uid=i, prompt=rng.integers(1, 256, n).astype(np.int32),
                max_new_tokens=max_new) for i, n in enumerate(lens)]


def test_engine_tokens_past_the_window_match_reference():
    p = pair(ARCH)
    lens, kw = [20, 24, 20, 24, 20], dict(max_batch=4, max_seq=48, eos_id=-1)
    jeng = JServeEngine(p.jmodel, p.jparams, **kw)
    for r in _requests(JRequest, lens, 16):
        jeng.submit(r)
    want = {c.uid: list(c.tokens) for c in jeng.run()}
    eng = ServeEngine(p.model, p.master, **kw)
    for r in _requests(Request, lens, 16):
        eng.submit(r)
    got = {c.uid: list(c.tokens) for c in eng.run()}
    assert got == want and len(got) == len(lens)
    assert len({tuple(t) for t in got.values()}) > 1
    axes = _cache_batch_axes(p.model, 48)
    assert set(axes.values()) == {0} and "layers/1/ssm/conv" in axes


def _forward_logits(p, tokens):
    logits, _ = jlm.forward_train(p.jparams, p.jmodel.cfg,
                                  jnp.asarray(tokens))
    return np.asarray(logits)


def _port_logits(p, tokens, S, steps, max_seq):
    """The port's prefill of ``tokens[:, :S]`` and ``steps`` decode steps
    teacher-forced on ``tokens``: the logits at positions S - 1 ..
    S - 1 + steps."""
    with torch.no_grad():
        lg, cache = p.model.prefill(p.params, torch.from_numpy(tokens[:, :S]),
                                    max_seq=max_seq)
        out = [_np(lg)]
        for t in range(S, S + steps):
            lg, cache = p.model.decode_step(
                p.params, cache, torch.from_numpy(tokens[:, t:t + 1]))
            out.append(_np(lg))
    return np.stack(out, 1)


def test_short_prompt_decode_matches_forward():
    """A prompt of 6 tokens, then 12 decode steps through the window's
    edge (to position 17): the port's logits against the reference's
    ``forward_train`` at the same positions."""
    p = pair(ARCH)
    S, steps = 6, 12
    tokens = prompts(2, S + steps, seed=7)
    want = _forward_logits(p, tokens)[:, S - 1:S + steps]
    got = _port_logits(p, tokens, S, steps, 32)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    assert S < WINDOW < S + steps


def test_reference_short_prompt_decode_misses_its_forward():
    """The fault the port does not copy: the reference's own decode of a
    6-token prompt, one step, against its ``forward_train``."""
    p = pair(ARCH)
    S = 6
    tokens = prompts(2, S + 1, seed=7)
    want = _forward_logits(p, tokens)[:, S]
    _, jc = p.jmodel.prefill(p.jparams, jnp.asarray(tokens[:, :S]),
                             max_seq=32)
    jl, _ = p.jmodel.decode_step(p.jparams, jc, jnp.asarray(tokens[:, S:]))
    ref_err = float(np.abs(np.asarray(jl) - want).max())
    port_err = float(np.abs(_port_logits(p, tokens, S, 1, 32)[:, 1]
                            - want).max())
    assert ref_err > 1e3 * TOL > port_err, (ref_err, port_err)


def test_registered_serve_template_runs_like_the_reference(tmp_path):
    """``serve-hymba`` at scale ``reduced``, registered in a registry of
    its own, through both packages' ``run_workflow`` on the same bridged
    weights: the same completions, the checks passed."""
    def template(mod):
        reg = mod.WorkflowRegistry()
        reg.register(mod.WorkflowTemplate(
            name="serve-hymba", version="1.0.0",
            description="Batched serving recipe for hymba-1.5b", arch=ARCH,
            shape="decode_32k", kind="serve",
            checks=("throughput_positive",)))
        return reg.get("serve-hymba")

    # the smoke burst's prompts past the window, where the reference's
    # decode is sound
    long = 2 * WINDOW
    with mock.patch.object(jengine, "smoke_serve", functools.partial(
            jengine.smoke_serve, prompt_len=long)):
        want = jworkflow.run_workflow(template(jworkflow),
                                      JStore(str(tmp_path / "ref")))
    with mock.patch.object(stages, "init_serve_params",
                           bridged_serve_params), \
            mock.patch.object(tengine, "smoke_serve", functools.partial(
                tengine.smoke_serve, prompt_len=long)):
        got = workflow.run_workflow(template(workflow),
                                    ProvenanceStore(str(tmp_path / "port")),
                                    device="cpu")
    tokens = {c.uid: list(c.tokens) for c in got.final_state}
    assert tokens == {c.uid: list(c.tokens) for c in want.final_state}
    assert len(tokens) == 8 and got.ok and want.ok
    assert all(c.prompt_len == long for c in got.final_state)
    assert lm.layer_window(pair(ARCH).cfg, 1) == WINDOW < long
