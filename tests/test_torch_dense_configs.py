"""The other dense configs against the reference, on the CPU.

glm4-9b, qwen1.5-4b and internlm2-20b share the dense branch with
qwen2-1.5b; at ``reduced()`` width they differ from it in the untied
embedding (all three) and the QKV bias (qwen1.5-4b).  Each in float32 on
the reference's weights bridged through numpy (biases and norm gains
randomized, as ``tests/test_torch_model.py`` does), held within:

  * prefill's logits and 3 decode steps' logits: 1e-5 of max |logit|;
  * the loss: rtol 1e-5; every gradient leaf within 1e-5 of that leaf's
    max |g| (float32, the same sums in other orders: measured 3.0e-7 and
    6.4e-7 of the max).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.tree import flatten
from test_torch_model import (JaxModel, jax_params_randomized,  # noqa: F401
                              one_torch_thread)

ARCHS = ("glm4-9b", "qwen1.5-4b", "internlm2-20b")
TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jreduced(jget_config(request.param), dtype="float32")
    tcfg = reduced(get_config(request.param), dtype="float32")
    np_params = jax_params_randomized(jcfg)
    return (jcfg, JaxModel(jcfg), jax.tree.map(jnp.asarray, np_params),
            build_model(tcfg, device="cpu"),
            from_jax_params(np_params, tcfg, device="cpu"))


def _close(got, want, msg):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=TOL * float(np.abs(want).max()), rtol=0,
                               err_msg=msg)


def test_prefill_and_decode_logits_match(pair):
    _, jmodel, jparams, model, tparams = pair
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 256, (2, 10)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens), max_seq=16)
    tl, tc = model.prefill(tparams, torch.from_numpy(tokens), max_seq=16)
    _close(tl, jl, "prefill")
    for step in range(3):
        nxt = rng.integers(1, 256, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt))
        tl, tc = model.decode_step(tparams, tc, torch.from_numpy(nxt))
        _close(tl, jl, f"decode step {step}")


def test_loss_and_gradients_match_reference(pair):
    jcfg, _, jparams, model, tparams = pair
    tokens = np.random.default_rng(5).integers(1, 256, (2, 24)).astype(
        np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jbuild_model(jcfg).loss(p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jparams)
    leaves = [p.requires_grad_() for _, p in flatten(tparams)]
    tl, _ = model.loss(tparams, {"tokens": torch.from_numpy(tokens)})
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for (key, want), got in zip(flatten(jax.tree.map(np.asarray, jg)), tg):
        _close(got, want, key)
