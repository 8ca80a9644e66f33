"""Serving of the MoE decoders, hymba and the xLSTM: the port against the
reference, on the CPU.

Each family at ``reduced()`` width in float32 (phi3.5-moe and qwen3-moe:
2 layers of 4 experts, top 2; hymba: layer 0 global, layer 1 a window of
16, the SSM parameters moved off their init so that the scan shapes the
output; xlstm: one group of an mLSTM and an sLSTM block), the
reference's weights bridged through numpy.  The reference runs its
default ``ref`` kernel backend; the port runs on CPU tensors, where K5
and K6 with their final state take their plain versions.  Held within
2e-5 (abs and rel, float32, ``tests/test_kernels.py``):

  * prefill's last-token logits and every cache leaf, then three decode
    steps' logits and leaves (hymba with a prompt past its window, so
    prefill lays the window layer out as a ring and decode goes on
    around it);
  * the refusals the reference keeps: padded prefill for all three
    families, and the paged cache and speculation for the recurrent two;
  * ``python -m repro_torch.launch.serve --arch ...`` on the CPU.

The engines' tokens are held in ``test_torch_moe_serve.py``,
``test_torch_hymba_serve.py`` and ``test_torch_xlstm_serve.py``.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import _cache_leaves

TOL = 2e-5
# hymba's block parameters moved off their init: (name, mean, std)
HYMBA_MOVED = (("ssm_A_log", 0.0, 0.5), ("ssm_b_dt", 1.0, 1.0),
               ("ssm_D", 0.0, 1.0), ("ssm_conv_w", 0.0, 0.3),
               ("ssm_w_B", 0.0, 0.1), ("ssm_w_C", 0.0, 0.1),
               ("ssm_w_dt1", 0.0, 0.1), ("ssm_w_dt2", 0.0, 0.1),
               ("fuse_attn", 1.0, 0.3), ("fuse_ssm", 1.0, 0.3))
ARCHS = ("phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "hymba-1.5b",
         "xlstm-125m")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """One architecture at reduced width in float32 in both packages, on
    the reference's weights (hymba's SSM parameters moved off their
    init): ``jmodel``/``jparams`` and ``model``/``params`` (the port's
    serving parameters, bridged)."""

    def __init__(self, arch: str, seed: int = 0):
        self.cfg = reduced(get_config(arch), dtype="float32")
        self.jmodel = jbuild_model(jreduced(jget_config(arch),
                                            dtype="float32"))
        params, _ = self.jmodel.init(jax.random.PRNGKey(seed))
        if self.cfg.family == "hybrid":
            rng = np.random.default_rng(1)
            blocks = params["blocks"]
            for name, mean, std in HYMBA_MOVED:
                blocks[name] = jnp.asarray(
                    mean + std * rng.standard_normal(blocks[name].shape),
                    jnp.float32)
        self.jparams = params
        self.model = build_model(self.cfg, device="cpu")
        self.master = from_jax_params(jax.tree.map(np.asarray, params),
                                      self.cfg, "cpu")
        self.params = self.model.serving_params(self.master)


_PAIRS = {}


def pair(arch: str) -> Pair:
    """The module-wide :class:`Pair` of ``arch`` (built once a worker)."""
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_caches_close(jcache, tcache, tol=TOL):
    """Every leaf of the reference's cache and the port's, in one order
    (dict keys sorted, lists in order), of one shape, within ``tol``."""
    want = [(jtu.keystr(p), np.asarray(x))
            for p, x in jtu.tree_flatten_with_path(jcache)[0]]
    got = _cache_leaves(tcache)
    assert len(want) == len(got)
    for (wp, w), (gp, g) in zip(want, got):
        assert w.shape == tuple(g.shape), (wp, gp)
        np.testing.assert_allclose(_np(g), w, atol=tol, rtol=tol,
                                   err_msg=f"{wp} / {gp}")


def prompts(n: int, length: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 256, (n, length)).astype(
        np.int32)


# (arch, prompt length, max_seq): hymba's prompt past its window of 16
PARITY = [("phi3.5-moe-42b-a6.6b", 10, 16), ("qwen3-moe-235b-a22b", 10, 16),
          ("hymba-1.5b", 20, 32), ("xlstm-125m", 10, 16)]


@pytest.mark.parametrize("arch,S,max_seq", PARITY,
                         ids=["phi35-moe", "qwen3-moe", "hymba", "xlstm"])
def test_prefill_and_decode_match_reference(arch, S, max_seq):
    p = pair(arch)
    tokens = prompts(2, S + 3, seed=4)
    jl, jc = p.jmodel.prefill(p.jparams, jnp.asarray(tokens[:, :S]),
                              max_seq=max_seq)
    with torch.no_grad():
        tl, tc = p.model.prefill(p.params, torch.from_numpy(tokens[:, :S]),
                                 max_seq=max_seq)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL, rtol=TOL)
    assert_caches_close(jc, tc)
    for t in range(S, S + 3):
        nt = tokens[:, t:t + 1]
        jl, jc = p.jmodel.decode_step(p.jparams, jc, jnp.asarray(nt))
        with torch.no_grad():
            tl, tc = p.model.decode_step(p.params, tc, torch.from_numpy(nt))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=TOL,
                                   rtol=TOL, err_msg=f"decode at {t}")
        assert_caches_close(jc, tc)
    assert tc["pos"].tolist() == [S + 3] * 2


def test_hymba_cache_layout_matches_reference():
    """The hybrid cache: a global layer of max_seq rows, a window layer's
    ring of min(window, max_seq), slot_pos -1; at batch 1 and 2 the
    engine finds every leaf's batch axis."""
    p = pair("hymba-1.5b")
    want = p.jmodel.cache_specs(2, 40)
    got = p.model.cache_specs(2, 40)
    assert [tuple(x.shape) for _, x in _cache_leaves(got)] == [
        x.shape for x in jax.tree.leaves(want)]
    assert [l["k"].shape[1] for l in got["layers"]] == [40, 16]
    cache = p.model.init_cache(2, 8)
    assert [l["k"].shape[1] for l in cache["layers"]] == [8, 8]
    assert all(torch.all(l["slot_pos"] == -1) for l in cache["layers"])


@pytest.mark.parametrize("arch", ARCHS[1:],
                         ids=["qwen3-moe", "hymba", "xlstm"])
def test_padded_prefill_refusal_stays(arch):
    """``lens`` raises the reference's ``ValueError`` in both packages."""
    p = pair(arch)
    tokens = prompts(1, 6)
    lens = np.array([4], np.int32)
    with pytest.raises(ValueError, match="lens"):
        p.jmodel.prefill(p.jparams, jnp.asarray(tokens),
                         lens=jnp.asarray(lens))
    with pytest.raises(ValueError, match="lens"):
        p.model.prefill(p.params, torch.from_numpy(tokens),
                        lens=torch.from_numpy(lens))
    assert not p.model.supports_padded_prefill()


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"],
                         ids=["hymba", "xlstm"])
def test_recurrent_paged_and_speculative_refusals_stay(arch):
    p = pair(arch)
    assert not p.model.supports_paged_cache()
    assert not p.model.supports_speculative()
    with pytest.raises(ValueError, match="paged"):
        p.model.init_paged_cache(1, 4, 8, 2)
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(p.model, p.master, engine="paged")
    with pytest.raises(ValueError, match="speculative"):
        ServeEngine(p.model, p.master, spec_k=2)
    with pytest.raises(ValueError, match="speculative"):
        p.model.verify_step(p.params, p.model.init_cache(1, 8),
                            torch.ones((1, 3), dtype=torch.int32))


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "hymba-1.5b",
                                  "xlstm-125m"],
                         ids=["phi35-moe", "hymba", "xlstm"])
def test_serve_cli_runs_reduced(arch, capsys):
    argv = ["serve", "--arch", arch, "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--prompt-len", "6", "--max-batch", "2"]
    with mock.patch("sys.argv", argv):
        serve_cli.main()
    out = capsys.readouterr().out
    assert f"arch={arch} engine=fused" in out and "requests=3 tokens=12" in out
