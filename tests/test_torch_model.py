"""Model parity, PyTorch port vs the JAX reference, on the CPU.

The reduced qwen2-1.5b (float32) is initialised by the reference, its
zero QKV biases and unit norm gains are replaced by random values (at
init they would hide a wrong bias or gain mapping), and the same numpy
weights are bridged into the port.  Prefill logits (with and without
ragged ``lens``) and decode-step logits on a dense and on a paged cache
must agree at atol 1e-4 in float32 — both packages compute in float32
and differ only in summation order, accumulated over two layers and a
vocabulary projection — and at 2e-2 in bfloat16 (bfloat16 activations
are rounded at other points by the two frameworks)."""
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
from repro_torch.models.common import init_param

ATOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run tiny tensors: one intra-op thread keeps
    torch from oversubscribing the cores that parallel test workers
    share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxModel:
    """The reference model's serving calls, each compiled once."""

    def __init__(self, cfg):
        model = jbuild_model(cfg)
        self.prefill = jax.jit(model.prefill, static_argnames=("max_seq",))
        self.decode_step = jax.jit(model.decode_step)


def jax_params_randomized(cfg, seed: int = 0):
    """Reference params as numpy, with biases and norm gains randomized."""
    init = jax.jit(lambda key: jbuild_model(cfg).init(key)[0])
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for tree in (params, params["blocks"]):
        for name, x in tree.items():
            if isinstance(x, dict):
                continue
            if name.endswith("_g"):
                tree[name] = (1.0 + 0.2 * rng.normal(size=x.shape)).astype(x.dtype)
            elif name.startswith("attn_b"):
                tree[name] = (0.1 * rng.normal(size=x.shape)).astype(x.dtype)
    return params


def _setup(dtype: str, np_params=None):
    jcfg = jreduced(jget_config("qwen2-1.5b"), dtype=dtype)
    tcfg = reduced(get_config("qwen2-1.5b"), dtype=dtype)
    assert jcfg == jcfg.__class__(**{f: getattr(tcfg, f)
                                     for f in tcfg.__dataclass_fields__})
    if np_params is None:  # params are float32 whatever the compute dtype
        np_params = jax_params_randomized(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    model = build_model(tcfg, device="cpu")
    tparams = from_jax_params(np_params, tcfg, device="cpu")
    return JaxModel(jcfg), jparams, model, tparams, np_params


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.fixture(scope="module")
def f32():
    return _setup("float32")


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_logits_match(f32, ragged):
    jmodel, jparams, model, tparams, _ = f32
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, 256, (3, 12)).astype(np.int32)
    lens = np.asarray([12, 5, 9], np.int32) if ragged else None
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens), max_seq=16,
                            lens=None if lens is None else jnp.asarray(lens))
    tl, tc = model.prefill(tparams, torch.from_numpy(tokens), max_seq=16,
                           lens=None if lens is None else torch.from_numpy(lens))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL["float32"], rtol=0)
    np.testing.assert_allclose(_np(tc["k"]), _np(jc["k"]), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_dense_cache_logits_match(f32):
    jmodel, jparams, model, tparams, _ = f32
    rng = np.random.default_rng(4)
    tokens = rng.integers(1, 256, (2, 10)).astype(np.int32)
    lens = np.asarray([10, 6], np.int32)
    _, jc = jmodel.prefill(jparams, jnp.asarray(tokens), max_seq=16,
                           lens=jnp.asarray(lens))
    _, tc = model.prefill(tparams, torch.from_numpy(tokens), max_seq=16,
                          lens=torch.from_numpy(lens))
    for step in range(3):
        nxt = rng.integers(1, 256, (2, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt))
        tl, tc = model.decode_step(tparams, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL["float32"],
                                   rtol=0, err_msg=f"step {step}")
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_paged_cache_logits_match(f32):
    """Same paged cache state in both packages (random pools, a table with
    dead -1 entries, one parked row): logits and the written pools
    agree after each step."""
    jmodel, jparams, model, tparams, _ = f32
    rng = np.random.default_rng(5)
    cfg = model.cfg
    B, page, max_pages, num_pages = 3, 8, 4, 10
    shape = (cfg.num_layers, cfg.num_kv_heads, num_pages, page, cfg.head_dim)
    kp = rng.normal(size=shape).astype(np.float32)
    vp = rng.normal(size=shape).astype(np.float32)
    table = np.full((B, max_pages), -1, np.int32)
    table[0, :3] = [4, 2, 7]
    table[1, :2] = [1, 9]
    # row 2 is parked (all -1): its writes land in the null page 0
    pos = np.asarray([17, 8, 5], np.int32)
    jc = {"k_pool": jnp.asarray(kp), "v_pool": jnp.asarray(vp),
          "page_table": jnp.asarray(table), "pos": jnp.asarray(pos)}
    tc = {"k_pool": torch.from_numpy(kp.copy()),
          "v_pool": torch.from_numpy(vp.copy()),
          "page_table": torch.from_numpy(table), "pos": torch.from_numpy(pos)}
    for step in range(3):
        nxt = rng.integers(1, 256, (B, 1)).astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt))
        tl, tc = model.decode_step(tparams, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL["float32"],
                                   rtol=0, err_msg=f"step {step}")
    np.testing.assert_allclose(_np(tc["k_pool"]), _np(jc["k_pool"]), atol=1e-4)
    np.testing.assert_allclose(_np(tc["v_pool"]), _np(jc["v_pool"]), atol=1e-4)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_bfloat16_prefill_and_decode_match(f32):
    jmodel, jparams, model, tparams, _ = _setup("bfloat16", f32[-1])
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, 256, (2, 8)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens), max_seq=12)
    tl, tc = model.prefill(tparams, torch.from_numpy(tokens), max_seq=12)
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL["bfloat16"], rtol=0)
    nxt = rng.integers(1, 256, (2, 1)).astype(np.int32)
    jl, _ = jmodel.decode_step(jparams, jc, jnp.asarray(nxt))
    tl, _ = model.decode_step(tparams, tc, torch.from_numpy(nxt))
    np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL["bfloat16"], rtol=0)


def test_serving_params_cast_once_and_keep_gains_f32(f32):
    _, _, model, tparams, _ = f32
    bf = model.__class__(reduced(get_config("qwen2-1.5b")), model.device)
    sp = bf.serving_params(tparams)
    assert sp["embed"].dtype == torch.bfloat16
    assert sp["final_g"].dtype == torch.float32
    assert isinstance(sp["blocks"], list) and len(sp["blocks"]) == 2
    assert sp["blocks"][1]["attn_wq"].dtype == torch.bfloat16
    assert sp["blocks"][1]["norm2_g"].dtype == torch.float32
    torch.testing.assert_close(sp["blocks"][1]["norm2_g"],
                               tparams["blocks"]["norm2_g"][1])


def test_init_mirrors_reference_shapes_and_scales(f32):
    """The port's own init has the reference's tree, shapes and dtypes,
    fan-in-scaled stds, and ones/zeros where the reference has them; a
    seed gives the same weights twice."""
    jmodel, jparams, model, _, _ = f32
    p = model.init(seed=0)
    flat_t = {("blocks/" + k): v for k, v in p["blocks"].items()}
    flat_t.update({k: v for k, v in p.items() if k != "blocks"})
    flat_j = {("blocks/" + k): v for k, v in jparams["blocks"].items()}
    flat_j.update({k: v for k, v in jparams.items() if k != "blocks"})
    assert sorted(flat_t) == sorted(flat_j)
    for name, t in flat_t.items():
        assert tuple(t.shape) == tuple(flat_j[name].shape), name
        assert t.dtype == torch.float32
    assert torch.all(p["final_g"] == 1) and torch.all(p["blocks"]["attn_bq"] == 0)
    wd = p["blocks"]["mlp_wd"]  # (L, F, D): fan-in F = 128, std 0.02
    assert abs(float(wd.std()) - 0.02) < 0.002
    emb = p["embed"]  # (V, D): fan-in V = 256, std min(0.02, 1/16)
    assert abs(float(emb.std()) - 0.02) < 0.002
    torch.testing.assert_close(
        init_param("x", (4, 8), seed=3, device="cpu"),
        init_param("x", (4, 8), seed=3, device="cpu"), rtol=0, atol=0)
    torch.testing.assert_close(model.init(seed=0)["embed"], emb, rtol=0, atol=0)
