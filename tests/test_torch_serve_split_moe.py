"""The MoE decoders and phi-3-vision served split over ``model``
(``serve/sharded.py``) against the reference's unsharded ``prefill`` and
``decode_step``, on the CPU.

Two spawned gloo worlds of 4 ranks, meshes (1, 4) and (2, 2) ("data",
"model") (``torch_worlds.serve_world``), each serving three reduced
configs in float32 on the reference's own init bridged through numpy
(biases and norm gains randomized, as ``tests/test_torch_model.py``
does):

  * ``phi35``: reduced phi3.5-moe, 4 experts top-2 (1 expert a rank on
    (1, 4), 2 on (2, 2)), at ``moe_capacity_factor`` 0.5, so that its
    prefill drops about half of the routed entries: the split must drop
    exactly the unsplit layer's;
  * ``qwen3``: reduced qwen3-moe with 8 experts top-4 (2 a rank on
    (1, 4), 4 on (2, 2)), overridden on both sides;
  * ``vlm``: reduced phi-3-vision with its 4 image positions, the image
    embeddings split over the data axis with the rows.

The experts are held split over ``model``: each rank routes all its
tokens with the whole router, runs its experts' slots through K4's plain
version and the partial outputs are summed over ``model``
(``models/moe.py`` ``apply_moe_split``).  The MoE decoders take no
padded prefill (as the reference), so the prompts are whole rows of 252
tokens; the cache has 1024 positions (blocks of 256 over 4 ranks, 512
over 2), and 12 greedy decode steps cross from rank 0's block into rank
1's on (1, 4).

Tolerances, those of ``tests/test_torch_serve_split.py`` (float32, the
same sums in another order):

  * every step's logits within 1e-5 of the step's max |logit|;
  * every rank's cache block, after the prefill and after the last
    step, within 1e-5 of the max |x| of the matching slice of the
    reference's cache;
  * the greedy tokens, ``pos``, the dropped entries, and a world of one
    (``torch.equal`` with the model's own calls) exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import build_model, moe
from repro_torch.parallel.sharding import Plan
from repro_torch.serve.sharded import make_serve_artifacts
from test_torch_model import (JaxModel, jax_params_randomized,  # noqa: F401
                              one_torch_thread)
from torch_worlds import run_world, serve_world

MAX_SEQ, STEPS, S, B = 1024, 12, 252, 4
CASES = {"phi35": ("phi3.5-moe-42b-a6.6b", {"moe_capacity_factor": 0.5}),
         "qwen3": ("qwen3-moe-235b-a22b", {"num_experts": 8, "top_k": 4}),
         "vlm": ("phi-3-vision-4.2b", {})}
MESHES = ((1, 4), (2, 2))
TOL = 1e-5
IMG_STD = 0.1  # the image embeddings' size, about the token embeddings'


def _configs(arch, over):
    return (jreduced(jget_config(arch), dtype="float32", **over),
            reduced(get_config(arch), dtype="float32", **over))


@pytest.fixture(scope="module")
def reference():
    """Per case: the reference's logits of the prefill and of each greedy
    step, its tokens, its cache after the prefill and after the last
    step, and the inputs and bridged parameters."""
    out = {}
    for i, (name, (arch, over)) in enumerate(CASES.items()):
        jcfg, tcfg = _configs(arch, over)
        np_params = jax_params_randomized(jcfg)
        jparams = jax.tree.map(jnp.asarray, np_params)
        rng = np.random.default_rng(30 + i)
        tokens = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
        extra = {}
        if jcfg.num_image_tokens:
            extra["image_embeds"] = (IMG_STD * rng.normal(size=(
                B, jcfg.num_image_tokens, jcfg.d_model))).astype(np.float32)
        jm = JaxModel(jcfg)
        logits, cache = jm.prefill(
            jparams, jnp.asarray(tokens),
            {k: jnp.asarray(v) for k, v in extra.items()} or None,
            max_seq=MAX_SEQ)
        first = jax.tree.map(np.asarray, cache)
        seen, chosen = [np.asarray(logits)], []
        for _ in range(STEPS):
            nxt = np.argmax(seen[-1], -1).astype(np.int32)[:, None]
            chosen.append(nxt)
            logits, cache = jm.decode_step(jparams, cache, jnp.asarray(nxt))
            seen.append(np.asarray(logits))
        out[name] = {
            "logits": np.stack(seen), "tokens": np.concatenate(chosen, 1),
            "prefill_cache": first,
            "cache": jax.tree.map(np.asarray, cache),
            "case": {"arch": arch, "over": over,
                     "params": from_jax_params(np_params, tcfg, "cpu"),
                     "tokens": torch.from_numpy(tokens), "lens": None,
                     "extra": {k: torch.from_numpy(v)
                               for k, v in extra.items()}}}
    return out


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """Every rank's results on each mesh."""
    cases = {name: r["case"] for name, r in reference.items()}
    return {shape: run_world(serve_world, 4, tmp_path_factory.mktemp(
        "serve_moe"), shape, cases, MAX_SEQ, STEPS) for shape in MESHES}


def _rows(shape, data):
    b = B // shape[0]
    return slice(data * b, (data + 1) * b)


def _model(case):
    return build_model(_configs(case["arch"], case["over"])[1], "cpu")


GRID = [(shape, name) for shape in MESHES for name in CASES]
IDS = [f"{a}x{b}-{name}" for (a, b), name in GRID]


@pytest.mark.parametrize("shape,name", GRID, ids=IDS)
def test_split_greedy_tokens_match_reference(worlds, reference, shape,
                                             name):
    want = reference[name]["tokens"]
    for res in worlds[shape]:
        got = res[name]["tokens"].numpy()
        np.testing.assert_array_equal(got, want[_rows(shape, res[name][
            "data"])])
    # the decode crosses into the second block of the sequence on (1, 4)
    assert S < MAX_SEQ // 4 <= S + STEPS - 1


@pytest.mark.parametrize("shape,name", GRID, ids=IDS)
def test_split_logits_match_reference(worlds, reference, shape, name):
    want = reference[name]["logits"]
    for res in worlds[shape]:
        got = res[name]["logits"].numpy()
        w = want[:, _rows(shape, res[name]["data"])]
        assert got.shape == w.shape  # whole over the vocab
        for step in range(STEPS + 1):
            np.testing.assert_allclose(
                got[step], w[step], rtol=0,
                atol=TOL * float(np.abs(w[step]).max()),
                err_msg=f"{name} {shape} step {step}")


@pytest.mark.parametrize("shape,name", GRID, ids=IDS)
def test_split_cache_blocks_match_reference_slices(worlds, reference, shape,
                                                   name):
    blk = MAX_SEQ // shape[1]
    for res in worlds[shape]:
        r = res[name]
        rows = _rows(shape, r["data"])
        seq = slice(r["model"] * blk, (r["model"] + 1) * blk)
        for when in ("prefill_cache", "cache"):
            for leaf in ("k", "v"):
                want = reference[name][when][leaf][:, rows, seq]
                got = r[when][leaf].numpy()
                assert got.shape == want.shape, (when, leaf)
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=TOL * float(np.abs(want).max()),
                    err_msg=f"{name} {shape} {when} {leaf} rank "
                            f"({r['data']}, {r['model']})")
            np.testing.assert_array_equal(r[when]["pos"].numpy(),
                                          reference[name][when]["pos"][rows])


@pytest.mark.parametrize("shape", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_split_prefill_drops_the_unsplit_entries(worlds, reference, shape):
    """Every rank's MoE prefill drops exactly the entries the unsplit
    layer drops on its rows (the capacity and the dispatch over all E
    experts are the unsplit ones); at capacity factor 0.5 phi3.5-moe
    drops some, and the VLM routes nothing."""
    for name in CASES:
        case = reference[name]["case"]
        model = _model(case)
        for res in worlds[shape]:
            got = res[name]["drops"]
            if not model.cfg.num_experts:
                assert got is None
                continue
            moe.drop_stats = []
            try:
                with torch.no_grad():
                    model.prefill(case["params"], case["tokens"][_rows(
                        shape, res[name]["data"])], max_seq=MAX_SEQ)
                want = tuple(int(sum(int(s[i]) for s in moe.drop_stats))
                             for i in (0, 1))
            finally:
                moe.drop_stats = None
            assert got == want, (name, shape, got, want)
            if name == "phi35":
                assert got[0] < got[1], got  # it drops


@pytest.mark.parametrize("name", list(CASES))
def test_world_of_one_is_the_unsplit_path(reference, name):
    """On the mesh of one process nothing is gathered or split: the
    serving steps are the model's own calls, bit for bit."""
    case = reference[name]["case"]
    model = _model(case)
    params, tokens = case["params"], case["tokens"]
    extra = case["extra"] or None
    art = make_serve_artifacts(model, local_mesh("cpu"), Plan(), B, MAX_SEQ)
    with torch.no_grad():
        a, ca = art.prefill_fn(params, tokens, extra)
        b, cb = model.prefill(params, tokens, extra, max_seq=MAX_SEQ)
        for _ in range(3):
            assert torch.equal(a, b)
            assert all(torch.equal(ca[k], cb[k]) for k in ("k", "v", "pos"))
            nxt = a.argmax(-1).to(torch.int32)[:, None]
            a, ca = art.decode_fn(params, ca, nxt)
            b, cb = model.decode_step(params, cb, nxt)
        assert torch.equal(a, b)


def _layer_inputs(arch, over, seed, rows=3, seq=40):
    cfg = reduced(get_config(arch), dtype="float32", **over)
    g = torch.Generator().manual_seed(seed)
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.d_ff
    p = {"router": torch.randn(D, E, generator=g),
         "moe_wg": 0.1 * torch.randn(E, D, F_, generator=g),
         "moe_wu": 0.1 * torch.randn(E, D, F_, generator=g),
         "moe_wd": 0.1 * torch.randn(E, F_, D, generator=g)}
    return cfg, p, torch.randn(rows, seq, D, generator=g)


SPLITS = [(name, m) for name in ("phi35", "qwen3") for m in (2, 4)]


@pytest.mark.parametrize("name,m", SPLITS,
                         ids=[f"{n}-{m}ranks" for n, m in SPLITS])
def test_split_moe_partials_sum_to_the_layer(name, m):
    """``apply_moe_split`` on a fake split of ``m`` ranks, each holding
    its ``E/m`` experts: the partials sum to ``apply_moe`` (float32, the
    same products; within 1e-6 of the output's max), every rank returns
    the whole routing's aux loss and counts the layer's drops, and each
    rank's partial is zero on the tokens none of its experts kept.
    ``expert_blocks(m)`` on one device gives the same sum."""
    arch, over = CASES[name]
    cfg, p, x = _layer_inputs(arch, dict(over, moe_capacity_factor=0.5), 7)
    moe.drop_stats = []
    try:
        want, aux = moe.apply_moe(p, x, cfg)
        (kept, total), = [(int(a), int(b)) for a, b in moe.drop_stats]
        assert kept < total  # capacity 0.5 drops
        e = cfg.num_experts // m
        parts = []
        for r in range(m):
            pr = dict(p, **{k: p[k][r * e:(r + 1) * e]
                            for k in moe.EXPERT_LEAVES})
            part, a = moe.apply_moe_split(pr, x, cfg, r, m)
            assert torch.equal(a, aux)
            parts.append(part)
        assert [(int(a), int(b)) for a, b in moe.drop_stats[1:]] == \
            [(kept, total)] * m
    finally:
        moe.drop_stats = None
    got = torch.stack(parts).sum(0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    # a token whose every routed entry was dropped gets zero from all
    dropped = want.abs().sum(-1) == 0
    for part in parts:
        assert not part[dropped].any()
    with moe.expert_blocks(m):
        blocks, baux = moe.apply_moe(p, x, cfg)
    assert torch.equal(baux, aux)
    np.testing.assert_allclose(blocks.numpy(), got.numpy(), rtol=0,
                               atol=1e-6 * float(want.abs().max()))


def test_split_moe_runs_only_its_experts_slots(monkeypatch):
    """A rank's three K4 calls take its ``E/m`` experts' ``B·C`` rows
    each, never the whole ``(E·B·C, D)`` buffer."""
    cfg, p, x = _layer_inputs(*CASES["qwen3"], 8)
    seen = []
    real = moe.ops.moe_gmm

    def spy(tokens, sizes, w, **kw):
        seen.append((tuple(tokens.shape), list(sizes), tuple(w.shape)))
        return real(tokens, sizes, w, **kw)

    monkeypatch.setattr(moe.ops, "moe_gmm", spy)
    m, (Bx, Sx, D) = 4, x.shape
    e = cfg.num_experts // m
    C = moe.moe_capacity(cfg, Sx)
    pr = dict(p, **{k: p[k][e:2 * e] for k in moe.EXPERT_LEAVES})
    moe.apply_moe_split(pr, x, cfg, 1, m)
    assert len(seen) == 3
    for rows, sizes, w in seen:
        assert rows[0] == e * Bx * C and sizes == [Bx * C] * e
        assert w[0] == e


def test_moe_and_vlm_no_longer_refuse_a_split_mesh():
    """The serving layouts of reduced phi3.5-moe and phi-3-vision on a
    (1, 4) mesh: no refusal; the MoE's experts held split over
    ``model`` (each rank one of 4), its router gathered whole."""
    from test_torch_serve_split import _FakeMesh

    for arch in ("phi3.5-moe-42b-a6.6b", "phi-3-vision-4.2b"):
        model = build_model(reduced(get_config(arch)), "cpu")
        art = make_serve_artifacts(model, _FakeMesh(4), Plan(), 4, 1024)
        blocks = art.param_shardings["blocks"]
        if arch.startswith("phi3.5"):
            for k in moe.EXPERT_LEAVES:
                assert blocks[k].spec[1] == ("model",), (k, blocks[k].spec)
                assert blocks[k].local_shape()[1] == 1
            assert blocks["router"].spec[2] == ("model",)


def test_expert_blocks_is_undone_after_its_block():
    """Outside ``expert_blocks`` the layer is the whole-expert path again,
    bit for bit."""
    cfg, p, x = _layer_inputs(*CASES["phi35"], 9)
    before, _ = moe.apply_moe(p, x, cfg)
    with moe.expert_blocks(4):
        assert moe._expert_blocks == 4
        moe.apply_moe(p, x, cfg)
    assert moe._expert_blocks == 1
    after, _ = moe.apply_moe(p, x, cfg)
    assert torch.equal(before, after)
