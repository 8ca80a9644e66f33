"""whisper, hymba and the xLSTM served split over ``model``
(``serve/sharded.py``) against the reference's unsharded ``prefill`` and
``decode_step``, on the CPU.

Two spawned gloo worlds of 4 ranks, meshes (1, 4) and (2, 2) ("data",
"model") (``torch_worlds.serve_world``), each serving three reduced
configs in float32 on the reference's own init bridged through numpy
(norm gains randomized, as ``tests/test_torch_model.py`` does):

  * ``whisper``: reduced whisper-large-v3 (4 query heads over 2 KV
    heads, 2 + 2 layers, 8 frames), its frames split over the data axis
    with the rows: attention by heads (1 a rank over 4, the KV heads
    shared by two ranks; 2 over 2), the self-attention cache split by
    the sequence, the cross cache ``xk``/``xv`` whole over ``model``;
  * ``hymba``: reduced hymba-1.5b (layer 0 global, layer 1 a window of
    16): the global layer's K/V and ``slot_pos`` split by the sequence,
    the window layer's ring and every SSM state whole over ``model`` (the
    prefill's SSM by its channels, gathered; the decode's SSM stepped
    whole on every rank);
  * ``xlstm``: reduced xlstm-125m (one mLSTM and one sLSTM block), its
    layers gathered whole and its states whole over ``model``.

The prompts are whole rows of 252 tokens (these families take no padded
prefill), longer than hymba's window of 16, so the reference's ring
decode is sound (ROADMAP §3); the cache has 1024 positions, so the
reference's rule splits its sequence into blocks of 256 over a ``model``
axis of 4 (512 over 2), and 12 greedy decode steps cross from rank 0's
block into rank 1's on (1, 4).  Each rank's cache is held against the
reference's cache laid out by the reference's rule
(``cache_specs_sharding``, the port's copy): its block of every leaf.

Tolerances, those of ``tests/test_torch_serve_split.py`` (float32, the
same sums in another order):

  * every step's logits within 1e-5 of the step's max |logit|;
  * every rank's block of every cache leaf, after the prefill and after
    the last step, within 1e-5 of the max |x| of the matching block of
    the reference's cache (integer leaves exactly);
  * the greedy tokens and ``pos`` exactly; every leaf held whole over
    ``model`` ``torch.equal`` across the ``model`` ranks of a data
    group; a world of one ``torch.equal`` to the model's own calls.
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
from repro_torch.models import build_model
from repro_torch.parallel import tensor
from repro_torch.parallel.sharding import (Plan, Sharding,
                                           cache_specs_sharding)
from repro_torch.serve.sharded import make_serve_artifacts
from repro_torch.tree import flatten
from test_torch_model import (JaxModel, jax_params_randomized,  # noqa: F401
                              one_torch_thread)
from torch_worlds import run_world, serve_world

MAX_SEQ, STEPS, S, B = 1024, 12, 252, 4
CASES = {"whisper": "whisper-large-v3", "hymba": "hymba-1.5b",
         "xlstm": "xlstm-125m"}
MESHES = ((1, 4), (2, 2))
TOL = 1e-5
FRAME_STD = 1.0  # the frames' size, about the encoder's inputs at init


def _configs(arch):
    return (jreduced(jget_config(arch), dtype="float32"),
            reduced(get_config(arch), dtype="float32"))


@pytest.fixture(scope="module")
def reference():
    """Per case: the reference's logits of the prefill and of each greedy
    step, its tokens, its cache after the prefill and after the last
    step, and the inputs and bridged parameters."""
    out = {}
    for i, (name, arch) in enumerate(CASES.items()):
        jcfg, tcfg = _configs(arch)
        np_params = jax_params_randomized(jcfg)
        jparams = jax.tree.map(jnp.asarray, np_params)
        rng = np.random.default_rng(3 + i)
        tokens = rng.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
        extra = {}
        if jcfg.is_encoder_decoder:
            extra["frames"] = (FRAME_STD * rng.normal(size=(
                B, jcfg.encoder_frames, jcfg.d_model))).astype(np.float32)
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
            "case": {"arch": arch, "over": {},
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
        "serve"), shape, cases, MAX_SEQ, STEPS, timeout=240)
        for shape in MESHES}


class _At:
    """The sizes of a (data, model) mesh and one rank's coordinates on
    it, for ``Sharding.local``."""

    def __init__(self, shape, data, model):
        self.shape = {"data": shape[0], "model": shape[1]}
        self.coord = {"data": data, "model": model}

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord[a]
        return i


def _layouts(name, shape):
    """``path -> Sharding`` of the case's cache on ``shape``, by the
    reference's rule."""
    model = build_model(_configs(CASES[name])[1], "cpu")
    sh = cache_specs_sharding(model.cache_specs(B, MAX_SEQ),
                              _At(shape, 0, 0), Plan(), B, MAX_SEQ)
    return dict(flatten(sh))


def _ref_leaves(tree):
    """The reference's cache as ``path -> numpy array`` (its lists of
    per-layer dicts indexed as the port's tree paths)."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if not isinstance(tree, dict):
        return {"": np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        for p, x in _ref_leaves(v).items():
            out[f"{k}/{p}" if p else k] = x
    return out


def _rows(shape, data):
    b = B // shape[0]
    return slice(data * b, (data + 1) * b)


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
    # slot 0 crosses into the second block of the sequence on (1, 4), and
    # hymba's prompts are past its window
    assert S < MAX_SEQ // 4 <= S + STEPS - 1
    assert S > reduced(get_config("hymba-1.5b")).sliding_window


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
def test_split_cache_blocks_match_reference_blocks(worlds, reference, shape,
                                                   name):
    """Every leaf of every rank's cache is its block of the reference's
    cache by the reference's layout: the K/V sequence's (and hymba's
    global ``slot_pos``') block of ``max_seq / m`` positions, every other
    leaf whole over ``model``; its rows."""
    lay = _layouts(name, shape)
    split = {p for p, sh in lay.items()
             if any(tensor.AXIS in e for e in sh.spec)}
    want_split = {"whisper": {"k", "v"},
                  "hymba": {"layers/0/k", "layers/0/v",
                            "layers/0/slot_pos"},
                  "xlstm": set()}[name]
    assert split == want_split, split
    for res in worlds[shape]:
        r = res[name]
        at = _At(shape, r["data"], r["model"])
        for when in ("prefill_cache", "cache"):
            want = _ref_leaves(reference[name][when])
            got = dict(flatten(r[when]))
            assert set(got) == set(want) == set(lay), (set(got), set(want))
            for path, x in got.items():
                sh = lay[path]
                w = Sharding(at, sh.spec, sh.shape).local(
                    torch.from_numpy(np.array(want[path]))).numpy()
                g = x.numpy()
                assert g.shape == w.shape, (when, path, g.shape, w.shape)
                msg = f"{name} {shape} {when} {path} rank ({r['data']}, " \
                      f"{r['model']})"
                if np.issubdtype(w.dtype, np.integer):
                    np.testing.assert_array_equal(g, w, err_msg=msg)
                else:
                    np.testing.assert_allclose(
                        g, w, rtol=0, atol=TOL * float(np.abs(w).max()),
                        err_msg=msg)


@pytest.mark.parametrize("shape,name", GRID, ids=IDS)
def test_leaves_held_whole_are_the_same_on_every_model_rank(worlds, shape,
                                                             name):
    """Every cache leaf that the layout holds whole over ``model`` (the
    cross cache, the rings and their ``slot_pos``, the SSM and xLSTM
    states, ``pos``) is bit for bit the same on the ``model`` ranks of a
    data group, after the prefill and after the last step."""
    lay = _layouts(name, shape)
    whole = [p for p, sh in lay.items()
             if not any(tensor.AXIS in e for e in sh.spec)]
    assert whole
    by_data = {}
    for res in worlds[shape]:
        by_data.setdefault(res[name]["data"], []).append(res[name])
    for group in by_data.values():
        assert len(group) == shape[1]
        for when in ("prefill_cache", "cache"):
            first = dict(flatten(group[0][when]))
            for other in group[1:]:
                got = dict(flatten(other[when]))
                for path in whole:
                    assert torch.equal(got[path], first[path]), (
                        name, shape, when, path, other["model"])


def _same_tree(a, b) -> bool:
    fa, fb = flatten(a), flatten(b)
    return [p for p, _ in fa] == [p for p, _ in fb] and all(
        torch.equal(x, y) for (_, x), (_, y) in zip(fa, fb))


@pytest.mark.parametrize("name", list(CASES))
def test_world_of_one_is_the_unsplit_path(reference, name):
    """On the mesh of one process nothing is gathered or split: the
    serving steps are the model's own calls, bit for bit."""
    case = reference[name]["case"]
    model = build_model(_configs(case["arch"])[1], "cpu")
    params, tokens = case["params"], case["tokens"]
    extra = case["extra"] or None
    art = make_serve_artifacts(model, local_mesh("cpu"), Plan(), B, MAX_SEQ)
    with torch.no_grad():
        a, ca = art.prefill_fn(params, tokens, extra)
        b, cb = model.prefill(params, tokens, extra, max_seq=MAX_SEQ)
        for _ in range(3):
            assert torch.equal(a, b)
            assert _same_tree(ca, cb)
            nxt = a.argmax(-1).to(torch.int32)[:, None]
            a, ca = art.decode_fn(params, ca, nxt)
            b, cb = model.decode_step(params, cb, nxt)
        assert torch.equal(a, b) and _same_tree(ca, cb)


@pytest.mark.parametrize("name", ["whisper", "hymba"])
def test_kv_blocks_decode_matches_the_whole_read(reference, name):
    """``kv_blocks`` on one device: whisper's self-attention cache and
    hymba's global layer read in 4 blocks of 256 and merged as the split
    merges its ranks' blocks (hymba's ring read whole) give the whole
    read's tokens, and its logits and cache within 1e-5 of their max
    |x|."""
    case = reference[name]["case"]
    model = build_model(_configs(case["arch"])[1], "cpu")
    params = case["params"]
    with torch.no_grad():
        logits, whole = model.prefill(params, case["tokens"],
                                      case["extra"] or None, max_seq=MAX_SEQ)
        blocks = _clone(whole)
        a = b = logits
        for _ in range(STEPS):
            nxt = a.argmax(-1).to(torch.int32)[:, None]
            assert torch.equal(nxt, b.argmax(-1).to(torch.int32)[:, None])
            a, whole = model.decode_step(params, whole, nxt)
            b, blocks = model.decode_step(params, blocks, nxt, kv_blocks=4)
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=TOL * float(a.abs().max()))
        for (path, x), (_, y) in zip(flatten(whole), flatten(blocks)):
            np.testing.assert_allclose(
                y.numpy(), x.numpy(), rtol=0,
                atol=TOL * float(x.abs().max()), err_msg=path)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()
