"""The dense decoders served split over ``model`` (``serve/sharded.py``)
against the reference's unsharded ``prefill`` and ``decode_step``, on the
CPU.

Two spawned gloo worlds of 4 ranks, meshes (1, 4) and (2, 2) ("data",
"model") (``torch_worlds.serve_world``), each serving two reduced dense
configs in float32 on the reference's own init bridged through numpy
(biases and norm gains randomized, as ``tests/test_torch_model.py``
does):

  * ``heads``: reduced qwen2-1.5b, 4 query heads over 2 KV heads:
    attention split by heads (1 a rank over 4, 2 over 2), the MLP by its
    hidden dim (128: 32 a rank over 4), the tied embedding and head by
    vocab blocks (256: 64 a rank);
  * ``unsplit``: reduced qwen1.5-4b with 6 query heads (QKV biases, an
    untied head): 6 heads do not split over 4 ranks, so on (1, 4) every
    rank computes attention whole while the MLP and the vocab split; on
    (2, 2) 3 heads a rank, straddling the KV groups.

The cache has 1024 positions, so the reference's rule (``d >= 1024``)
splits its sequence into blocks of 256 over a ``model`` axis of 4 (512
over 2).  The prompts are right-padded to 252 with ragged ``lens``
(252, 247, 250, 241), then 12 greedy decode steps: slot 0 writes
positions 252..263, crossing from rank 0's block into rank 1's on (1, 4),
while ranks 2 and 3 hold no valid position until then (their partials
are empty: ``lse = -inf``).

Tolerances, those ``tests/test_torch_tensor_parallel.py`` holds the
split training to, with their reason (float32, the same sums in another
order: the ranks' terms summed over ``model``, the blocks' softmax
merged from their maxima and sums):

  * every step's logits within 1e-5 of the step's max |logit|;
  * every rank's cache block, after the prefill and after the last
    step, within 1e-5 of the max |x| of the matching slice of the
    reference's cache;
  * the greedy tokens, ``pos``, a world of one (``torch.equal`` with the
    model's own calls), and the refusals exactly.
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
from repro_torch.kernels import ref as kref
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import build_model
from repro_torch.parallel import tensor
from repro_torch.parallel.sharding import Plan, cache_specs_sharding
from repro_torch.serve.sharded import _check_seq_split, make_serve_artifacts
from test_torch_model import (JaxModel, jax_params_randomized,  # noqa: F401
                              one_torch_thread)
from torch_worlds import run_world, serve_world

MAX_SEQ, STEPS, S = 1024, 12, 252
LENS = (252, 247, 250, 241)
CASES = {"heads": ("qwen2-1.5b", {}),
         "unsplit": ("qwen1.5-4b", {"num_heads": 6})}
MESHES = ((1, 4), (2, 2))
TOL = 1e-5


def _configs(arch, over):
    return (jreduced(jget_config(arch), dtype="float32", **over),
            reduced(get_config(arch), dtype="float32", **over))


@pytest.fixture(scope="module")
def reference():
    """Per case: the reference's logits of the prefill and of each greedy
    step, its tokens, its cache after the prefill and after the last
    step, and the inputs and bridged parameters."""
    out = {}
    for name, (arch, over) in CASES.items():
        jcfg, tcfg = _configs(arch, over)
        np_params = jax_params_randomized(jcfg)
        jparams = jax.tree.map(jnp.asarray, np_params)
        rng = np.random.default_rng(3)
        tokens = rng.integers(1, jcfg.vocab_size, (len(LENS), S)).astype(
            np.int32)
        lens = np.asarray(LENS, np.int32)
        jm = JaxModel(jcfg)
        logits, cache = jm.prefill(jparams, jnp.asarray(tokens),
                                   max_seq=MAX_SEQ, lens=jnp.asarray(lens))
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
                     "tokens": torch.from_numpy(tokens),
                     "lens": torch.from_numpy(lens)}}
    return out


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """Every rank's results on each mesh."""
    cases = {name: r["case"] for name, r in reference.items()}
    return {shape: run_world(serve_world, 4, tmp_path_factory.mktemp(
        "serve"), shape, cases, MAX_SEQ, STEPS) for shape in MESHES}


def _rows(shape, data):
    b = len(LENS) // shape[0]
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
    # slot 0 crosses into the second block of the sequence on (1, 4)
    assert LENS[0] < MAX_SEQ // 4 <= LENS[0] + STEPS - 1


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
                    atol=TOL * float(np.abs(want).max()),  # 0s exactly
                    err_msg=f"{name} {shape} {when} {leaf} rank "
                            f"({r['data']}, {r['model']})")
            np.testing.assert_array_equal(r[when]["pos"].numpy(),
                                          reference[name][when]["pos"][rows])


@pytest.mark.parametrize("name", list(CASES))
def test_world_of_one_is_the_unsplit_path(reference, name):
    """On the mesh of one process nothing is gathered or split: the
    serving steps are the model's own calls, bit for bit."""
    case = reference[name]["case"]
    model = build_model(_configs(case["arch"], case["over"])[1], "cpu")
    params, tokens, lens = case["params"], case["tokens"], case["lens"]
    art = make_serve_artifacts(model, local_mesh("cpu"), Plan(), len(LENS),
                               MAX_SEQ)
    with torch.no_grad():
        a, ca = art.prefill_fn(params, tokens, lens=lens)
        b, cb = model.prefill(params, tokens, max_seq=MAX_SEQ, lens=lens)
        for _ in range(3):
            assert torch.equal(a, b)
            assert all(torch.equal(ca[k], cb[k]) for k in ("k", "v", "pos"))
            nxt = a.argmax(-1).to(torch.int32)[:, None]
            a, ca = art.decode_fn(params, ca, nxt)
            b, cb = model.decode_step(params, cb, nxt)
        assert torch.equal(a, b)


def test_kv_blocks_decode_matches_the_whole_read(reference):
    """``kv_blocks`` on one device: the cache read in 4 blocks of 256 and
    merged as the split merges its ranks' blocks gives the whole read's
    tokens, and its logits and cache within 1e-5 of their max |x|."""
    case = reference["heads"]["case"]
    model = build_model(_configs(case["arch"], case["over"])[1], "cpu")
    params = case["params"]
    with torch.no_grad():
        logits, whole = model.prefill(params, case["tokens"],
                                      max_seq=MAX_SEQ, lens=case["lens"])
        blocks = {k: v.clone() for k, v in whole.items()}
        a = b = logits
        for _ in range(STEPS):
            nxt = a.argmax(-1).to(torch.int32)[:, None]
            assert torch.equal(nxt, b.argmax(-1).to(torch.int32)[:, None])
            a, whole = model.decode_step(params, whole, nxt)
            b, blocks = model.decode_step(params, blocks, nxt, kv_blocks=4)
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0,
                                       atol=TOL * float(a.abs().max()))
        for k in ("k", "v"):  # a later layer's K/V from the merged rows
            np.testing.assert_allclose(
                blocks[k].numpy(), whole[k].numpy(), rtol=0,
                atol=TOL * float(whole[k].abs().max()))
        assert torch.equal(whole["pos"], blocks["pos"])


def test_merge_partials_is_one_softmax_over_the_blocks():
    """Blocks' partials merged equal the attention over their
    concatenation, an empty block (``lse = -inf``, ``out = 0``) among
    them; the float32 sums in another order within 1e-6."""
    g = torch.Generator().manual_seed(0)
    B, H, KH, D, T, n = 3, 6, 2, 16, 40, 4
    q = torch.randn(B, 1, H, D, generator=g)
    k = torch.randn(B, n * T, KH, D, generator=g)
    v = torch.randn(B, n * T, KH, D, generator=g)
    kv_len = torch.tensor([1, 75, 119])  # slot 0: one position; block 3 empty
    valid = torch.arange(n * T)[None] < kv_len[:, None]
    parts = [kref.decode_attention_partial(
        q, k[:, i * T:(i + 1) * T], v[:, i * T:(i + 1) * T],
        valid[:, i * T:(i + 1) * T]) for i in range(n)]
    out = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    assert torch.isneginf(lse[3]).all() and not out[3].any()
    assert not torch.isnan(out).any()
    got = kref.merge_partials(out, lse)
    want = kref.attention(q, k, v, causal=False, kv_len=kv_len)[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    # every block empty: 0, never NaN
    none = kref.merge_partials(out[3:], lse[3:])
    assert torch.equal(none, torch.zeros_like(none))


def test_split_decode_refuses_a_cache_laid_out_otherwise():
    """No fallback: a cache whose sequence the layout does not split over
    ``model`` (fewer than 1024 positions) is refused by the serving
    layouts, and a split step that meets a cache of another size raises
    instead of gathering it whole."""
    model = build_model(reduced(get_config("qwen2-1.5b")), "cpu")
    mesh = {"data": 1, "model": 4}
    for max_seq in (512, 2048):
        sh = cache_specs_sharding(model.cache_specs(4, max_seq), mesh,
                                  Plan(), 4, max_seq)
        if max_seq < 1024:
            with pytest.raises(ValueError, match="alone are split"):
                _check_seq_split(sh, max_seq)
        else:
            _check_seq_split(sh, max_seq)
    split = tensor.Split(_FakeMesh(4), None, frozenset(), cache_seq=2048)
    assert split.cache_block(2048) == 512
    with pytest.raises(ValueError, match="serving layout splits"):
        split.cache_block(1024)
    with pytest.raises(ValueError, match="serving layout splits"):
        tensor.Split(_FakeMesh(4)).cache_block(2048)


def test_other_families_keep_their_refusal():
    """What stays refused: hymba's and the xLSTM's ``long_500k`` layout
    (a batch of 1 the data axes do not split, so the K/V sequence goes
    over the data axes and ``model`` together and the states over
    ``model``), naming the ROADMAP entry.  At a batch the data axes
    split, whisper's, hymba's and the xLSTM's layouts are served."""
    mesh = _FakeMesh(4, data=2)
    for arch in ("hymba-1.5b", "xlstm-125m"):
        model = build_model(reduced(get_config(arch)), "cpu")
        with pytest.raises(NotImplementedError,
                           match="sharded serving cells"):
            make_serve_artifacts(model, mesh, Plan(), 1, 2048)
    for arch in ("hymba-1.5b", "xlstm-125m", "whisper-large-v3"):
        model = build_model(reduced(get_config(arch)), "cpu")
        make_serve_artifacts(model, mesh, Plan(), 4, 2048)


class _FakeMesh:
    """Sizes and this rank's place of a (data, m) mesh, with no group."""

    def __init__(self, m, data=1):
        self.shape = {"data": data, "model": m}

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        return 0
