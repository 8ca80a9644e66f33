"""The port's dense compute split over ``model`` (tensor and context
parallelism) against the reference's unsharded step, on the CPU.

One spawned gloo world of 4 ranks as a (1, 4) ("data", "model") mesh
(``torch_worlds.tensor_world``), from the reference's own init (bridged
through numpy), two steps each of:

  * ``heads``: reduced qwen2-1.5b in float32 with attention split by
    heads (1 query head a rank against its KV head), the MLP by its
    hidden dim (``d_ff`` 128, 32 a rank) and the tied embedding, head and
    loss by vocab blocks (256, 64 a rank);
  * ``seq``: the same under ``seq_shard_attn`` (context parallelism: 4
    query rows a rank of the 16, through K1's ``q_offset``);
  * ``straddle``: 12 query heads over 6 KV heads (3 local heads over 2
    KV heads, in groups of 2 and 1: one K/V head a query head) with an
    untied head (``lm_head`` split by vocab);
  * ``vlm``: reduced phi-3-vision (the dense split, image embeddings
    over the first 4 positions after the vocab-parallel embedding's sum);
  * ``whisper``: reduced whisper-large-v3 at remat ``full``, its
    encoder's and decoder's self-attention and its cross attention by
    heads, its MLPs by their hidden dim, and a vocab of 250, which
    divides no ``model`` axis of 4 (as 51866 does not): the embedding
    and head held alike by every rank, not split;
  * ``whisper_seq``: the same under ``seq_shard_attn`` with 6 encoder
    frames: the decoder's self-attention and the cross attention by the
    decoder's query rows (the cross attention's rows against every
    frame), the encoder's attention not split (6 frames do not split
    over 4 ranks) and its leaves' gradients not summed over ``model``;
  * ``hymba``: reduced hymba under ``seq_shard_attn`` with a window of 4
    (its window layer through K1's ``window`` with ``q_offset``), its
    MLP by its hidden dim and its SSM heads by their channels (K5 on 32
    of the 128 channels a rank);
  * ``hymba_heads``: reduced hymba with attention by heads;

and one step of ``heads`` with ``collectives.reduce_sum`` and
``collectives.all_gather_dim`` counted.  Besides, on the local mesh of
one process (no spawn), the split step in both modes is the unsharded
step bit for bit.  The (2, 2) world of ``tests/test_torch_parallel.py``
runs its qwen2 and phi3.5-moe cases through the split too.

Tolerances, those of ``tests/test_torch_parallel.py``, each with its
reason:

  * every step's loss, ce, grad_norm and lr rtol 1e-5 of the reference's
    (float32 sums in another order: the split products' terms summed over
    ranks, the loss's log-sum-exp from the vocab blocks' maxima and sums);
  * every leaf of the final state within 1e-5 of its max |x| of the
    reference's (AdamW's ``eps`` 1e-3, as tests/test_torch_compression.py
    says why);
  * the local mesh and the collectives' counts exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.parallel.sharding import Plan as JPlan
from repro_torch.bridge import from_jax_train_state
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ref as kref
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import build_model
from repro_torch.models.attention import _kv_heads, _proj
from repro_torch.parallel import tensor
from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                               make_train_artifacts, make_train_step)
from repro_torch.configs.base import ShapeConfig
from repro_torch.tree import flatten, tree_map
from test_torch_compression import OPT, assert_state_matches, reference_run
from torch_worlds import run_world, tensor_world

STEPS = 2
QWEN = "qwen2-1.5b"
STRADDLE = {"num_heads": 12, "num_kv_heads": 6, "tie_embeddings": False}
VLM, WHISPER, HYMBA = "phi-3-vision-4.2b", "whisper-large-v3", "hymba-1.5b"
CASES = {
    "heads": (QWEN, {}, {"remat": "none"}),
    "seq": (QWEN, {}, {"remat": "none", "seq_shard_attn": True}),
    "straddle": (QWEN, STRADDLE, {"remat": "none"}),
    "vlm": (VLM, {}, {"remat": "none"}),
    "whisper": (WHISPER, {"vocab_size": 250}, {"remat": "full"}),
    "whisper_seq": (WHISPER, {"encoder_frames": 6},
                    {"remat": "none", "seq_shard_attn": True}),
    "hymba": (HYMBA, {"sliding_window": 4},
              {"remat": "none", "seq_shard_attn": True}),
    "hymba_heads": (HYMBA, {}, {"remat": "full"}),
}
B, S = 4, 16
COUNTED = ("heads", "hymba", "whisper")


def _batches(seed=1, arch=QWEN, over=None):
    """The global batches of a case: tokens, and the VLM's image
    embeddings or the encoder-decoder's frames."""
    cfg = dataclasses.replace(reduced(get_config(arch)), **(over or {}))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        if cfg.family == "vlm":
            b["image_embeds"] = (rng.standard_normal(
                (B, cfg.num_image_tokens, cfg.d_model)) * 0.5
            ).astype(np.float32)
        if cfg.is_encoder_decoder:
            b["frames"] = (rng.standard_normal(
                (B, cfg.encoder_frames, cfg.d_model)) * 0.5
            ).astype(np.float32)
        out.append(b)
    return out


def _job(arch, over, plan, init, batches):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32",
                              **over)
    return dict(arch=arch, over=over, plan=plan, opt=OPT,
                state=from_jax_train_state(init, cfg, "cpu"),
                batches=[{k: torch.from_numpy(v) for k, v in b.items()}
                         for b in batches])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    refs, jobs, inits = {}, {}, {}
    for name, (arch, over, plan) in CASES.items():
        batches = _batches(1, arch, over)
        key = (arch,) + tuple(sorted(over.items()))
        if key not in inits:  # the reference's unsharded step: no split
            inits[key] = reference_run(arch, over, JPlan(remat="none"),
                                       batches, STEPS)
        init, refs[name] = inits[key]
        jobs[name] = _job(arch, over, plan, init, batches)
    # the counted steps on states of their own (the steps update in place)
    count = {name: _job(*CASES[name], inits[(CASES[name][0],) + tuple(
        sorted(CASES[name][1].items()))][0], _batches(1, *CASES[name][:2]))
        for name in COUNTED}
    res = run_world(tensor_world, 4, tmp_path_factory.mktemp("world"),
                    (1, 4), jobs, count)
    return refs, res


@pytest.mark.parametrize("case", list(CASES))
def test_split_steps_match_reference(world, case):
    refs, res = world
    got = res[0]["train"][case]
    for i, (_, want) in enumerate(refs[case]):
        for name in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(got["metrics"][i][name], want[name],
                                       rtol=1e-5, err_msg=f"{name} {i}")
    assert_state_matches(got["whole"], refs[case][-1][0])


def test_split_leaves_stay_local(world):
    """Each rank's blocks of the split leaves are its named slices of the
    gathered state: its head of ``wq``/``wo``, its columns of the MLP,
    its vocab rows of ``embed``."""
    _, res = world
    whole = dict(flatten(res[0]["train"]["heads"]["whole"]))
    for rank, out in enumerate(res):
        local = dict(flatten(out["train"]["heads"]["local"]))
        for key, dim in (("params/blocks/attn_wq", 2),
                         ("params/blocks/attn_wo", 1),
                         ("params/blocks/mlp_wu", 2),
                         ("params/blocks/mlp_wd", 1), ("params/embed", 0)):
            want = whole[key]
            n = want.shape[dim] // 4
            assert local[key].shape[dim] == n, key
            assert torch.equal(local[key], want.narrow(dim, rank * n, n)), \
                (rank, key)


@pytest.mark.parametrize("case,key,dim", [
    ("hymba", "params/blocks/ssm_w_in", 2),
    ("hymba", "params/blocks/ssm_A_log", 1),
    ("hymba", "params/blocks/ssm_w_out", 1),
    ("hymba", "params/blocks/ssm_D", 1),
    ("hymba_heads", "params/blocks/attn_wq", 2),
    ("whisper", "params/blocks/xattn_wq", 2),
    ("whisper", "params/enc_blocks/attn_wo", 1),
    ("whisper", "params/enc_blocks/mlp_wd", 1),
    ("whisper", "params/embed", None),
    ("vlm", "params/embed", 0)])
def test_new_regions_stay_local(world, case, key, dim):
    """The regions this split adds keep their leaves' blocks local: the
    SSM's channels, the cross attention's and the encoder's heads, the
    VLM's vocab; a vocab of 250, which no layout splits over 4 ranks, is
    held whole by every rank."""
    _, res = world
    want = dict(flatten(res[0]["train"][case]["whole"]))[key]
    for rank, out in enumerate(res):
        got = dict(flatten(out["train"][case]["local"]))[key]
        if dim is not None:
            n = want.shape[dim] // 4
            want_r = want.narrow(dim, rank * n, n)
        else:
            want_r = want
        assert got.shape == want_r.shape and torch.equal(got, want_r), \
            (rank, key)


def test_heads_mode_collectives(world):
    """One step in heads mode: two forward ``reduce_sum``s over ``model``
    a layer (attention's output projection and the MLP's down
    projection), one for the embedding and two for the loss (the sums of
    exponentials and the target's logit); no all-gather over ``model``
    at all (``wq``, ``wo``, the MLP, ``embed`` stay split; the rest is
    held whole)."""
    _, res = world
    calls = res[0]["calls"]["heads"]
    cfg = reduced(get_config(QWEN))
    D, L = cfg.d_model, cfg.num_layers
    sums = [c for c in calls if c[0] == "reduce_sum"]
    assert all(c[1] == ("model",) for c in sums), sums
    shapes = [c[2] for c in sums]
    assert shapes.count((B, S, D)) == 2 * L, shapes
    assert shapes.count((B * S, D)) == 1, shapes  # the embedding
    assert shapes.count((B, S - 1)) == 2, shapes  # the loss
    assert len(shapes) == 2 * L + 3, shapes
    gathers = [c for c in calls if c[0] == "all_gather_dim"
               and "model" in c[1]]
    assert not gathers, gathers


def test_new_regions_collectives(world):
    """One step each of ``hymba`` (attention by the sequence, the SSM by
    its channels) and ``whisper`` (by heads, a vocab no rank splits),
    with ``reduce_sum`` and ``all_gather_dim`` counted.  hymba, a layer:
    the SSM's B, C and low-rank dt products in one sum ``(B, S, 2N +
    16)``, the SSM's output and the MLP's ``(B, S, D)``, attention's rows
    gathered back over ``model`` once (``(B, S/4, H, Dh)``), its leaves
    gathered over ``model`` (``wq``'s heads, ``wo``'s heads: laid out on
    ``model``, read whole); plus the embedding and the loss's two sums.
    whisper, a layer: attention's and the MLP's sums, and the decoder's
    cross attention's; no vocab sum, no gather over ``model``."""
    _, res = world
    hcfg = dataclasses.replace(reduced(get_config(HYMBA)),
                               **CASES["hymba"][1])
    D, L, N = hcfg.d_model, hcfg.num_layers, hcfg.ssm_state
    calls = res[0]["calls"]["hymba"]
    sums = [c[2] for c in calls if c[0] == "reduce_sum"]
    assert sums.count((B, S, 2 * N + 16)) == L, sums
    assert sums.count((B, S, D)) == 2 * L, sums
    assert sums.count((B * S, D)) == 1 and sums.count((B, S - 1)) == 2
    assert len(sums) == 3 * L + 3, sums
    rows = [c for c in calls if c[0] == "all_gather_dim"
            and c[1] == ("model",) and c[2][:2] == (B, S // 4)]
    assert len(rows) == L, calls
    wcfg = reduced(get_config(WHISPER))
    calls = res[0]["calls"]["whisper"]
    sums = [c[2] for c in calls if c[0] == "reduce_sum"]
    # remat full recomputes the decoder's blocks (not the encoder's), up
    # to the last tensor the backward reads (checkpoint's early stop):
    # the MLP's sum is not recomputed
    Le, Ld = wcfg.encoder_layers, wcfg.num_layers
    assert sums.count((B, wcfg.encoder_frames, D)) == 2 * Le, sums
    assert sums.count((B, S, D)) == 3 * Ld + 2 * Ld, sums
    assert len(sums) == 2 * Le + 5 * Ld, sums
    assert not [c for c in calls if c[0] == "all_gather_dim"
                and "model" in c[1]], calls


@pytest.mark.parametrize("seq_shard", [False, True], ids=["heads", "seq"])
def test_local_mesh_split_is_unsharded_step(seq_shard):
    """On the local mesh of one process the split context is installed
    and splits nothing: the step's bits are the unsharded step's."""
    cfg = dataclasses.replace(reduced(get_config(QWEN)), dtype="float32")
    model = build_model(cfg, "cpu")
    opt = OptimizerConfig(**OPT)
    plan = Plan(remat="full", seq_shard_attn=seq_shard)
    state = init_train_state(model, 0, opt)
    copy = tree_map(lambda x: x.detach().clone(), state)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(2)]
    art = make_train_artifacts(model, local_mesh("cpu"), plan, opt,
                               ShapeConfig("t", S, B, "train"))
    step = make_train_step(model, opt, plan)
    for b in batches:
        state, ma = step(state, b)
        copy, mb = art.step_fn(copy, b)
        for name in ("loss", "ce", "tokens", "grad_norm", "lr"):
            assert torch.equal(ma[name], mb[name]), name
    for (key, x), (_, y) in zip(flatten(state), flatten(copy)):
        assert torch.equal(x, y), key


@pytest.mark.parametrize("H,KH,m", [(4, 2, 4), (12, 6, 4), (48, 8, 4),
                                    (12, 2, 8), (8, 8, 2), (10, 5, 2)])
def test_local_kv_heads(H, KH, m):
    """Each rank's K/V heads are the ones its query heads read: attention
    of its heads against them equals those heads of the whole attention
    (GQA through K1's plain version), in groups or one a query head."""
    cfg = dataclasses.replace(reduced(get_config(QWEN)), num_heads=H,
                              num_kv_heads=KH, qkv_bias=True)
    g = torch.Generator().manual_seed(H * KH + m)
    D, Dh = cfg.d_model, cfg.head_dim
    p = {n: torch.randn(shape, generator=g) for n, shape in (
        ("attn_wq", (D, H, Dh)), ("attn_wk", (D, KH, Dh)),
        ("attn_wv", (D, KH, Dh)), ("attn_bq", (H, Dh)), ("attn_bk", (KH, Dh)),
        ("attn_bv", (KH, Dh)))}
    x = torch.randn((2, 8, D), generator=g)
    q = torch.einsum("bsd,dhk->bshk", x, p["attn_wq"]) + p["attn_bq"]
    k = torch.einsum("bsd,dhk->bshk", x, p["attn_wk"]) + p["attn_bk"]
    v = torch.einsum("bsd,dhk->bshk", x, p["attn_wv"]) + p["attn_bv"]
    whole = kref.attention(q, k, v, causal=True)
    hl = H // m
    for r in range(m):
        kv, idx = _kv_heads(p, cfg, r * hl, hl, "attn")
        kl = _proj(x, kv["wk"]) + kv["bk"]
        vl = _proj(x, kv["wv"]) + kv["bv"]
        if idx is not None:
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        got = kref.attention(q[:, :, r * hl:(r + 1) * hl], kl, vl,
                             causal=True)
        torch.testing.assert_close(got, whole[:, :, r * hl:(r + 1) * hl],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn,regions,want", [
    ("heads", {"attn", "mlp", "vocab"},
     {"attn_wk", "attn_wv", "attn_bk", "attn_bv", "attn_qnorm"}),
    ("seq", {"attn", "mlp", "vocab"},
     {"attn_wq", "attn_bq", "attn_wo", "attn_wk", "attn_wv", "attn_bk",
      "attn_bv", "attn_qnorm"}),
    (None, {"mlp"}, set())])
def test_partial_leaves_follow_the_regions(attn, regions, want):
    """The leaves whose gradient the step sums over ``model``: every leaf
    a split region reads and keeps whole, found from the regions' names
    and the layouts alone (a leaf added to a region, here a made-up
    ``attn_qnorm``, included with no table to update)."""
    mesh = dataclasses.make_dataclass("M", [])()
    mesh.size = lambda axis: 4
    names = ("attn_wq", "attn_bq", "attn_wo", "attn_wk", "attn_wv",
             "attn_bk", "attn_bv", "attn_qnorm", "mlp_wg", "mlp_wu",
             "mlp_wd", "embed", "lm_head", "norm1_g", "final_g", "router",
             "moe_wg", "fuse_attn")
    axes = {"attn_wq": ("embed", "heads", "head_dim"),
            "attn_bq": ("heads", "head_dim"),
            "attn_wo": ("heads", "head_dim", "embed"),
            "mlp_wg": ("embed", "mlp"), "mlp_wu": ("embed", "mlp"),
            "mlp_wd": ("mlp", "embed"), "embed": ("vocab", "embed"),
            "lm_head": ("embed", "vocab"), "moe_wg": ("experts", "mlp")}
    sp = tensor.Split(mesh, attn, frozenset(regions))
    got = set()
    for name in names:
        ax = axes.get(name, ("embed",))
        spec = [("model",) if a in ("heads", "mlp", "vocab") else ()
                for a in ax]
        kept = tensor.kept_dim(name, ax, spec, attn == "heads") is not None
        if sp.partial(name, kept):
            got.add(name)
    assert got == want


@pytest.mark.parametrize("H,m,S,seq_shard,want", [
    (12, 4, 4096, False, "heads"), (12, 8, 4096, True, "seq"),
    (12, 8, 4096, False, None), (12, 8, 12, True, None),
    (12, 4, 6, True, None), (4, 4, 8, True, "seq")])
def test_attn_mode_is_the_references_rule(H, m, S, seq_shard, want):
    """Heads when they divide ``model`` and the plan does not ask for
    the sequence split; under ``seq_shard_attn`` the sequence when the
    reference's ``hints.attn_q`` splits it (``S % m == 0``, ``S >=
    2m``); else attention is not split."""
    cfg = dataclasses.replace(reduced(get_config(QWEN)), num_heads=H)
    assert tensor.attn_mode(cfg, Plan(seq_shard_attn=seq_shard), m, S) \
        == want


def test_unseen_keys_get_exact_zero_gradients():
    """K1-bwd's plain version at a context-parallel rank's shape: the
    keys past the block's last query get dK and dV exactly 0."""
    g = torch.Generator().manual_seed(5)
    q, do = (torch.randn((1, 8, 4, 16), generator=g) for _ in range(2))
    k, v = (torch.randn((1, 32, 2, 16), generator=g) for _ in range(2))
    for off in (0, 8, 24):
        out, lse = kref.attention_fwd(q, k, v, causal=True, q_offset=off)
        _, dk, dv = kref.attention_bwd(q, k, v, out, lse, do, causal=True,
                                       q_offset=off)
        assert torch.count_nonzero(dk[:, off + 8:]) == 0
        assert torch.count_nonzero(dv[:, off + 8:]) == 0
        assert torch.count_nonzero(dk[:, :off + 8]) > 0
