"""The port's sharded train step and expert-parallel MoE on spawned gloo
worlds on the CPU, against the reference's unsharded step.

Two worlds, each one spawn of ``torch_worlds.parallel_world``: 2 ranks
as a (2, 1) ("data", "model") mesh (data parallel), and 4 ranks as
(2, 2).  In each, from the reference's own init (bridged through numpy),
two steps of:

  * reduced qwen2-1.5b in float32 with ``d_ff`` 8192, so that the MLP
    weights pass FSDP's 2^20-element floor and are split over "data" (a
    reduce-scatter) as well as over "model" (``mlp_wd``'s last dim is
    split off the compression's 256-element blocks: it is gathered for
    the compression);
  * reduced phi3.5-moe in float32 (``d_ff`` 2048: the expert weights
    split over "model" on their experts dim and over "data" by FSDP) with
    ``moe_impl="shard_map"`` at capacity factor 8 and remat ``full``;
  * reduced phi-3-vision, whisper-large-v3 and hymba-1.5b in float32
    with ``d_ff`` 8192 (their MLPs split over "data" by FSDP too), at
    remat ``full``, ``none`` and ``full``: on (2, 2) split over "model"
    (attention and the MLP, the VLM's vocab, whisper's cross attention,
    hymba's SSM heads by their channels), on (2, 1) data parallel, each
    layer's leaves gathered in the layer;
  * on (2, 1) qwen2 at microbatch 2 (each rank holds its rows of both
    microbatches), on (2, 2) qwen2 with ``compress_grads``.

Tolerances, each with its reason:

  * every step's loss, ce, grad_norm and lr rtol 1e-5 of the reference's
    (float32 sums over other splits of the batch);
  * every leaf of the final state within 1e-5 of its max |x| of the
    reference's (with compression, up to rounding flips: see
    tests/test_torch_compression.py; here fewer than 1 element in 100:
    the split batch moves each gradient by about 5e-7 of its leaf's max,
    which flips the rounding of elements in blocks whose own max is far
    below the leaf's, 0.46% of the state at (2, 2)); AdamW's ``eps``
    1e-3, as there;
  * the mesh's compression alone, bit for bit: a gradient and an error
    made from a seed, split by the parameters' layouts, compressed on
    each rank's blocks and gathered, against the compression of each
    whole leaf (the blocks of the global last axis; bit for bit the
    reference's, tests/test_torch_compression.py);
  * each rank's block of each leaf equal, bit for bit, to the slice of
    the gathered leaf that its layout names;
  * the expert-parallel layer alone (``loss = sum(out**2) + aux``, one
    layer of reduced phi3.5-moe at factor 8) against the reference's
    scatter layer on the whole batch: out within 1e-5, aux rtol 1e-5,
    every parameter's gradient within 2e-4, the reference's own
    tolerances for its shard_map test (``tests/test_moe.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import moe as jmoe
from repro.parallel.sharding import Plan as JPlan
from repro_torch.bridge import from_jax_train_state
from repro_torch.configs import get_config, reduced
from repro_torch.train import compression
from repro_torch.tree import flatten
from test_torch_compression import OPT, assert_state_matches, reference_run
from torch_worlds import parallel_world, run_world

STEPS = 2
QWEN, MOE = "qwen2-1.5b", "phi3.5-moe-42b-a6.6b"
CASES = {
    "dense": (QWEN, {"d_ff": 8192}, {"remat": "none"}),
    "moe": (MOE, {"d_ff": 2048, "moe_capacity_factor": 8.0},
            {"remat": "full", "moe_impl": "shard_map"}),
    "vlm": ("phi-3-vision-4.2b", {"d_ff": 8192}, {"remat": "full"}),
    "whisper": ("whisper-large-v3", {"d_ff": 8192}, {"remat": "none"}),
    "hymba": ("hymba-1.5b", {"d_ff": 8192}, {"remat": "full"}),
}
SPLIT = ("vlm", "whisper", "hymba")
VARIANT = {(2, 1): (QWEN, {"d_ff": 8192}, {"remat": "none", "microbatch": 2}),
           (2, 2): (QWEN, {"d_ff": 8192},
                    {"remat": "none", "compress_grads": True})}
LAYER_OVER = {"moe_capacity_factor": 8.0}


def _batches(seed=1, B=4, S=16, arch=QWEN):
    """Tokens, and the VLM's image embeddings or the encoder-decoder's
    frames."""
    cfg = reduced(get_config(arch))
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32)}
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


def _layer_inputs():
    cfg = dataclasses.replace(reduced(get_config(MOE)), dtype="float32",
                              **LAYER_OVER)
    rng = np.random.default_rng(3)
    D, E, F = cfg.d_model, cfg.num_experts, cfg.d_ff
    p = {"router": rng.standard_normal((D, E)) * 0.1,
         "moe_wg": rng.standard_normal((E, D, F)) * 0.05,
         "moe_wu": rng.standard_normal((E, D, F)) * 0.05,
         "moe_wd": rng.standard_normal((E, F, D)) * 0.05}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return p, (rng.standard_normal((4, 16, D)) * 0.5).astype(np.float32)


_REFS = {}


def _reference(arch, over, plan, batches):
    """The reference's run of a case (cached: both worlds share cases)."""
    key = (arch, tuple(sorted(over.items())), tuple(sorted(plan.items())))
    if key not in _REFS:
        jplan = JPlan(**dict(plan, moe_impl="scatter"))
        _REFS[key] = reference_run(arch, over, jplan, batches, STEPS)
    return _REFS[key]


@pytest.fixture(scope="module", params=[(2, 1), (2, 2)],
                ids=lambda s: "x".join(map(str, s)))
def world(request, tmp_path_factory):
    shape = request.param
    cases = dict(CASES, variant=VARIANT[shape])
    refs, jobs = {}, {}
    for name, (arch, over, plan) in cases.items():
        batches = _batches(arch=arch)
        init, ref = _reference(arch, over, plan, batches)
        refs[name] = ref
        cfg = dataclasses.replace(reduced(get_config(arch)),
                                  dtype="float32", **over)
        jobs[name] = dict(arch=arch, over=over, plan=plan, opt=OPT,
                          state=from_jax_train_state(init, cfg, "cpu"),
                          batches=[{k: torch.from_numpy(v)
                                    for k, v in b.items()}
                                   for b in batches])
    p, x = _layer_inputs()
    layer = {"over": LAYER_OVER, "x": torch.from_numpy(x),
             "p": {k: torch.from_numpy(v) for k, v in p.items()}}
    gen = torch.Generator().manual_seed(11)
    split_leaf = {"w": torch.randn((4, 6, 8), generator=gen),
                  "x": torch.randn((4, 6), generator=gen)}
    res = run_world(parallel_world, shape[0] * shape[1],
                    tmp_path_factory.mktemp("world"), shape, jobs, layer,
                    split_leaf)
    return shape, refs, res, (p, x, split_leaf)


@pytest.mark.parametrize("case", ["dense", "moe", "variant", *SPLIT])
def test_sharded_steps_match_reference(world, case):
    _, refs, res, _ = world
    got = res[0]["train"][case]
    for i, (want_state, want) in enumerate(refs[case]):
        for name in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(got["metrics"][i][name], want[name],
                                       rtol=1e-5, err_msg=f"{name} {i}")
    assert_state_matches(got["whole"], refs[case][-1][0], flip_share=1e-2)


def test_local_blocks_are_the_named_slices(world):
    shape, _, res, _ = world
    split = 0
    for case in ("dense", "moe", "variant", *SPLIT):
        whole = dict(flatten(res[0]["train"][case]["whole"]))
        for rank_out in res:
            out = rank_out["train"][case]
            for key, block in flatten(out["local"]):
                spec, coords = out["places"][key]
                want = whole[key]
                for d, entry in enumerate(spec):
                    n, idx = 1, 0
                    for a in entry:
                        size = dict(zip(("data", "model"), shape))[a]
                        n, idx = n * size, idx * size + coords[a]
                    if n > 1:
                        step = want.shape[d] // n
                        want = want.narrow(d, idx * step, step)
                        split += 1
                assert torch.equal(block, want), (case, key)
    assert split > 0


def test_ep_moe_layer_matches_reference(world):
    _, _, res, (p, x, _) = world
    got = res[0]["layer"]
    cfg = dataclasses.replace(jreduced(jget_config(MOE)), dtype="float32",
                              **LAYER_OVER)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out, aux = jax.jit(lambda q: jmoe.apply_moe(q, jnp.asarray(x), cfg))(jp)

    def loss(q):
        o, a = jmoe.apply_moe(q, jnp.asarray(x), cfg)
        return (o ** 2).sum() + a

    grads = jax.jit(jax.grad(loss))(jp)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(out),
                               atol=1e-5)
    np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads"][k].numpy(), np.asarray(g),
                                   atol=2e-4, err_msg=k)


def test_mesh_compression_is_the_global_blocks(world):
    _, _, res, _ = world
    got = res[0]["train"]["dense"]["compressed"]
    for key, (g, e) in got["inputs"].items():
        g, e = g.clone(), e.clone()
        compression.compress_(g, e)  # the whole leaf's blocks
        assert torch.equal(got["g"][key], g), key
        assert torch.equal(got["e"][key], e), key


def test_layers_dim_split_leaf_gathers_a_layer_at_a_time(world):
    """A leaf whose ``layers`` dim FSDP splits over "data": each layer is
    read from the rank that holds it (every rank sees the same layer
    ``i``, its own block of the kept dim), and the gradient, summed over
    the data ranks, lands on that rank's block alone: the whole
    gradient equals autograd's on the whole leaf and batch (float32
    sums in another order: rtol 1e-5), each rank holding L/2 layers of
    it."""
    shape, _, res, (_, _, leaf) = world
    w, x = leaf["w"], leaf["x"]
    wg = w.clone().requires_grad_(True)
    loss = sum(((x @ wg[i]) ** 2).sum() for i in range(w.shape[0]))
    want, = torch.autograd.grad(loss, [wg])
    got = res[0]["split_leaf"]
    np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-5)
    torch.testing.assert_close(got["grad"], want, rtol=1e-5, atol=1e-5)
    m = shape[1]
    for out in res:
        assert out["split_leaf"]["local_shape"] == (2, 6, 8 // m)
        n = 8 // m
        c = out["split_leaf"]["model"]
        for i, seen in enumerate(out["split_leaf"]["seen"]):
            assert torch.equal(seen, w[i, :, c * n:(c + 1) * n]), i
