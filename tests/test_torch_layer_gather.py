"""The sharded train step's ZeRO-3 gather, one layer at a time
(``parallel/fsdp.py``), on the CPU.

  * On the local mesh of one process (no gathering installed) and under
    a gathering whose every leaf is trivial, the sharded step of each
    family is the unsharded step bit for bit.
  * On a fake (4, 4) world (one subprocess, as
    ``tests/test_torch_dryrun.py`` runs its fake worlds), the dry-run's
    count of reduced qwen2-1.5b and hymba-1.5b widened so that FSDP
    splits their leaves over "data" (hymba's SSM matrices on their
    ``layers`` dim), at L and 2L layers under remat ``full``:

    - the peak of temporaries grows by less than L layers' gathered
      leaves (a whole-model gather grows by them and by their
      gradients);
    - the gathered storages live at once never exceed one layer's
      gathered leaves and the leaves without a ``layers`` dim;
    - the all-gathers and reduce-scatters are those the layer loop
      implies: per layer, one all-gather a split dim of each leaf's
      slice (one more where the ``layers`` dim is split), twice (the
      forward and the recompute), and one reduce-scatter a leaf whose
      slice has one dim split over exactly its gradient's axes.

Counts are exact (integers); the peak bound is the layer loop's, stated
in each test.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import local_mesh
from repro_torch.models import build_model
from repro_torch.parallel import fsdp
from repro_torch.train import (OptimizerConfig, Plan, init_train_state,
                               make_train_artifacts, make_train_step)
from repro_torch.train.step import _Layout, make_grad_fn
from repro_torch.tree import flatten, leaves, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": f"{REPO}/src"}
B, S = 4, 16

# widths at which FSDP's 2^20-element floor splits the leaves over "data"
WIDE = {"d_model": 1024, "num_heads": 8, "num_kv_heads": 4, "head_dim": 128,
        "d_ff": 4096}
# (arch, overrides, layers L): hymba at 32 layers so that its (L, 2048,
# 16) SSM matrices reach the floor and split their ``layers`` dim
FAKE = {"qwen": ("qwen2-1.5b", WIDE, 2),
        "hymba": ("hymba-1.5b", dict(WIDE, sliding_window=16), 32)}
SEQ, BATCH = 32, 4

WORLD_CODE = r'''
import json, sys, weakref
import torch
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.cells import build_cell, count_cell, default_plan
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models.api import Model
from repro_torch.parallel import fsdp
from repro_torch.train.step import _Layout

FAKE, SEQ, BATCH = json.loads(sys.argv[1])
fake_world(16)
mesh = make_mesh((4, 4), device="cpu")
live, peak = {}, [0]
plain_gather = fsdp.gather


def gather(x, leaf):
    # the gathered storages alive at each gather
    out = plain_gather(x, leaf)
    if out is not x:
        st = out.untyped_storage()
        key = st._cdata
        live[key] = (weakref.ref(st), st.nbytes())
        peak[0] = max(peak[0], sum(n for r, n in live.values()
                                   if r() is not None))
    return out


fsdp.gather = gather
out = {}
for name, (arch, over, L) in FAKE.items():
    for n in (L, 2 * L):
        cfg = reduced(get_config(arch), **dict(over, num_layers=n))
        plan = default_plan(cfg, mesh)
        cell = build_cell(arch, "train_4k", mesh, plan, cfg=cfg,
                          shape=ShapeConfig("t", SEQ, BATCH, "train"))
        live.clear()
        peak[0] = 0
        st, _ = count_cell(cell)
        lay = _Layout(Model(cfg, mesh.device), mesh, plan)
        leaves = []
        for path, sh, lf in zip(lay.paths, lay.flat,
                                lay.leaf_plans(lay.split(SEQ))):
            leaves.append({"path": path, "shape": list(sh.shape),
                           "spec": [list(e) for e in sh.spec],
                           "keep": list(lf.keep), "axes": list(lf.axes)})
        out[f"{name}{n}"] = {
            "temp": st["temp_size_in_bytes"],
            "ops": st["collectives"]["op_count_by_kind"],
            "live_gathered": peak[0], "leaves": leaves}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def _world_proc():
    """The fake-world subprocess, started at the module's first test."""
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(WORLD_CODE),
         json.dumps([FAKE, SEQ, BATCH])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=ENV,
        cwd=REPO)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(autouse=True)
def _start(_world_proc):
    return _world_proc


_RESULT = {}


@pytest.fixture
def world(_world_proc):
    if "out" not in _RESULT:
        stdout, stderr = _world_proc.communicate(timeout=240)
        assert _world_proc.returncode == 0, stderr[-4000:]
        _RESULT["out"] = json.loads(stdout.strip().splitlines()[-1])
    return _RESULT["out"]


# ---------------------------------------------------------------------------
# a mesh of one: the unsharded step's bits
# ---------------------------------------------------------------------------
OPT = dict(lr=1e-3, eps=1e-3)
FAMILIES = [("qwen2-1.5b", "full"), ("phi-3-vision-4.2b", "full"),
            ("whisper-large-v3", "full"), ("hymba-1.5b", "none"),
            ("xlstm-125m", "full")]


def _batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    b = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                 dtype=torch.int32)}
    if cfg.family == "vlm":
        b["image_embeds"] = torch.randn(
            (B, cfg.num_image_tokens, cfg.d_model), generator=g) * 0.5
    if cfg.is_encoder_decoder:
        b["frames"] = torch.randn((B, cfg.encoder_frames, cfg.d_model),
                                  generator=g) * 0.5
    return b


def _model(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)), dtype="float32")
    return build_model(cfg, "cpu")


@pytest.mark.parametrize("arch,remat", FAMILIES)
def test_local_mesh_step_is_the_unsharded_step(arch, remat):
    """On the local mesh of one process no gathering is installed: two
    sharded steps are the unsharded steps bit for bit."""
    model = _model(arch)
    opt = OptimizerConfig(**OPT)
    plan = Plan(remat=remat)
    state = init_train_state(model, 0, opt)
    copy = tree_map(lambda x: x.detach().clone(), state)
    art = make_train_artifacts(model, local_mesh("cpu"), plan, opt,
                               ShapeConfig("t", S, B, "train"))
    step = make_train_step(model, opt, plan)
    for i in range(2):
        b = _batch(model.cfg, i)
        state, ma = step(state, b)
        copy, mb = art.step_fn(copy, b)
        for name in ("loss", "ce", "tokens", "grad_norm", "lr"):
            assert torch.equal(ma[name], mb[name]), name
    for (key, x), (_, y) in zip(flatten(state), flatten(copy)):
        assert torch.equal(x, y), key


@pytest.mark.parametrize("arch,remat", FAMILIES)
def test_trivial_gathering_is_the_unsharded_step(arch, remat):
    """Under a gathering whose every leaf is trivial (the local mesh's
    plans installed by hand) the model reads each layer's ``unbind``
    slices and each leaf as it is: the forward's loss and every
    gradient are the unsharded ones bit for bit."""
    model = _model(arch)
    mesh = local_mesh("cpu")
    plan = Plan(remat=remat)
    params = model.init(0)
    b = _batch(model.cfg, 3)
    loss, _, want = make_grad_fn(model, plan)(params, b)
    lay = _Layout(model, mesh, plan)
    plans = lay.leaf_plans(lay.split(S))
    assert all(p.trivial() for p in plans)
    local = leaves(params)
    with fsdp.installed(fsdp.Gathering(local, plans)):
        got_loss, _ = model.loss(params, b, remat=remat)
        got = torch.autograd.grad(got_loss, local)
        assert isinstance(fsdp.active(), fsdp.Gathering)
    assert torch.equal(loss, got_loss.detach())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# the fake (4, 4) world: per-rank memory and collectives
# ---------------------------------------------------------------------------
MESH = {"data": 4, "model": 4}


def _size(axes):
    return int(np.prod([MESH[a] for a in axes]))


def _layer_traffic(leaves):
    """Per layer: the gathered bytes of a layer's slices (float32), the
    all-gathers (one a non-kept split dim of a slice, one more where the
    ``layers`` dim is split) and the reduce-scatters (a slice with one
    dim split over exactly its gradient's axes); and the gathered bytes
    of the leaves without a ``layers`` dim."""
    per = {"bytes": 0, "all-gather": 0, "reduce-scatter": 0}
    other = 0
    for lf in leaves:
        spec, keep = lf["spec"], set(lf["keep"])
        stacked = lf["path"].startswith("blocks/")
        local = [d // _size(e) for d, e in zip(lf["shape"], spec)]
        if not stacked:
            other += 4 * int(np.prod([
                d if i in keep else d * _size(e)
                for i, (d, e) in enumerate(zip(local, spec))]))
            continue
        whole = [d if i + 1 in keep else d * _size(e)
                 for i, (d, e) in enumerate(zip(local[1:], spec[1:]))]
        per["bytes"] += 4 * int(np.prod(whole))
        per["all-gather"] += (_size(spec[0]) > 1) + sum(
            1 for i, e in enumerate(spec[1:])
            if i + 1 not in keep and _size(e) > 1)
        axes = lf["axes"]
        split = [i for i, e in enumerate(spec[1:]) if set(e) & set(axes)]
        if _size(axes) > 1 and len(split) == 1 and \
                set(spec[1 + split[0]]) == set(axes) \
                and split[0] + 1 not in keep:
            per["reduce-scatter"] += 1
    return per, other


@pytest.mark.parametrize("name", list(FAKE))
def test_fake_world_gathers_a_layer_at_a_time(world, name):
    L = FAKE[name][2]
    one, two = world[f"{name}{L}"], world[f"{name}{2 * L}"]
    per, other = _layer_traffic(one["leaves"])
    per2, other2 = _layer_traffic(two["leaves"])
    assert per == per2 and other == other2
    assert per["all-gather"] > 0 and per["reduce-scatter"] > 0
    # the layer loop's collectives, exactly: each layer's gathers twice
    # (forward, recompute), its reductions once; nothing else of the
    # leaves' is gathered or scattered (the vocab leaves stay split)
    for cell, n in ((one, L), (two, 2 * L)):
        assert cell["ops"]["all-gather"] == 2 * n * per["all-gather"]
        assert cell["ops"]["reduce-scatter"] == n * per["reduce-scatter"]
    # never more than one layer's gathered leaves (and the leaves
    # without a layers dim) alive at once
    assert 0 < two["live_gathered"] <= per["bytes"] + other
    assert one["live_gathered"] == two["live_gathered"]
    # L more layers cost less than their gathered leaves: what grows is
    # their local gradients' blocks and the remat boundaries
    assert 0 < two["temp"] - one["temp"] < L * per["bytes"]
