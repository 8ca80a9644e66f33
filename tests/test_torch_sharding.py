"""The port's sharding rules against the reference's, on the CPU.

The rules are pure functions of shapes and mesh sizes, so each is held
against the reference's own function on the same input, exactly:

  * every parameter's logical axes (the port's shape tables against the
    reference's ``Model.param_specs()``), for every config at
    ``reduced()`` and at full size;
  * ``param_spec`` on ``AbstractMesh`` shapes (4, 2), (16, 16) and
    (2, 16, 16) for every parameter of every config at full size, with
    the default plan, FSDP off and the data axes ("pod", "data");
  * ``batch_spec`` for every config's train and prefill inputs, and
    ``cache_spec`` for every leaf of the reference's decode caches;
  * a hypothesis property over random axes and shapes (the reference's
    ``tests/test_sharding.py`` property, here as equality with the
    reference plus its validity checks);
  * ``to_runtime_plan`` field by field over the catalog's choices.

A :class:`repro_torch.parallel.Sharding`'s spec is a tuple of mesh-axis
tuples per dim, ``()`` for none; the reference's ``PartitionSpec``
entries are normalised to the same form (None -> (), "a" -> ("a",)).
"""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.configs import reduced as jreduced
from repro.core import planner as jplanner
from repro.core.intent import ResourceIntent as JIntent
from repro.models import build_model as jbuild_model
from repro.parallel import sharding as jsharding
from repro_torch.configs import get_config, reduced
from repro_torch.core import planner, workflow
from repro_torch.core.intent import ResourceIntent
from repro_torch.models import build_model
from repro_torch.parallel import sharding
from repro_torch.tree import flatten

ARCH_NAMES = sorted(JARCHS)
MESHES = {(4, 2): ("data", "model"), (16, 16): ("data", "model"),
          (2, 16, 16): ("pod", "data", "model")}
PLANS = {"default": {}, "no_fsdp": {"fsdp": False}}
POD_PLAN = {"dp_axes": ("pod", "data"), "fsdp_axes": ("pod", "data")}


def _plans(axes_names):
    """The plans held on a mesh: the default and FSDP off, and on the
    3-D mesh the data axes ("pod", "data")."""
    out = list(PLANS.values())
    return out + [POD_PLAN] if "pod" in axes_names else out


def _norm(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _jspec(spec, ndim):
    out = tuple(_norm(e) for e in spec)
    return out + ((),) * (ndim - len(out))


def _jaxes(cfg):
    """The reference's ``{path: logical axes}`` of a config."""
    _, axes = jbuild_model(cfg).param_specs()
    flat = jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=lambda a: isinstance(a, tuple))[0]
    return {"/".join(str(k.key) for k in path): tuple(a) for path, a in flat}


def _jshapes(cfg):
    specs, _ = jbuild_model(cfg).param_specs()
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    return {"/".join(str(k.key) for k in path): tuple(s.shape)
            for path, s in flat}


def _port_axes(cfg):
    specs, axes = build_model(cfg, "cpu").param_specs()
    return ({k: tuple(v.shape) for k, v in flatten(specs)},
            dict(flatten(axes)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("size", ["reduced", "full"])
def test_logical_axes_match_reference(arch, size):
    jcfg = JARCHS[arch] if size == "full" else jreduced(JARCHS[arch])
    cfg = get_config(arch) if size == "full" else reduced(get_config(arch))
    shapes, axes = _port_axes(cfg)
    assert axes == _jaxes(jcfg)
    assert shapes == _jshapes(jcfg)


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("mesh_shape", list(MESHES),
                         ids=lambda s: "x".join(map(str, s)))
def test_param_spec_matches_reference(arch, mesh_shape):
    axes_names = MESHES[mesh_shape]
    jmesh = AbstractMesh(mesh_shape, axes_names)
    sizes = dict(zip(axes_names, mesh_shape))
    shapes, axes = _port_axes(get_config(arch))
    for kw in _plans(axes_names):
        jplan, plan = jsharding.Plan(**kw), sharding.Plan(**kw)
        for path, shape in shapes.items():
            want = _jspec(jsharding.param_spec(axes[path], shape, jmesh,
                                               jplan), len(shape))
            got = sharding.param_spec(axes[path], shape, sizes, plan)
            assert got == want, (path, kw)


@pytest.mark.parametrize("mesh_shape", list(MESHES),
                         ids=lambda s: "x".join(map(str, s)))
def test_batch_and_cache_specs_match_reference(mesh_shape):
    axes_names = MESHES[mesh_shape]
    jmesh = AbstractMesh(mesh_shape, axes_names)
    sizes = dict(zip(axes_names, mesh_shape))
    for kw in _plans(axes_names):
        jplan, plan = jsharding.Plan(**kw), sharding.Plan(**kw)
        for arch in ARCH_NAMES:
            jmodel = jbuild_model(JARCHS[arch])
            for shape in JSHAPES.values():
                for b in (shape.global_batch, 1, 8):
                    sdt = jax.ShapeDtypeStruct((b, shape.seq_len), np.int32)
                    want = jsharding.batch_specs({"t": sdt}, jmesh, jplan)
                    got = sharding.batch_spec((b, shape.seq_len), sizes,
                                              plan)
                    assert got == _jspec(want["t"].spec, 2)
            for batch, max_seq in ((8, 4096), (1, 32768)):
                cache = jmodel.cache_specs(batch, max_seq)
                want = jsharding.cache_specs_sharding(cache, jmesh, jplan,
                                                      batch, max_seq)
                for leaf, w in zip(jax.tree.leaves(cache),
                                   jax.tree.leaves(want)):
                    got = sharding.cache_spec(tuple(leaf.shape), sizes,
                                              plan, batch, max_seq)
                    assert got == _jspec(w.spec, len(leaf.shape)), (
                        arch, leaf.shape, kw)


pytest.importorskip("hypothesis", reason="property tests need hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

LOGICAL = ["embed", "heads", "kv_heads", "head_dim", "mlp", "vocab",
           "experts", "layers", None]


@given(
    ndim=st.integers(1, 4),
    dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 20, 25, 64,
                                   151, 1024, 4096]),
                  min_size=4, max_size=4),
    names=st.lists(st.sampled_from(LOGICAL), min_size=4, max_size=4),
    fsdp=st.booleans(),
)
@settings(max_examples=200, deadline=None)
def test_param_spec_property_matches_reference(ndim, dims, names, fsdp):
    """The reference's property (every spec divisibility-correct, no mesh
    axis used twice) and equality with the reference's spec."""
    jmesh = AbstractMesh((4, 2), ("data", "model"))
    shape, axes = tuple(dims[:ndim]), tuple(names[:ndim])
    spec = sharding.param_spec(axes, shape, {"data": 4, "model": 2},
                               sharding.Plan(fsdp=fsdp))
    assert spec == _jspec(jsharding.param_spec(
        axes, shape, jmesh, jsharding.Plan(fsdp=fsdp)), ndim)
    used = []
    for entry, dim in zip(spec, shape):
        size = int(np.prod([{"data": 4, "model": 2}[a] for a in entry]))
        assert dim % size == 0, (shape, axes, spec)
        used.extend(entry)
    assert len(used) == len(set(used)), f"mesh axis reused: {spec}"


def _choices():
    """``(intent, choice pairs)`` over every template's default intent
    and qwen2-1.5b's train_4k at three goals: the catalog's top choices
    of both planners."""
    intents = [workflow.REGISTRY.get(n).default_intent()
               for n, _, _ in workflow.REGISTRY.list()]
    intents += [ResourceIntent(arch="qwen2-1.5b", shape="train_4k", goal=g)
                for g in ("production", "exploration", "quick_test")]
    for intent in intents:
        j = jplanner.plan(JIntent(**dataclasses.asdict(intent)), top_k=3)
        yield intent, list(zip(j, planner.plan(intent, top_k=3)))


def test_to_runtime_plan_matches_reference():
    n = 0
    for intent, pairs in _choices():
        assert pairs, intent
        for a, b in pairs:
            for profile in ("optimized", "plain"):
                want = jplanner.to_runtime_plan(
                    a, cfg=JARCHS[intent.arch] if intent.arch in JARCHS
                    else None, profile=profile)
                got = planner.to_runtime_plan(
                    b, cfg=get_config(intent.arch), profile=profile)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                n += 1
    assert n >= 20
