"""The card in the port's catalog, on the CPU: the H100's slices enter
only by an explicit registration (``register_card``, an intent or a CLI
flag that names the card, or a provider's offer), each registration
bumps the catalog generation as the reference's ``register_slice``
does, and with the card registered every intent constrained to a TPU
generation plans exactly as the reference plans it; without the card the
catalog is the reference's.  Plans are compared as in
``tests/test_torch_workflow.py``: slices, meshes and geometries equal,
estimates within rtol 1e-12 (the same float64 arithmetic)."""
import dataclasses

import numpy as np
import pytest

from repro.core import catalog as jcatalog
from repro.core import planner as jplanner
from repro.core import registry as jregistry
from repro.core.intent import ResourceIntent as JIntent
from repro_torch.core import catalog, planner, registry
from repro_torch.core.explore import derived_shape
from repro_torch.core.intent import ResourceIntent
from repro_torch.core.registry import (ProviderProfile, ProviderRegistry,
                                       SliceOffer)
from repro_torch.launch.cli import build_parser


@pytest.fixture(autouse=True)
def no_card_left():
    yield
    catalog.unregister_card()
    planner.clear_planner_cache()


def _chip_doc(chip):
    return dataclasses.asdict(chip)


def _catalog_doc(slices):
    return [(s.name, _chip_doc(s.chip), s.chips_per_pod, s.num_pods)
            for s in slices]


def _same_choice(a, b):
    assert b.slice.name == a.slice.name
    assert b.mesh_shape == a.mesh_shape and b.mesh_axes == a.mesh_axes
    assert dataclasses.asdict(b.geometry) == dataclasses.asdict(a.geometry)
    ea, eb = dataclasses.asdict(a.est), dataclasses.asdict(b.est)
    for k, v in ea.items():
        if isinstance(v, float):
            np.testing.assert_allclose(eb[k], v, rtol=1e-12, err_msg=k)
        else:
            assert eb[k] == v, k


def test_default_catalog_equals_the_reference():
    assert _catalog_doc(catalog.CATALOG) == _catalog_doc(jcatalog.CATALOG)
    assert _catalog_doc(catalog.build_catalog()) \
        == _catalog_doc(jcatalog.build_catalog())
    assert catalog.catalog_summary() == jcatalog.catalog_summary()
    assert {k: _chip_doc(v) for k, v in catalog.CHIPS.items()} \
        == {k: _chip_doc(v) for k, v in jcatalog.CHIPS.items()}
    assert catalog.chip_generations() == list(jcatalog.CHIPS)
    assert not any(s.chip.name == "h100" for s in catalog.CATALOG)


def test_the_card_is_the_published_h100():
    h = catalog.H100
    assert (h.name, h.peak_bf16_flops, h.hbm_bytes, h.hbm_bw, h.ici_bw,
            h.dci_bw, h.max_pod_chips) \
        == ("h100", 989.4e12, 80e9, 3.35e12, 450e9, 50e9, 8)
    assert h.price_per_hour > 0 and "h100" not in catalog.CHIPS
    assert [(s.name, s.total_chips) for s in catalog.card_slices()] \
        == [("h100-1", 1), ("h100-8", 8)]


def test_register_card_bumps_the_generation_once_a_slice():
    gen0 = catalog.catalog_generation()
    n0 = len(catalog.CATALOG)
    slices = catalog.register_card()
    assert [s.name for s in slices] == ["h100-1", "h100-8"]
    assert catalog.catalog_generation() == gen0 + 2
    assert [s.name for s in catalog.CATALOG[n0:]] == ["h100-1", "h100-8"]
    assert catalog.register_card() == slices  # already there: no bump
    assert catalog.catalog_generation() == gen0 + 2
    assert catalog.chip_generations() == list(jcatalog.CHIPS) + ["h100"]
    gone = catalog.unregister_card()
    assert [s.name for s in gone] == ["h100-1", "h100-8"]
    assert catalog.catalog_generation() == gen0 + 4
    assert _catalog_doc(catalog.CATALOG) == _catalog_doc(jcatalog.CATALOG)
    assert catalog.unregister_card() == []


@pytest.mark.parametrize("intent", [
    dict(chip_generation="h100"), dict(slice_name="h100-8"),
    dict(slice_name="h100-1", mesh_shape=(1, 1))])
def test_naming_the_card_registers_it(intent):
    gen0 = catalog.catalog_generation()
    got = planner.plan(ResourceIntent(
        arch="qwen2-1.5b", shape=derived_shape("train_4k", 2), **intent))
    assert got and all(c.slice.chip.name == "h100" for c in got)
    assert catalog.catalog_generation() == gen0 + 2


@pytest.mark.parametrize("intent", [
    dict(), dict(chip_generation="v5e"), dict(slice_name="v5p-8")])
def test_other_intents_leave_the_catalog_alone(intent):
    gen0 = catalog.catalog_generation()
    planner.plan(ResourceIntent(arch="qwen2-1.5b", shape="train_4k",
                                **intent))
    planner.enumerate_plans(ResourceIntent(arch="qwen2-1.5b",
                                           shape="train_4k", **intent),
                            engine="scalar")
    assert catalog.catalog_generation() == gen0


INTENTS = [(arch, shape, gen) for gen in ("v4", "v5e", "v5p")
           for arch, shape in (("qwen2-1.5b", "train_4k"),
                               ("glm4-9b", "train_4k"),
                               ("qwen2-1.5b", "decode_32k"),
                               ("hymba-1.5b", "prefill_32k"))]


@pytest.mark.parametrize("arch,shape,gen", INTENTS)
def test_tpu_intents_plan_as_the_reference_with_the_card_registered(
        arch, shape, gen):
    catalog.register_card()
    for goal in ("production", "exploration", "quick_test"):
        kw = dict(arch=arch, shape=shape, goal=goal, chip_generation=gen)
        want = jplanner.plan(JIntent(**kw), top_k=5)
        got = planner.plan(ResourceIntent(**kw), top_k=5)
        assert len(got) == len(want)
        for a, b in zip(want, got):
            _same_choice(a, b)
        scalar = planner.plan(ResourceIntent(**kw), top_k=5, engine="scalar")
        assert [c.slice.name for c in scalar] == [c.slice.name for c in got]


def test_one_card_plans_of_train_4k():
    """The plans the full-width workflow runs on the card: train_4k at
    global batch 2 and 4 on one card is remat full, one microbatch; at
    its own batch of 256 (the microbatch grid stops at 4) and for
    decode_32k (about 120 GB of KV cache) one card has no plan."""
    want = {2: (0.0923, 30.5), 4: (0.1780, 36.3)}
    for gb, (step_s, gbytes) in want.items():
        (c,) = planner.plan(ResourceIntent(
            arch="qwen2-1.5b", shape=derived_shape("train_4k", gb),
            chip_generation="h100", max_chips=1), top_k=1)
        assert c.slice.name == "h100-1" and c.mesh_shape == (1, 1)
        assert (c.geometry.remat, c.geometry.microbatch) == ("full", 1)
        assert round(c.est.step_s, 4) == step_s
        assert round(c.est.bytes_per_device / 1e9, 1) == gbytes
    for shape in ("train_4k", "decode_32k"):
        assert planner.plan(ResourceIntent(
            arch="qwen2-1.5b", shape=shape, slice_name="h100-1")) == []


def _h100_provider(pid="gpucloud", health="healthy", price=None):
    return ProviderProfile(
        id=pid, name=pid.title(), service="gpu", health=health,
        offers=(SliceOffer(chip="h100", chips_per_pod=1,
                           price_per_chip_hour=price),
                SliceOffer(chip="h100", chips_per_pod=8)))


def test_a_provider_offers_the_card():
    reg = ProviderRegistry()
    gen0 = catalog.catalog_generation()
    try:
        slices = reg.register(_h100_provider(price=9.5))
        assert [s.name for s in slices] == ["gpucloud/h100-1",
                                            "gpucloud/h100-8"]
        assert catalog.catalog_generation() == gen0 + 2
        assert catalog.find_slice("gpucloud/h100-1").chip.price_per_hour \
            == 9.5
        assert catalog.find_slice("gpucloud/h100-8").chip == catalog.H100
        (c,) = planner.plan(ResourceIntent(
            arch="qwen2-1.5b", shape=derived_shape("train_4k", 2),
            slice_name="gpucloud/h100-1"), top_k=1)
        assert c.slice.name == "gpucloud/h100-1"
        reg.set_health("gpucloud", "down")
        with pytest.raises(KeyError):
            catalog.find_slice("gpucloud/h100-1")
        assert catalog.catalog_generation() == gen0 + 4
    finally:
        reg.deregister("gpucloud")
    with pytest.raises(ValueError, match="not in CHIPS"):
        ProviderProfile(id="x", name="x",
                        offers=(SliceOffer(chip="a100", chips_per_pod=8),))


def _tpu_provider(pid="acme", price=None, health="healthy"):
    kw = dict(id=pid, name=pid.title(), service="tpu", health=health)
    return kw, dict(chip="v5e", chips_per_pod=16, price_per_chip_hour=price)


@pytest.mark.parametrize("steps", ["register", "price", "health"])
def test_tpu_provider_registry_matches_the_reference(steps):
    """The reference's provider cases, run through both registries: the
    same slices, prices and generation moves."""
    out = []
    for mod, cat in ((jregistry, jcatalog), (registry, catalog)):
        kw, offer = _tpu_provider(price=0.5 if steps == "price" else None)
        reg = mod.ProviderRegistry()
        gen0 = cat.catalog_generation()
        trace = []
        try:
            reg.register(mod.ProviderProfile(
                offers=(mod.SliceOffer(**offer),), **kw))
            trace.append((reg.slice_names("acme"),
                          cat.find_slice("acme/v5e-16").chip.price_per_hour))
            if steps == "price":
                reg.update_price("acme", "v5e", 0.25)
                trace.append(cat.find_slice("acme/v5e-16").chip.price_per_hour)
            if steps == "health":
                reg.set_health("acme", "down")
                trace.append(reg.slice_names("acme"))
                reg.set_health("acme", "degraded")
                trace.append(reg.slice_names("acme"))
            trace.append((cat.catalog_generation() - gen0, reg.summary()))
        finally:
            reg.deregister("acme")
        out.append(trace)
    assert out[0] == out[1]


def test_cli_plan_and_explore_take_the_card(tmp_path, capsys):
    args = build_parser().parse_args([
        "plan", "--arch", "qwen2-1.5b", "--shape", "train_4k", "--chip",
        "h100"])
    args.fn(args)
    assert "h100-8" in capsys.readouterr().out
    catalog.unregister_card()
    args = build_parser().parse_args([
        "plan", "--arch", "qwen2-1.5b", "--shape", "train_4k", "--slice",
        "h100-8"])
    args.fn(args)
    assert "h100-8" in capsys.readouterr().out
    catalog.unregister_card()
    args = build_parser().parse_args([
        "explore", "--arch", "qwen2-1.5b", "--shape", "train_4k", "--chip",
        "h100", "--chips", "1,8", "--global-batch", "2,4", "--runs-dir",
        str(tmp_path)])
    args.fn(args)
    out = capsys.readouterr().out
    assert "h100-1" in out and "h100-8" in out and "4 feasible" in out
