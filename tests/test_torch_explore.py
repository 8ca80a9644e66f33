"""The port's cost-performance explorer against the reference's, on the
CPU: the same sweep over the same TPU catalog gives the same report, the
same ``result_doc`` and the same ``compare_markdown``, under no
calibration and under one fitted calibration activated in both
packages; the port caches per grid cell as the reference does; the
stage and the CLI's ``explore`` (with ``--compare``) run.

Each package counts its own catalog generations, so the generation
fields (which other tests in the same process move) are left out of the
document comparison; everything else is equal, the floats exactly (the
same float64 arithmetic).
"""
import glob
import importlib
import json
import os

import numpy as np
import pytest

from repro.core import calibrate as jcalibrate
from repro.core.planner import clear_planner_cache as jclear
from repro_torch.core import (REGISTRY, ProvenanceStore, StageCache,
                              StageGraph, calibrate, planner, run_workflow)
from repro_torch.core.stages import ExploreStage
from repro_torch.launch.cli import build_parser

# the modules (each package's core also exports a function ``explore``)
jexplore = importlib.import_module("repro.core.explore")
explore = importlib.import_module("repro_torch.core.explore")

SPECS = {
    # the reference's own sweep of tests/test_explore.py
    "scaling": dict(archs=("qwen2-1.5b",), shapes=("train_4k",),
                    goals=("production", "exploration"),
                    chip_counts=(16, 32, 64), preempt_rate_per_chip_hour=0.02,
                    steps=500),
    "batches": dict(archs=("glm4-9b", "xlstm-125m"), shapes=("train_4k",),
                    global_batches=(128, 512), chip_counts=(8, 32),
                    budget_usd_per_hour=400.0),
    "serving": dict(archs=("qwen2-1.5b",), shapes=("decode_32k",),
                    goals=("production", "quick_test"), chip_generation="v5e",
                    allow_multi_pod=False),
}


def _strip_generations(doc):
    doc = json.loads(json.dumps(doc))
    doc.pop("catalog_generation")
    for cell in doc["cells"]:
        cell.pop("generation")
    return doc


def _pair(kw):
    jclear()
    planner.clear_planner_cache()
    return (jexplore.explore(jexplore.ExploreSpec(**kw)),
            explore.explore(explore.ExploreSpec(**kw)))


def _without_generation_line(md):
    return "\n".join(ln for ln in md.splitlines()
                     if not ln.startswith("- grid:"))


@pytest.fixture
def fitted():
    """One fitted calibration, activated in both packages."""
    rng = np.random.default_rng(11)
    rows = [(float(c), float(m), float(x),
             float(1.6 * c + 0.9 * m + 1.1 * x + 0.002))
            for c, m, x in rng.uniform(1e-3, 1.0, (8, 3))]
    cals = [mod.Calibration(cells=tuple(mod.fit_cells(
        [mod.Sample("v5e", "train", *r) for r in rows])), generation=7)
        for mod in (jcalibrate, calibrate)]
    jcalibrate.activate(cals[0])
    calibrate.activate(cals[1])
    yield
    jcalibrate.deactivate()
    calibrate.deactivate()
    jclear()
    planner.clear_planner_cache()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_report_and_doc_match_reference(name):
    want, got = _pair(SPECS[name])
    assert got.feasible_cells == want.feasible_cells > 0
    assert len(got.frontier) == len(want.frontier)
    assert _without_generation_line(explore.report_markdown(got)) \
        == _without_generation_line(jexplore.report_markdown(want))
    assert explore.frontier_table(got) == jexplore.frontier_table(want)
    assert _strip_generations(explore.result_doc(got)) \
        == _strip_generations(jexplore.result_doc(want))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_calibrated_sweep_and_compare_match_reference(name, fitted):
    kw = SPECS[name]
    want, got = _pair(kw)
    jdoc, doc = jexplore.result_doc(want), explore.result_doc(got)
    assert doc["calibration_generation"] == jdoc["calibration_generation"] == 7
    assert _strip_generations(doc) == _strip_generations(jdoc)
    calibrate.deactivate()
    jcalibrate.deactivate()
    base_want, base_got = _pair(kw)
    jbase, base = jexplore.result_doc(base_want), explore.result_doc(base_got)
    # the same bytes once both docs cite the same catalog generations
    for d in (jbase, jdoc):
        d["catalog_generation"] = 0
    for d in (base, doc):
        d["catalog_generation"] = 0
    assert explore.compare_markdown(base, doc) \
        == jexplore.compare_markdown(jbase, jdoc)


def test_cells_cached_per_grid_cell(tmp_path):
    spec = explore.ExploreSpec(**SPECS["scaling"])
    cache = StageCache(str(tmp_path / "cells"))
    planner.clear_planner_cache()
    cold = explore.explore(spec, cache=cache)
    assert cold.cells_from_cache == 0
    planner.reset_planner_stats()
    warm = explore.explore(spec, cache=cache)
    assert warm.cells_from_cache == len(spec.cell_specs())
    assert planner.PLANNER_STATS["plan_calls"] == 0  # families cached too
    assert explore.report_markdown(warm) == explore.report_markdown(cold)


def test_explore_stage_writes_the_reference_report(tmp_path):
    spec = explore.ExploreSpec(**SPECS["batches"])
    g = StageGraph("sweep")
    g.add(ExploreStage(spec=spec))
    res = run_workflow(REGISTRY.get("train-qwen2-1.5b"),
                       ProvenanceStore(str(tmp_path)), graph=g, device="cpu")
    assert res.ok
    (ev,) = [e for e in res.record.events() if e["kind"] == "explore"]
    with open(ev["report"], encoding="utf-8") as f:
        md = f.read()
    jclear()
    want = jexplore.report_markdown(
        jexplore.explore(jexplore.ExploreSpec(**SPECS["batches"])))
    assert _without_generation_line(md) == _without_generation_line(want)


def test_cli_explore_and_compare(tmp_path, capsys):
    runs = str(tmp_path / "runs")
    args = build_parser().parse_args([
        "explore", "--arch", "qwen2-1.5b", "--shape", "train_4k",
        "--chips", "16,32", "--runs-dir", runs])
    args.fn(args)
    assert "frontier has" in capsys.readouterr().out
    (base,) = glob.glob(os.path.join(runs, "*", "explore.json"))
    run_id = os.path.basename(os.path.dirname(base))
    store = calibrate.CalibrationStore(str(tmp_path / "cal.json"))
    rng = np.random.default_rng(13)
    store.ingest([calibrate.Sample("v5e", "train", float(c), float(m),
                                   float(x), float(1.5 * c + 0.9 * m + x))
                  for c, m, x in rng.uniform(1e-3, 1.0, (8, 3))])
    store.fit()
    try:
        args = build_parser().parse_args([
            "explore", "--compare", run_id, "--calibration", store.path,
            "--runs-dir", runs])
        args.fn(args)
    finally:
        calibrate.deactivate()
        planner.clear_planner_cache()
    out = capsys.readouterr().out
    assert "# Explore comparison" in out and "cells changed" in out
    assert glob.glob(os.path.join(runs, "*", "compare.md"))
