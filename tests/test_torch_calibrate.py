"""The port's calibration harvesters and fits against the reference's,
on the CPU, and the port's one difference by design: a run yields a
sample only if it ran on the chip its plan names.

  * fits (linear, scale fallback, several cells), drift and the store's
    fit on identical sample docs: every coefficient and residual within
    rtol 1e-12 (the same float64 least squares);
  * ``harvest_bench`` of one file, and ``harvest_run`` of one run record
    (written once, loaded by each package) that ran on an H100 under a
    plan naming the card: the same sample docs, within rtol 1e-12;
  * the guard: a CPU run, a run whose plan names a TPU, a run with no
    ``environment`` event and a run on another GPU harvest nothing in
    the port (the reference takes each of them);
  * the calibrate stage in a workflow and the CLI's ``calibrate``.
"""
import dataclasses
import itertools
import json

import numpy as np
import pytest

from repro.core import calibrate as jcal
from repro.core.graph import StageGraph as JStageGraph
from repro.core.provenance import ProvenanceStore as JStore
from repro.core.spec import to_spec as jto_spec
from repro.core.stages import CalibrateStage as JCalibrateStage
from repro_torch.core import (REGISTRY, CalibrateStage, ProvenanceStore,
                              StageGraph, calibrate, run_workflow)
from repro_torch.core.spec import from_spec, to_spec
from repro_torch.launch.cli import build_parser

H100_ENV = {"device": "cuda:0", "device_kind": "NVIDIA H100 80GB HBM3",
            "backend": "cuda", "device_count": 1}
PLAN_TERMS = {"compute_s": 0.0923, "memory_s": 0.0112, "collective_s": 0.0}
# a config of its own for every run: run ids are unique per config and ms
RUNS = itertools.count()


@pytest.fixture(autouse=True)
def no_active_calibration():
    yield
    calibrate.deactivate()
    jcal.deactivate()


def _rows(seed, n, chip="v5e", kind="train", coefs=(1.6, 0.9, 1.1, 0.002),
          noise=0.0):
    rng = np.random.default_rng(seed)
    a_c, a_m, a_x, b = coefs
    out = []
    for i, (c, m, x) in enumerate(rng.uniform(1e-3, 1.0, (n, 3))):
        y = a_c * c + a_m * m + a_x * x + b
        y *= 1.0 + noise * rng.standard_normal()
        out.append({"chip": chip, "kind": kind, "compute_s": float(c),
                    "memory_s": float(m), "collective_s": float(x),
                    "measured_step_s": float(y), "source": f"s{i}",
                    "weight": float(1 + i % 3)})
    return out


SAMPLE_SETS = {
    "linear": _rows(1, 8),
    "noisy": _rows(2, 12, noise=0.05),
    "scale": _rows(3, 2, chip="h100"),
    "cells": (_rows(4, 6) + _rows(5, 3, chip="h100")
              + _rows(6, 5, chip="v4", kind="decode")),
}


def _close(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, float):
            np.testing.assert_allclose(got[k], v, rtol=1e-12, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", sorted(SAMPLE_SETS))
def test_fits_and_drift_match_reference(name, tmp_path):
    docs = SAMPLE_SETS[name]
    want = jcal.fit_cells([jcal.Sample.from_doc(d) for d in docs],
                          min_samples=4)
    got = calibrate.fit_cells([calibrate.Sample.from_doc(d) for d in docs],
                              min_samples=4)
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        _close(b.to_doc(), a.to_doc())
    jd = jcal.check_drift([jcal.Sample.from_doc(d) for d in docs],
                          jcal.Calibration(tuple(want)), threshold=0.05)
    d = calibrate.check_drift([calibrate.Sample.from_doc(x) for x in docs],
                              calibrate.Calibration(tuple(got)),
                              threshold=0.05)
    for a, b in zip(jd.cells, d.cells):
        _close(dataclasses.asdict(b), dataclasses.asdict(a))
    assert d.summary() == jd.summary()
    # the stores fit the same cells from the same ingested docs
    jstore = jcal.CalibrationStore(str(tmp_path / "ref.json"))
    store = calibrate.CalibrationStore(str(tmp_path / "port.json"))
    jstore.ingest([jcal.Sample.from_doc(x) for x in docs])
    store.ingest([calibrate.Sample.from_doc(x) for x in docs])
    for a, b in zip(jstore.fit(min_samples=3).cells,
                    store.fit(min_samples=3).cells):
        _close(b.to_doc(), a.to_doc())


def test_harvest_bench_matches_reference(tmp_path):
    path = tmp_path / "BENCH_x.json"
    path.write_text(json.dumps({"planner": {"speedup": 5.0}, "calibration": {
        "calibration_samples": SAMPLE_SETS["cells"] + [{"chip": "v5e"}]}}))
    want = [s.to_doc() for s in jcal.harvest_bench(str(path))]
    got = [s.to_doc() for s in calibrate.harvest_bench(str(path))]
    assert len(got) == len(want) == len(SAMPLE_SETS["cells"])
    for a, b in zip(want, got):
        _close(b, a)
    assert calibrate.harvest_bench(str(tmp_path / "missing.json")) == []


def _card_run(root, chip="h100", env=H100_ENV, times=(9.0, 0.41, 0.43, 0.42)):
    """A run record as the port's train workflow writes it: the plan doc's
    roofline terms, the train stage's environment event, step times."""
    store = ProvenanceStore(root)
    rec = store.create_run(template="train-qwen2-1.5b", template_version="1",
                           config={"run": next(RUNS)}, plan={})
    rec.update_manifest(plan={"slice": f"{chip}-1", "chip": chip,
                              "kind": "train", **PLAN_TERMS})
    if env is not None:
        rec.log_event("environment", {"stage": "train", **env})
    view = rec.stage_view("train")
    for i, t in enumerate(times):
        view.log(i, {"loss": 1.0, "step_time_s": t})
    return rec.run_id


def test_harvest_run_of_a_card_run_matches_reference(tmp_path):
    run_id = _card_run(str(tmp_path))
    (want,) = jcal.harvest_run(JStore(str(tmp_path)).load(run_id))
    (got,) = calibrate.harvest_run(ProvenanceStore(str(tmp_path)).load(run_id))
    _close(got.to_doc(), want.to_doc())
    assert (got.chip, got.kind, got.weight) == ("h100", "train", 3.0)
    assert got.measured_step_s == pytest.approx(0.42)


GUARDED = {
    "cpu run": dict(env={"device": "cpu", "device_kind": "x86_64",
                         "backend": "cpu"}),
    "plan names a TPU": dict(chip="v5e"),
    "no environment event": dict(env=None),
    "another GPU": dict(env=dict(H100_ENV, device_kind="NVIDIA A100-SXM4-80GB")),
}


@pytest.mark.parametrize("case", sorted(GUARDED))
def test_harvest_takes_only_runs_on_the_planned_card(case, tmp_path):
    run_id = _card_run(str(tmp_path), **GUARDED[case])
    assert len(jcal.harvest_run(JStore(str(tmp_path)).load(run_id))) == 1
    assert calibrate.harvest_run(
        ProvenanceStore(str(tmp_path)).load(run_id)) == []


def test_harvest_runs_dir_keeps_the_card_runs(tmp_path):
    root = str(tmp_path)
    keep = _card_run(root)
    for kw in GUARDED.values():
        _card_run(root, **kw)
    assert len(jcal.harvest_runs_dir(root)) == 1 + len(GUARDED)
    (s,) = calibrate.harvest_runs_dir(root)
    assert s.source == f"run:{keep}"
    assert calibrate.harvest_runs_dir(str(tmp_path / "none")) == []


def test_a_cpu_workflow_run_harvests_nothing(tmp_path):
    res = run_workflow(REGISTRY.get("train-qwen2-1.5b"),
                       ProvenanceStore(str(tmp_path)), steps_override=4,
                       device="cpu")
    plan_doc = res.record.manifest["plan"]
    assert plan_doc["chip"] and plan_doc["compute_s"] is not None
    assert len([r for r in res.record.metrics() if "step_time_s" in r]) == 4
    assert calibrate.harvest_run(res.record) == []
    assert calibrate.harvest_runs_dir(str(tmp_path)) == []


def test_calibrate_stage_fits_the_card_runs(tmp_path):
    runs = str(tmp_path / "runs")
    ids = [_card_run(runs, times=(9.0, t, t)) for t in (0.5, 0.95)]
    store = str(tmp_path / "cal.json")
    g = StageGraph("calibrate")
    g.add(CalibrateStage(store_path=store, runs_root=runs, activate=True))
    res = run_workflow(REGISTRY.get("train-qwen2-1.5b"),
                       ProvenanceStore(str(tmp_path / "advice")), graph=g,
                       device="cpu")
    assert res.ok
    cell = calibrate.active().cell("h100", "train")
    assert (cell.mode, cell.n_samples) == ("scale", len(ids))
    # the reference's fit of the same samples
    want = jcal.fit_cells([jcal.Sample.from_doc(s.to_doc())
                           for s in calibrate.harvest_runs_dir(runs)])
    _close(cell.to_doc(), want[0].to_doc())
    (ev,) = [e for e in res.record.events() if e["kind"] == "calibrate"]
    assert ev["samples"] == 2 and ev["activated"]


def test_calibrate_stage_spec_matches_reference():
    kw = dict(min_samples=2, drift_threshold=0.5, activate=True)
    jg = JStageGraph("spec")
    jg.add(JCalibrateStage(**kw))
    g = StageGraph("spec")
    g.add(CalibrateStage(**kw))
    assert to_spec(g) == jto_spec(jg)
    st = from_spec(jto_spec(jg)).stages["calibrate"]
    assert isinstance(st, CalibrateStage) and st.activate is True
    assert not CalibrateStage().cacheable


def test_cli_calibrate(tmp_path, capsys):
    runs = str(tmp_path / "runs")
    _card_run(runs)
    _card_run(runs, chip="v5e")
    store = str(tmp_path / "cal.json")
    args = build_parser().parse_args(["calibrate", "--store", store,
                                      "--runs-dir", runs])
    args.fn(args)
    out = capsys.readouterr().out
    assert "harvested 1 samples (1 new)" in out
    assert "h100/train: mode=scale" in out
    args = build_parser().parse_args(["calibrate", "--store", store,
                                      "--clear"])
    args.fn(args)
    assert calibrate.CalibrationStore(store).document()["samples"] == {}
