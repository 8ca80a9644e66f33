"""Telemetry-calibrated cost model: measured runs corrected back into
the planner.

A copy of the reference package's ``core/calibrate.py``: :class:`Sample`
and the harvesters (:func:`harvest_run`, :func:`harvest_runs_dir`,
:func:`harvest_bench`), the per-(chip, kind) fit (:func:`fit_cells`),
:func:`check_drift`, the persistent :class:`CalibrationStore`, and the
active calibration the cost model consults (:func:`activate`,
:func:`deactivate`, :func:`active_cell`, :func:`active_for_kind`,
:func:`calibration_state`).  Samples from compiled programs
(the reference's ``sample_from_hlo``) wait for the port's own FLOP and
byte counting (ROADMAP queue 1, dry-run and HLO tooling).

One difference by design: a port run yields a sample only if it ran on
the chip its plan names (:func:`ran_on_planned_chip`).  The reference
runs where it plans; the port runs on one card, or on the CPU, whatever
slice the plan named, and filing a CPU run's step times (or the card's
under a TPU chip) would corrupt that chip's cell.

The unit of calibration is the **(chip, kind) cell**.  Each sample
pairs the three analytic roofline terms the static model computed for a
placement with the step time that placement measured:

    measured_step_s ≈ a_c·compute_s + a_m·memory_s + a_x·collective_s + b

fitted per cell by weighted least squares; cells with too few samples
fall back to one multiplicative correction (``mode="scale"``).  The
planner salts its memo entries with :func:`calibration_state`, a
per-kind fingerprint of the active coefficients.

The store's document names its package (``"package": "repro_torch"``),
and its default path lies under ``.repro_cache/repro_torch/``: the port
never reads or overwrites the reference's store, even at a shared path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.stagecache import _atomic_write, _FileLock

STORE_VERSION = 1
PACKAGE = "repro_torch"
DEFAULT_STORE_PATH = ".repro_cache/repro_torch/calibration.json"

# prediction floor: a pathological fit must never hand the planner a
# zero/negative step time (ranking and $/token divide by it)
_STEP_FLOOR = 1e-12


def default_store_path() -> str:
    return os.environ.get("REPRO_CALIBRATION_PATH", DEFAULT_STORE_PATH)


def _digest(obj: Any) -> str:
    payload = json.dumps(obj, sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def static_step(compute_s, memory_s, collective_s):
    """The uncalibrated roofline combine (elementwise on arrays):
    dominant term plus a 15% tax on the overlapped remainder — kept in
    lockstep with :func:`repro_torch.core.costmodel.estimate`."""
    peak = np.maximum(np.maximum(compute_s, memory_s), collective_s)
    return peak + 0.15 * (compute_s + memory_s + collective_s - peak)


# ===========================================================================
# Samples: one observed (terms, measured step) pair
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class Sample:
    """One telemetry observation for a (chip, kind) cell: the analytic
    roofline terms the model computed for the placement, paired with the
    step time the placement actually measured."""

    chip: str
    kind: str
    compute_s: float
    memory_s: float
    collective_s: float
    measured_step_s: float
    source: str = ""
    weight: float = 1.0

    def key(self) -> str:
        return _digest(dataclasses.asdict(self))

    def to_doc(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: Mapping[str, Any]) -> "Sample":
        return cls(**{f.name: doc[f.name] for f in dataclasses.fields(cls)
                      if f.name in doc})


def sample_from_estimate(est: Any, chip: str, kind: str,
                         measured_step_s: float, *, source: str = "",
                         weight: float = 1.0) -> Sample:
    """Pair a :class:`~repro_torch.core.costmodel.CostEstimate`'s terms with a
    measured step time."""
    return Sample(chip=chip, kind=kind,
                  compute_s=float(est.compute_s),
                  memory_s=float(est.memory_s),
                  collective_s=float(est.collective_s),
                  measured_step_s=float(measured_step_s),
                  source=source, weight=float(weight))


# The device kind (``torch.cuda.get_device_name``) each card's runs report
CARD_DEVICE_KINDS: Dict[str, str] = {"h100": "H100"}


def ran_on_planned_chip(record: Any, chip: str) -> bool:
    """True when the run's workload stages ran on the card its plan
    names: ``chip`` is a card of :data:`CARD_DEVICE_KINDS`, and every
    ``environment`` event (one a workload stage) has device ``cuda`` and a
    device kind naming that card.  A CPU run, or a run whose plan names a
    TPU (the port runs on none), measured nothing that chip would take."""
    want = CARD_DEVICE_KINDS.get(chip)
    if want is None:
        return False
    envs = [e for e in record.events() if e.get("kind") == "environment"]
    return bool(envs) and all(
        str(e.get("device", "")).split(":")[0] == "cuda"
        and want in str(e.get("device_kind", "")) for e in envs)


def harvest_run(record: Any, *, skip_steps: int = 1) -> List[Sample]:
    """Harvest one provenance run: the plan doc's recorded roofline
    terms (written by PlanStage) paired with the median measured
    ``step_time_s`` from the run's metric rows.  The first ``skip_steps``
    timed rows are dropped (they absorb set-up).  Returns ``[]``
    when the run carries no plan terms or no timed steps, or did not run
    on the chip its plan names (:func:`ran_on_planned_chip`) — harvesting
    is best-effort, never an error."""
    plan_doc = (record.manifest or {}).get("plan") or {}
    needed = ("chip", "kind", "compute_s", "memory_s", "collective_s")
    if any(plan_doc.get(k) is None for k in needed):
        return []
    if not ran_on_planned_chip(record, str(plan_doc["chip"])):
        return []
    times = [float(r["step_time_s"]) for r in record.metrics()
             if isinstance(r.get("step_time_s"), (int, float))]
    times = times[skip_steps:]
    if not times:
        return []
    return [Sample(
        chip=str(plan_doc["chip"]), kind=str(plan_doc["kind"]),
        compute_s=float(plan_doc["compute_s"]),
        memory_s=float(plan_doc["memory_s"]),
        collective_s=float(plan_doc["collective_s"]),
        measured_step_s=float(np.median(np.asarray(times))),
        source=f"run:{record.run_id}",
        weight=float(len(times)),
    )]


def harvest_runs_dir(root: str) -> List[Sample]:
    """Harvest every run under a provenance root (``calibrate
    --runs-dir``)."""
    from repro_torch.core.provenance import ProvenanceStore

    if not os.path.isdir(root):
        return []
    store = ProvenanceStore(root)
    out: List[Sample] = []
    for run_id in store.list_runs():
        try:
            out.extend(harvest_run(store.load(run_id)))
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            continue
    return out


def harvest_bench(path: str) -> List[Sample]:
    """Harvest a ``BENCH_*.json`` file: any section carrying a
    ``calibration_samples`` list of sample docs contributes (the
    planner bench's calibration section writes one)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    out: List[Sample] = []

    def walk(node):
        if isinstance(node, dict):
            rows = node.get("calibration_samples")
            if isinstance(rows, list):
                for row in rows:
                    try:
                        out.append(Sample.from_doc(row))
                    except (TypeError, KeyError):
                        continue
            for v in node.values():
                walk(v)

    walk(doc)
    return out


# ===========================================================================
# Fitted coefficients
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class CellCalibration:
    """Fitted coefficients for one (chip, kind) cell.

    ``mode="linear"`` predicts ``a_c·compute + a_m·memory +
    a_x·collective + b`` (the least-squares fit); ``mode="scale"`` is
    the low-sample fallback: one multiplicative correction on the
    static roofline combine."""

    chip: str
    kind: str
    a_compute: float = 1.0
    a_memory: float = 1.0
    a_collective: float = 1.0
    intercept: float = 0.0
    mode: str = "linear"
    scale: float = 1.0
    n_samples: int = 0
    residual: float = 0.0  # rms relative error of the fit on its samples

    def predict(self, compute_s, memory_s, collective_s):
        """Calibrated step seconds; elementwise on arrays, and
        bit-identical between the scalar and batched cost-model paths
        (both call exactly this)."""
        if self.mode == "scale":
            pred = self.scale * static_step(compute_s, memory_s,
                                            collective_s)
        else:
            pred = (self.a_compute * compute_s + self.a_memory * memory_s
                    + self.a_collective * collective_s + self.intercept)
        return np.maximum(pred, _STEP_FLOOR)

    def to_doc(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: Mapping[str, Any]) -> "CellCalibration":
        return cls(**{f.name: doc[f.name] for f in dataclasses.fields(cls)
                      if f.name in doc})


@dataclasses.dataclass(frozen=True)
class Calibration:
    """An immutable set of fitted cells, keyed ``(chip, kind)``.

    ``generation`` is the store generation the set was fitted at —
    reports and provenance events cite it.  ``kind_state(kind)`` is the
    planner's memo salt: a stable fingerprint of every cell touching
    one workload kind, so activating new train coefficients invalidates
    memoized train plans while decode intents keep their memo hits."""

    cells: Tuple[CellCalibration, ...] = ()
    generation: int = 0

    def __post_init__(self):
        by_key = {(c.chip, c.kind): c for c in self.cells}
        object.__setattr__(self, "_by_key", by_key)
        states: Dict[str, str] = {}
        for kind in sorted({c.kind for c in self.cells}):
            states[kind] = _digest(sorted(
                (c.chip, c.to_doc()) for c in self.cells if c.kind == kind))
        object.__setattr__(self, "_kind_states", states)

    def cell(self, chip: str, kind: str) -> Optional[CellCalibration]:
        return self._by_key.get((chip, kind))

    def for_kind(self, kind: str) -> Dict[str, CellCalibration]:
        return {c.chip: c for c in self.cells if c.kind == kind}

    def kind_state(self, kind: str) -> str:
        return self._kind_states.get(kind, "")


def fit_cells(samples: Iterable[Sample], *,
              min_samples: int = 4) -> List[CellCalibration]:
    """Weighted least squares per (chip, kind) group.

    Groups with at least ``min_samples`` observations and full column
    rank get the 4-coefficient linear fit (which *exactly* recovers
    coefficients from noise-free synthetic telemetry); smaller or
    degenerate groups fall back to the single-scale correction."""
    groups: Dict[Tuple[str, str], List[Sample]] = {}
    for s in samples:
        groups.setdefault((s.chip, s.kind), []).append(s)
    out: List[CellCalibration] = []
    for (chip, kind), rows in sorted(groups.items()):
        c = np.asarray([r.compute_s for r in rows], dtype=np.float64)
        m = np.asarray([r.memory_s for r in rows], dtype=np.float64)
        x = np.asarray([r.collective_s for r in rows], dtype=np.float64)
        y = np.asarray([r.measured_step_s for r in rows], dtype=np.float64)
        w = np.sqrt(np.maximum(
            np.asarray([r.weight for r in rows], dtype=np.float64), 0.0))
        cell: Optional[CellCalibration] = None
        if len(rows) >= min_samples:
            design = np.stack([c, m, x, np.ones_like(c)], axis=1)
            coef, _, rank, _ = np.linalg.lstsq(design * w[:, None],
                                               y * w, rcond=None)
            if rank == design.shape[1]:
                cell = CellCalibration(
                    chip=chip, kind=kind,
                    a_compute=float(coef[0]), a_memory=float(coef[1]),
                    a_collective=float(coef[2]), intercept=float(coef[3]),
                    mode="linear", n_samples=len(rows))
        if cell is None:
            base = static_step(c, m, x)
            ratio = np.where(base > 0, y / np.maximum(base, _STEP_FLOOR), 1.0)
            ws = w * w
            scale = float(np.sum(ratio * ws) / max(np.sum(ws), _STEP_FLOOR))
            cell = CellCalibration(chip=chip, kind=kind, mode="scale",
                                   scale=scale, n_samples=len(rows))
        pred = cell.predict(c, m, x)
        rel = (pred - y) / np.maximum(np.abs(y), _STEP_FLOOR)
        cell = dataclasses.replace(
            cell, residual=float(np.sqrt(np.mean(rel * rel))))
        out.append(cell)
    return out


# ===========================================================================
# Drift detection
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class DriftCell:
    chip: str
    kind: str
    n_samples: int
    mean_rel_err: float
    max_rel_err: float
    drifted: bool


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Per-cell predicted-vs-measured divergence.  A cell is *drifted*
    when its mean relative error exceeds the threshold — the signal to
    re-fit the calibration (or to distrust the catalog's specs for that
    chip)."""

    threshold: float
    cells: Tuple[DriftCell, ...]

    @property
    def drifted(self) -> Tuple[DriftCell, ...]:
        return tuple(c for c in self.cells if c.drifted)

    def summary(self) -> str:
        if not self.cells:
            return "no telemetry to check"
        bits = []
        for c in self.cells:
            flag = "DRIFT" if c.drifted else "ok"
            bits.append(f"{c.chip}/{c.kind}: mean {c.mean_rel_err * 100:.1f}% "
                        f"max {c.max_rel_err * 100:.1f}% "
                        f"over {c.n_samples} samples [{flag}]")
        return "; ".join(bits)


def check_drift(samples: Iterable[Sample],
                calibration: Optional[Calibration] = None, *,
                threshold: float = 0.25) -> DriftReport:
    """Compare each sample's measured step time against the prediction —
    the calibration's cell when one covers the sample, the static
    roofline prior otherwise — and flag cells past ``threshold`` mean
    relative error."""
    groups: Dict[Tuple[str, str], List[Sample]] = {}
    for s in samples:
        groups.setdefault((s.chip, s.kind), []).append(s)
    cells: List[DriftCell] = []
    for (chip, kind), rows in sorted(groups.items()):
        c = np.asarray([r.compute_s for r in rows], dtype=np.float64)
        m = np.asarray([r.memory_s for r in rows], dtype=np.float64)
        x = np.asarray([r.collective_s for r in rows], dtype=np.float64)
        y = np.asarray([r.measured_step_s for r in rows], dtype=np.float64)
        cell = calibration.cell(chip, kind) if calibration else None
        pred = (cell.predict(c, m, x) if cell is not None
                else static_step(c, m, x))
        rel = np.abs(pred - y) / np.maximum(np.abs(y), _STEP_FLOOR)
        mean = float(np.mean(rel))
        cells.append(DriftCell(chip=chip, kind=kind, n_samples=len(rows),
                               mean_rel_err=mean,
                               max_rel_err=float(np.max(rel)),
                               drifted=mean > threshold))
    return DriftReport(threshold=threshold, cells=tuple(cells))


# ===========================================================================
# The persistent store
# ===========================================================================
class CalibrationStore:
    """Persistent JSON store of telemetry samples + fitted cells.

    One file (default ``.repro_cache/repro_torch/calibration.json``, or
    ``$REPRO_CALIBRATION_PATH``)::

        {"version": 1, "package": "repro_torch", "generation": N,
         "samples": {<sample key>: <sample doc>, ...},
         "cells":   {"<chip>|<kind>": <cell doc>, ...}}

    Writes follow the :class:`~repro_torch.core.stagecache.RunManifest`
    discipline: every read-modify-write runs under an fcntl
    :class:`~repro_torch.core.stagecache._FileLock` on a sidecar sentinel,
    merges the on-disk state with this writer's delta, and lands via
    atomic temp-file + rename — so concurrent ingesting processes lose
    no samples (the hammer test).  ``generation`` is monotonic and
    bumps on every mutation; the planner's memo salt and explore cache
    keys derive from it through the *active* calibration."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_store_path()
        self.lock_path = self.path + ".lock"
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._lock = threading.Lock()

    # -- raw document ---------------------------------------------------
    def _read_disk(self) -> Dict[str, Any]:
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = None
        if isinstance(doc, dict) and doc.get("package") != PACKAGE \
                and (doc.get("samples") or doc.get("cells")):
            raise ValueError(
                f"{self.path} holds the calibration store of package "
                f"{doc.get('package', 'repro')!r}, not {PACKAGE!r}")
        if not isinstance(doc, dict) or doc.get("version") != STORE_VERSION:
            return {"version": STORE_VERSION, "package": PACKAGE,
                    "generation": 0, "samples": {}, "cells": {}}
        doc.setdefault("generation", 0)
        doc.setdefault("samples", {})
        doc.setdefault("cells", {})
        return doc

    def _write_disk(self, doc: Dict[str, Any]) -> bool:
        payload = json.dumps(doc, indent=1, sort_keys=True).encode()
        parent = os.path.dirname(self.path) or "."
        return _atomic_write(parent, self.path, payload)

    def document(self) -> Dict[str, Any]:
        """A read-only snapshot of the raw store document."""
        with self._lock:
            with _FileLock(self.lock_path):
                return self._read_disk()

    def generation(self) -> int:
        return int(self.document().get("generation", 0))

    # -- mutation (merge-on-flush under the flock) ----------------------
    def ingest(self, samples: Iterable[Sample]) -> int:
        """Merge samples into the store (deduplicated by content hash).
        Returns the number of *new* samples; bumps the generation iff
        anything changed."""
        new = {s.key(): s.to_doc() for s in samples}
        if not new:
            return 0
        with self._lock:
            with _FileLock(self.lock_path):
                doc = self._read_disk()
                before = len(doc["samples"])
                doc["samples"].update(new)
                added = len(doc["samples"]) - before
                if added:
                    doc["generation"] = int(doc["generation"]) + 1
                    self._write_disk(doc)
        return added

    def fit(self, *, min_samples: int = 4) -> Calibration:
        """Re-fit every (chip, kind) cell from the stored samples,
        persist the coefficients, bump the generation, and return the
        fitted :class:`Calibration`."""
        with self._lock:
            with _FileLock(self.lock_path):
                doc = self._read_disk()
                samples = [Sample.from_doc(d)
                           for d in doc["samples"].values()]
                cells = fit_cells(samples, min_samples=min_samples)
                doc["cells"] = {f"{c.chip}|{c.kind}": c.to_doc()
                                for c in cells}
                doc["generation"] = int(doc["generation"]) + 1
                self._write_disk(doc)
                return Calibration(cells=tuple(cells),
                                   generation=int(doc["generation"]))

    def clear(self) -> None:
        with self._lock:
            with _FileLock(self.lock_path):
                doc = self._read_disk()
                doc["samples"] = {}
                doc["cells"] = {}
                doc["generation"] = int(doc["generation"]) + 1
                self._write_disk(doc)

    # -- read views -----------------------------------------------------
    def samples(self, chip: Optional[str] = None,
                kind: Optional[str] = None) -> List[Sample]:
        out = [Sample.from_doc(d)
               for d in self.document()["samples"].values()]
        if chip is not None:
            out = [s for s in out if s.chip == chip]
        if kind is not None:
            out = [s for s in out if s.kind == kind]
        out.sort(key=lambda s: s.key())
        return out

    def calibration(self) -> Calibration:
        """The stored fitted cells (empty Calibration when never
        fitted)."""
        doc = self.document()
        cells = tuple(sorted(
            (CellCalibration.from_doc(d) for d in doc["cells"].values()),
            key=lambda c: (c.chip, c.kind)))
        return Calibration(cells=cells, generation=int(doc["generation"]))

    def drift(self, *, threshold: float = 0.25,
              calibration: Optional[Calibration] = None) -> DriftReport:
        """Drift of the stored (or given) calibration against the stored
        telemetry."""
        doc = self.document()
        samples = [Sample.from_doc(d) for d in doc["samples"].values()]
        if calibration is None:
            cells = tuple(CellCalibration.from_doc(d)
                          for d in doc["cells"].values())
            calibration = Calibration(cells=cells,
                                      generation=int(doc["generation"]))
        return check_drift(samples, calibration, threshold=threshold)


# ===========================================================================
# The active calibration — what the cost model consults
# ===========================================================================
_ACTIVE_LOCK = threading.Lock()
_ACTIVE: Optional[Calibration] = None
_ACTIVE_GEN = 0  # bumps on every activate/deactivate (memo salt)


def activate(calibration: Calibration) -> Calibration:
    """Install a calibration as the one ``estimate``/``estimate_batch``
    apply.  Bumps the activation generation, so planner memo entries and
    explore cell keys salted with :func:`calibration_state` go stale for
    exactly the kinds whose coefficients changed."""
    global _ACTIVE, _ACTIVE_GEN
    with _ACTIVE_LOCK:
        _ACTIVE = calibration
        _ACTIVE_GEN += 1
    return calibration


def deactivate() -> None:
    """Back to the static priors (tests, and ``repro calibrate
    --deactivate``)."""
    global _ACTIVE, _ACTIVE_GEN
    with _ACTIVE_LOCK:
        _ACTIVE = None
        _ACTIVE_GEN += 1


def active() -> Optional[Calibration]:
    return _ACTIVE


def active_generation() -> int:
    """Monotonic activation counter (stage signatures fold this in so a
    resume can't restore a plan computed under different coefficients)."""
    return _ACTIVE_GEN


def active_cell(chip: str, kind: str) -> Optional[CellCalibration]:
    """The active coefficients for one (chip, kind), or None — the
    scalar cost model's per-estimate lookup."""
    cal = _ACTIVE
    return cal.cell(chip, kind) if cal is not None else None


def active_for_kind(kind: str) -> Dict[str, CellCalibration]:
    """{chip: coefficients} of the active calibration for one workload
    kind — the batched cost model's per-table lookup."""
    cal = _ACTIVE
    return cal.for_kind(kind) if cal is not None else {}


def calibration_state(kind: str) -> str:
    """The planner's memo salt for one workload kind: "" under static
    priors, else a stable fingerprint of the active coefficients
    touching that kind.  Two intents of different kinds therefore
    invalidate independently."""
    cal = _ACTIVE
    return cal.kind_state(kind) if cal is not None else ""
