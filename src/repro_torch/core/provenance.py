"""Job Results & Provenance (paper §4.4): the persistent record of
computation.

Every run is linked to {template name+version, config hash, plan, mesh,
environment} so teams can reproduce baselines, compare runs across
backends, and diff parameter injections (the paper's q=0.25 → 0.5 PISM
example).  Storage is a plain directory tree — no services required:

    runs/<run_id>/manifest.json     # identity + environment + plan
    runs/<run_id>/metrics.jsonl     # one json per step
    runs/<run_id>/artifacts/...     # checkpoints, figures, reports

A copy of the reference package's ``core/provenance.py``; the recorded
environment names torch, CUDA and the card in place of JAX's backend.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import time
from typing import Any, Dict, Iterator, List, Optional

import torch


def stable_hash(obj: Any) -> str:
    def default(o):
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        if isinstance(o, tuple):
            return list(o)
        return str(o)

    payload = json.dumps(obj, sort_keys=True, default=default)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def capture_environment() -> Dict[str, Any]:
    """The run's software and device: torch and CUDA versions, ``cuda``
    or ``cpu``, and the card's name and count when a GPU is present."""
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": (torch.cuda.get_device_name(0) if cuda
                        else platform.processor() or platform.machine()),
        "device_count": torch.cuda.device_count() if cuda else 1,
        "python": platform.python_version(),
        "platform": platform.platform(),
    }


class RunRecord:
    def __init__(self, root: str, run_id: str, manifest: Dict[str, Any]):
        self.run_id = run_id
        self.dir = os.path.join(root, run_id)
        os.makedirs(os.path.join(self.dir, "artifacts"), exist_ok=True)
        self.manifest = manifest
        with open(os.path.join(self.dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        self._metrics_path = os.path.join(self.dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": int(step), "t": time.time()}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                row[k] = str(v)
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def log_event(self, kind: str, payload: Dict[str, Any]) -> None:
        with open(os.path.join(self.dir, "events.jsonl"), "a") as f:
            f.write(json.dumps({"kind": kind, "t": time.time(), **payload},
                               default=str) + "\n")

    def update_manifest(self, **patch: Any) -> None:
        """Merge keys into the manifest and rewrite manifest.json — used by
        stages that learn facts after run creation (e.g. the resolved plan)."""
        self.manifest.update(patch)
        with open(os.path.join(self.dir, "manifest.json"), "w") as f:
            json.dump(self.manifest, f, indent=1, default=str)

    @property
    def artifacts_dir(self) -> str:
        return os.path.join(self.dir, "artifacts")

    def metrics(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self._metrics_path):
            return []
        with open(self._metrics_path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def events(self) -> List[Dict[str, Any]]:
        path = os.path.join(self.dir, "events.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def stage_events(self) -> List[Dict[str, Any]]:
        """The per-stage provenance trail emitted by StageGraph.execute
        and the executor backends: placement (resolved backend binding),
        stage_start, stage_cached (cache or resume skip), stage_failed /
        stage_retry (fault tolerance), stage_lease / stage_worker /
        worker_recruited / worker_lost (executor worker attribution —
        see docs/executors.md), and stage_end rows with timing and
        outputs hash."""
        return [e for e in self.events()
                if e.get("kind") in ("placement", "stage_start",
                                     "stage_cached", "stage_failed",
                                     "stage_retry", "stage_end",
                                     "stage_lease", "stage_worker",
                                     "worker_recruited", "worker_lost")]

    def stage_view(self, stage: str) -> "StageRecordView":
        return StageRecordView(self, stage)


class StageRecordView:
    """A RunRecord facade scoped to one stage: metric rows gain a
    ``stage`` column and events a ``stage`` field, so concurrent stages
    (e.g. a fan-out sweep's train stages) can share one run record while
    staying separable; ``metrics()`` reads back only this stage's rows."""

    def __init__(self, record: RunRecord, stage: str):
        self._record = record
        self.stage = stage
        self.run_id = record.run_id
        self.dir = record.dir

    @property
    def artifacts_dir(self) -> str:
        return self._record.artifacts_dir

    @property
    def manifest(self) -> Dict[str, Any]:
        return self._record.manifest

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        self._record.log(step, {**metrics, "stage": self.stage})

    def log_event(self, kind: str, payload: Dict[str, Any]) -> None:
        self._record.log_event(kind, {"stage": self.stage, **payload})

    def metrics(self) -> List[Dict[str, Any]]:
        return [r for r in self._record.metrics()
                if r.get("stage") == self.stage]


class ProvenanceStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def create_run(self, *, template: str, template_version: str,
                   config: Dict[str, Any], plan: Dict[str, Any],
                   workspace: str = "default",
                   parent_run: Optional[str] = None) -> RunRecord:
        config_hash = stable_hash(config)
        run_id = f"{template}-{config_hash}-{int(time.time()*1000) % 10**8:08d}"
        manifest = {
            "run_id": run_id,
            "template": template,
            "template_version": template_version,
            "config": config,
            "config_hash": config_hash,
            "plan": plan,
            "workspace": workspace,
            "parent_run": parent_run,
            "environment": capture_environment(),
            "created": time.time(),
        }
        return RunRecord(self.root, run_id, manifest)

    def list_runs(self) -> List[str]:
        """Run ids under the root: the directories holding a manifest
        (the train entry point keeps its checkpoints beside them)."""
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, d, "manifest.json"))
        )

    def load(self, run_id: str) -> RunRecord:
        path = os.path.join(self.root, run_id, "manifest.json")
        with open(path) as f:
            manifest = json.load(f)
        rec = RunRecord.__new__(RunRecord)
        rec.run_id = run_id
        rec.dir = os.path.join(self.root, run_id)
        rec.manifest = manifest
        rec._metrics_path = os.path.join(rec.dir, "metrics.jsonl")
        return rec

    # ------------------------------------------------------------------
    def compare(self, run_a: str, run_b: str) -> Dict[str, Any]:
        """Config diff + final-metric deltas (the paper's 'systematic
        comparison across runs and backends')."""
        a, b = self.load(run_a), self.load(run_b)

        def flat(d, prefix=""):
            out = {}
            for k, v in d.items():
                key = f"{prefix}{k}"
                if isinstance(v, dict):
                    out.update(flat(v, key + "."))
                else:
                    out[key] = v
            return out

        ca, cb = flat(a.manifest.get("config", {})), flat(b.manifest.get("config", {}))
        config_diff = {
            k: {"a": ca.get(k), "b": cb.get(k)}
            for k in sorted(set(ca) | set(cb))
            if ca.get(k) != cb.get(k)
        }
        ma = a.metrics()
        mb = b.metrics()
        metric_delta = {}
        if ma and mb:
            last_a, last_b = ma[-1], mb[-1]
            for k in set(last_a) & set(last_b) - {"step", "t"}:
                if isinstance(last_a[k], float) and isinstance(last_b[k], float):
                    metric_delta[k] = {"a": last_a[k], "b": last_b[k],
                                       "delta": last_b[k] - last_a[k]}
        return {"config_diff": config_diff, "metric_delta": metric_delta}
