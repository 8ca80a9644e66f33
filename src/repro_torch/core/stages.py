"""Built-in stage library of the port: the workflow's phases as torch
stages.

A copy of the reference package's ``core/stages.py`` with torch bodies
on :mod:`repro_torch.models`, :mod:`repro_torch.train`,
:mod:`repro_torch.data` and :func:`repro_torch.serve.engine.smoke_serve`:

  * :class:`PlanStage`      — resolve per-stage ResourceIntents into
                              PlanChoices, authorize budget, record plan
  * :class:`DataStage`      — model config + shape + synthetic stream
  * :class:`TrainStage`     — envelope-run training (per-stage overrides
                              enable fan-out sweeps over one shared record)
  * :class:`ServeStage`     — batched serving smoke via ServeEngine
  * :class:`EvalStage`      — held-out loss of a trained state
  * :class:`ValidateStage`  — template checks over the metric history
  * :class:`VisualizeStage` — loss-curve artifact
  * :class:`ExploreStage`   — cost-performance sweep
                              (:mod:`repro_torch.core.explore`) with
                              per-cell stage-cache reuse and a Markdown
                              artifact
  * :class:`CalibrateStage` — harvest runs into the calibration store
                              and refit the cost model
  * :class:`MoveStage`      — explicit cross-backend data movement

The workload stages build their model on ``ctx.params["device"]``
(``cuda`` unless the caller asks for the CPU; no GPU raises), log an
``environment`` event naming torch, CUDA and the card, and initialise
through :func:`init_train_state_for` and :func:`init_serve_params`, the
one place a test swaps in bridged reference weights.  The explore and
calibrate stages are the reference's (:mod:`repro_torch.core.explore`,
:mod:`repro_torch.core.calibrate`, whose harvester takes a run only if it
ran on the chip its plan names).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Stage, StageContext
from repro_torch.core.intent import ResourceIntent
from repro_torch.core.planner import plan_stages, to_runtime_plan
from repro_torch.core.provenance import capture_environment


# ===========================================================================
# Validation checks — the early-failure nets templates carry
# ===========================================================================
def _check_loss_finite(history: List[Dict]) -> Tuple[bool, str]:
    bad = [h["step"] for h in history if not np.isfinite(h.get("loss", np.nan))]
    return (not bad, f"non-finite loss at steps {bad[:5]}" if bad else "all losses finite")


def _check_loss_decreased(history: List[Dict]) -> Tuple[bool, str]:
    losses = [h["loss"] for h in history if "loss" in h]
    if len(losses) < 4:
        return False, "too few steps to judge"
    k = max(2, len(losses) // 4)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    return (last < first, f"loss {first:.4f} -> {last:.4f}")


def _check_grad_norm(history: List[Dict]) -> Tuple[bool, str]:
    gs = [h.get("grad_norm") for h in history if h.get("grad_norm") is not None]
    if not gs:
        return True, "no grad norms recorded"
    mx = max(gs)
    return (np.isfinite(mx) and mx < 1e4, f"max grad norm {mx:.2f}")


def _check_throughput(history: List[Dict]) -> Tuple[bool, str]:
    ts = [h.get("step_time_s", 0) for h in (history[1:] if len(history) > 1 else history)]
    return (bool(ts) and all(t > 0 for t in ts), f"median step {np.median(ts):.4f}s" if ts else "no steps")


CHECKS: Dict[str, Callable[[List[Dict]], Tuple[bool, str]]] = {
    "loss_finite": _check_loss_finite,
    "loss_decreased": _check_loss_decreased,
    "grad_norm_bounded": _check_grad_norm,
    "throughput_positive": _check_throughput,
}


def _reduced_workload(t, smoke_batch: int = 4,
                      smoke_seq: int = 32) -> Tuple[Any, Any, Any]:
    """(full_cfg, cfg, shape) for a template, honoring its scale."""
    from repro_torch.configs import ShapeConfig, get_config, get_shape, reduced

    full_cfg = get_config(t.arch)
    cfg = reduced(full_cfg) if t.scale == "reduced" else full_cfg
    shape_full = get_shape(t.shape)
    if t.scale == "reduced":
        shape = ShapeConfig(shape_full.name, smoke_seq, smoke_batch,
                            shape_full.kind)
    else:
        shape = shape_full
    return full_cfg, cfg, shape


def _require_record(ctx: StageContext, stage: Stage, why: str) -> None:
    if ctx.record is None:
        raise ValueError(
            f"{type(stage).__name__} {stage.name!r} needs a StageContext "
            f"with a record ({why})"
        )


def _build_model(ctx: StageContext, stage: Stage, cfg):
    """The stage's model on ``ctx.params["device"]`` (default ``cuda``),
    with an ``environment`` event naming the device it runs on."""
    from repro_torch.models import build_model

    model = build_model(cfg, device=ctx.params.get("device", "cuda"))
    if ctx.record is not None:
        ctx.record.log_event("environment", {
            "stage": stage.name, "device": str(model.device),
            **capture_environment()})
    return model


def _device_batch(raw: Dict[str, Any], device) -> Dict[str, Any]:
    """Host batch (numpy) -> tensors on the model's device, with the
    reference's bf16 casts of the modality inputs (``frames``,
    ``image_embeds``) shared by the train and eval stages."""
    import torch

    batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}
    for k in ("frames", "image_embeds"):
        if k in batch:
            batch[k] = batch[k].to(torch.bfloat16)
    return batch


def init_train_state_for(model, seed: int, opt_cfg, rt_plan):
    """The train stages' initial state: the port's own init from the
    template's data seed."""
    from repro_torch.train import init_train_state

    return init_train_state(model, seed, opt_cfg, rt_plan)


def init_serve_params(model, seed: int):
    """The serve stage's weights: the port's own init from ``seed``."""
    return model.init(seed)


# ===========================================================================
# Plan
# ===========================================================================
class PlanStage(Stage):
    """Resolve one PlanChoice per stage and authorize the budget.

    ``stage_goals`` maps stage names to intent goals; each listed stage
    gets the main intent re-aimed at that goal and its own planner pass,
    so e.g. a data stage plans ``quick_test`` (smallest feasible slice)
    while train plans ``production``.  Outputs:

      * ``plan_choice``    — the main (train/serve) stage's winner
      * ``stage_plans``    — {stage_name: PlanChoice | None}; the
                             scheduler binds each listed stage to its
                             choice (``placement`` provenance events)
      * ``rt_plan``        — runtime sharding Plan for the main workload
      * ``projected_cost`` — $ projection used for the budget gate

    Budget protocol: this stage *authorizes* the projected spend (raising
    BudgetExceeded/PermissionDenied before any workload runs) but does
    not charge it — the runner charges ``projected_cost`` after the
    workload completes, as ``run_workflow`` does.  Custom runners that
    pass a ledger in the context must do the same.
    """

    outputs = ("plan_choice", "stage_plans", "rt_plan", "projected_cost")
    cache_params = ("intent", "steps_override")

    def __init__(self, name: str = "plan",
                 stage_goals: Optional[Dict[str, str]] = None):
        super().__init__(name)
        self.stage_goals = dict(stage_goals or {})

    def resume_safe(self, ctx: StageContext) -> bool:
        """Never skip on resume while a budget ledger is attached: the
        skip would restore the plan without re-running the
        ``ledger.authorize`` gate, letting a resumed run spend budget it
        was never granted."""
        return ctx.ledger is None

    def _main_intent(self, ctx: StageContext) -> ResourceIntent:
        intent = ctx.params.get("intent")
        if intent is None:
            intent = ctx.template.default_intent()
        return intent

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        t = ctx.template
        intent = self._main_intent(ctx)
        intents = {"__main__": intent}
        for stage_name, goal in self.stage_goals.items():
            intents[stage_name] = intent.with_goal(goal)
        stage_plans = plan_stages(intents)
        choice = stage_plans.pop("__main__")

        projected = 0.0
        if choice is not None:
            steps = ctx.params.get("steps_override") or t.num_steps
            projected = choice.est.cost_per_step * steps
        if ctx.ledger is not None:
            ctx.ledger.authorize(ctx.workspace, ctx.user, t.name, projected)

        plan_doc = {
            "slice": choice.slice.name if choice else "local",
            "mesh_shape": choice.mesh_shape if choice else (1,),
            "est_step_s": choice.est.step_s if choice else None,
            "est_cost_per_step": choice.est.cost_per_step if choice else None,
            "bottleneck": choice.est.bottleneck if choice else None,
        }
        if choice is not None:
            # roofline terms + identity keys the calibration harvester
            # (repro.core.calibrate.harvest_run) pairs with measured step
            # times — without these a finished run contributes no telemetry
            from repro_torch.configs import get_shape
            plan_doc.update(
                chip=choice.slice.chip.name,
                kind=get_shape(intent.shape).kind,
                compute_s=choice.est.compute_s,
                memory_s=choice.est.memory_s,
                collective_s=choice.est.collective_s,
                remat=choice.geometry.remat,
                microbatch=choice.geometry.microbatch,
            )
        if ctx.record is not None:
            placements_doc = {
                name: ({"slice": c.slice.name,
                        "mesh_shape": list(c.mesh_shape)}
                       if c is not None else None)
                for name, c in sorted(stage_plans.items())
            }
            ctx.record.update_manifest(plan=plan_doc,
                                       stage_placements=placements_doc)
            if choice is not None:
                ctx.record.log_event("plan", {"summary": choice.summary})
            for stage_name, c in sorted(stage_plans.items()):
                if c is not None:
                    ctx.record.log_event("plan", {"stage": stage_name,
                                                  "summary": c.summary})

        from repro_torch.train import Plan as RuntimePlan

        rt_plan = to_runtime_plan(choice) if choice else RuntimePlan()
        if t.scale == "reduced":
            rt_plan = dataclasses.replace(rt_plan, microbatch=1)
        return {"plan_choice": choice, "stage_plans": stage_plans,
                "rt_plan": rt_plan, "projected_cost": projected}


# ===========================================================================
# Data
# ===========================================================================
class DataStage(Stage):
    """Build the (possibly reduced) model config, shape and data stream.

    Cacheable across runs: the outputs are a pure function of the
    template's (arch, shape, scale, data) fields and the smoke knobs,
    so a sweep's fan-out or a re-run skips this stage on a cache hit.
    """

    outputs = ("full_cfg", "cfg", "shape", "stream")
    # pure python (configs + a seeded numpy stream, no tensor, no record
    # writes) — safe to marshal into a process-pool child
    process_safe = True
    cacheable = True
    cache_params = ("smoke_batch", "smoke_seq")
    cache_template_fields = ("arch", "shape", "scale", "data")

    def __init__(self, name: str = "data", build_stream: bool = True):
        super().__init__(name)
        self.build_stream = build_stream

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        from repro_torch.data import make_stream

        t = ctx.template
        full_cfg, cfg, shape = _reduced_workload(
            t, smoke_batch=ctx.params.get("smoke_batch", 4),
            smoke_seq=ctx.params.get("smoke_seq", 32))
        stream = make_stream(cfg, shape, t.data) if self.build_stream else None
        return {"full_cfg": full_cfg, "cfg": cfg, "shape": shape,
                "stream": stream}


# ===========================================================================
# Train
# ===========================================================================
class TrainStage(Stage):
    """Envelope-run training.

    ``overrides`` applies template parameter injection for this stage
    only (a sweep's fan-out knob); ``state_key`` renames the produced
    state so several TrainStages can coexist in one graph.  Metrics and
    checkpoints are scoped per stage (stage column in metrics.jsonl,
    ``ckpt-<name>`` artifact dir), so concurrent trains stay separable.

    The train step updates the state in place (the reference's
    donation; ``donate=False`` or ctx param ``donate=False`` steps a
    copy instead).  Each step's metrics are read to the host once, as
    floats, so the step's wall time covers its device work and the
    record holds no tensor.

    Resilience: the stage checkpoints through the run's artifacts dir,
    so a retried or resumed attempt restores from the newest committed
    step automatically, onto the model's device.  The reference restores
    onto a re-planned placement's mesh; one card has no mesh, so the
    stage logs ``reshard_skipped`` instead (ROADMAP queue 1, parallelism
    and elasticity).
    """

    inputs = ("cfg", "shape", "stream", "rt_plan")
    placement_key = "__main__"
    cache_params = ("steps_override", "donate")
    device_bound = True
    # the checkpointer already persists the state in this run dir; a
    # resume re-enters run() and restores the newest committed step, so
    # pickling the full {params, opt} tree into the run manifest would
    # only duplicate it
    resume_payload = False

    def __init__(self, name: str = "train",
                 overrides: Optional[Dict[str, Any]] = None,
                 state_key: str = "final_state",
                 donate: bool = True):
        super().__init__(name)
        self.overrides = dict(overrides or {})
        self.state_key = state_key
        self.donate = donate
        self.outputs = (state_key,)

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.core.envelope import ExecutionEnvelope
        from repro_torch.train import keep_input_state, make_train_step

        _require_record(ctx, self,
                        "the envelope logs metrics/checkpoints through it")
        t = ctx.template
        if self.overrides:
            t = t.with_overrides(**self.overrides)
        cfg = ctx.get("cfg")
        stream = ctx.get("stream")
        rt_plan = ctx.get("rt_plan")
        model = _build_model(ctx, self, cfg)
        num_steps = ctx.params.get("steps_override") or t.num_steps

        step_raw = make_train_step(model, t.optimizer, rt_plan)
        if not (self.donate and ctx.params.get("donate", True)):
            step_raw = keep_input_state(step_raw)

        def init_fn():
            return init_train_state_for(model, t.data.seed, t.optimizer,
                                        rt_plan)

        def step_fn(state, step):
            state, metrics = step_raw(
                state, _device_batch(stream.batch_at(step), model.device))
            return state, {k: float(v) for k, v in metrics.items()}

        record = ctx.record.stage_view(self.name)
        ckpt = Checkpointer(f"{ctx.record.artifacts_dir}/ckpt-{self.name}",
                            keep=2)
        self._restore_shardings(ctx, ckpt)
        env = ExecutionEnvelope(
            record, checkpointer=ckpt, checkpoint_every=t.checkpoint_every,
            failures=ctx.params.get("failures"),
        )
        state = env.run(init_state=init_fn, step_fn=step_fn,
                        num_steps=num_steps)
        return {self.state_key: state}

    def _restore_shardings(self, ctx, ckpt) -> None:
        """When a committed checkpoint exists (stage retry or run
        resume) and the scheduler bound this stage to a placement, the
        reference restores onto that placement's mesh.  The port restores
        onto the model's device and says so in a ``reshard_skipped``
        event."""
        placement = ctx.current_placement() \
            if hasattr(ctx, "current_placement") else None
        if placement is None or ckpt.latest_step() is None:
            return
        if ctx.record is not None:
            ctx.record.log_event("reshard_skipped", {
                "stage": self.name, "slice": placement.slice_name,
                "error": "restoring onto a placement's mesh is not ported: "
                         "ROADMAP queue 1, parallelism and elasticity"})


# ===========================================================================
# Serve
# ===========================================================================
class ServeStage(Stage):
    """Batched-serving smoke through the ServeEngine.

    The engine mode and chunking are knobs: constructor args, overridable
    per run via the ``serve_engine`` / ``serve_chunk`` context params
    (the CLI's ``--serve-engine`` / ``--serve-chunk``).  ``fused`` is the
    on-device batched-sampling fast path; ``legacy`` keeps the per-slot
    host-sampling baseline around for A/B runs; ``paged`` serves from
    the paged KV pool (prefix sharing, HBM proportional to live
    tokens — see docs/serving.md).  ``serve_spec_k`` / ``serve_draft``
    (the CLI's ``--serve-spec-k`` / ``--serve-draft``) turn on lossless
    speculative decoding: k drafts per verify round from the n-gram
    proposer, or from a reduced draft model named by arch.  ``legacy``
    is not ported: the port's engine raises for it."""

    inputs = ("cfg",)
    outputs = ("final_state", "completions")
    placement_key = "__main__"
    cache_params = ("serve_engine", "serve_chunk", "serve_spec_k",
                    "serve_draft", "smoke_batch", "smoke_seq")
    device_bound = True

    def __init__(self, name: str = "serve", engine: str = "fused",
                 decode_chunk: int = 1):
        super().__init__(name)
        self.engine = engine
        self.decode_chunk = decode_chunk

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        from repro_torch.models import build_model
        from repro_torch.serve.engine import smoke_serve

        t = ctx.template
        cfg = ctx.get("cfg")
        smoke_batch = ctx.params.get("smoke_batch", 4)
        smoke_seq = ctx.params.get("smoke_seq", 32)
        engine = ctx.params.get("serve_engine", self.engine)
        decode_chunk = ctx.params.get("serve_chunk", self.decode_chunk)
        spec_k = ctx.params.get("serve_spec_k", 0)
        draft_arch = ctx.params.get("serve_draft", "")
        model = _build_model(ctx, self, cfg)
        params = init_serve_params(model, t.data.seed)
        draft = draft_params = None
        if draft_arch:
            from repro_torch.configs import get_config, reduced
            draft = build_model(reduced(get_config(draft_arch)),
                                device=model.device)
            draft_params = init_serve_params(draft, t.data.seed + 1)
        completions, stats = smoke_serve(
            model, params, num_requests=smoke_batch * 2,
            max_batch=smoke_batch, max_seq=smoke_seq + 64,
            vocab_size=cfg.vocab_size, seed=t.data.seed,
            engine=engine, decode_chunk=decode_chunk,
            spec_k=spec_k, draft=draft, draft_params=draft_params,
        )
        if ctx.record is not None:
            ctx.record.stage_view(self.name).log(0, stats)
        return {"final_state": completions, "completions": completions}


# ===========================================================================
# Explore
# ===========================================================================
class ExploreStage(Stage):
    """Run a cost-performance sweep (:func:`repro_torch.core.explore.explore`)
    as a workflow stage.

    The spec comes from the constructor or the ``explore_spec`` context
    param (the latter wins, which is how a fan-out graph sweeps several
    grids over one template).  When the run has a
    :class:`~repro_torch.core.stagecache.StageCache` attached, every grid
    *cell* is cached under its own content-addressed key (cell
    coordinates + constraints + catalog generation), so a re-run or a
    resumed sweep recomputes only cells the catalog change actually
    invalidated.  The rendered Markdown report lands in the run's
    artifacts dir as ``explore.md`` and an ``explore`` provenance event
    records the headline numbers.
    """

    outputs = ("explore_result", "explore_report")
    cache_params = ("explore_spec",)

    def __init__(self, name: str = "explore", spec: Any = None,
                 report_name: str = "explore.md"):
        super().__init__(name)
        self.spec = spec
        self.report_name = report_name

    def spec_config(self) -> Dict[str, Any]:
        """Serialize the nested ExploreSpec by field instead of letting
        the base class emit an ``__opaque__`` marker for it."""
        cfg = super().spec_config()
        cfg["spec"] = (dataclasses.asdict(self.spec)
                       if self.spec is not None else None)
        return cfg

    @classmethod
    def from_spec_config(cls, name: str, config: Dict[str, Any]) -> "ExploreStage":
        from repro_torch.core.explore import ExploreSpec

        config = dict(config)
        spec = config.pop("spec", None)
        if spec is not None:
            spec = ExploreSpec(**spec)  # __post_init__ re-tuples the axes
        return cls(name, spec=spec, **config)

    def signature(self) -> Dict[str, Any]:
        """Fold the constructor spec and the catalog generation into the
        stage identity: the base signature() keeps only primitive attrs,
        which would let a resume skip restore a *different* spec's
        result — and a catalog that gained a slice type must miss the
        resume/cache hash so the sweep re-plans."""
        from repro_torch.core import calibrate
        from repro_torch.core.catalog import catalog_generation

        sig = super().signature()
        sig["spec"] = (dataclasses.asdict(self.spec)
                       if self.spec is not None else None)
        sig["catalog_generation"] = catalog_generation()
        # an activated calibration re-scores every cell, so the resume
        # hash must miss when the active coefficient set changes
        sig["calibration_generation"] = calibrate.active_generation()
        return sig

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        import json

        from repro_torch.core.explore import explore, report_markdown, result_doc

        spec = ctx.params.get("explore_spec", self.spec)
        if spec is None:
            raise ValueError(
                f"ExploreStage {self.name!r} needs an ExploreSpec (pass "
                f"spec= to the constructor or explore_spec in ctx.params)")
        result = explore(spec, cache=ctx.cache)
        report = report_markdown(result)
        if ctx.record is not None:
            path = f"{ctx.record.artifacts_dir}/{self.report_name}"
            with open(path, "w", encoding="utf-8") as f:
                f.write(report)
            doc_path = path.rsplit(".", 1)[0] + ".json"
            with open(doc_path, "w", encoding="utf-8") as f:
                json.dump(result_doc(result), f, indent=2, sort_keys=True)
            ctx.record.log_event("explore", {
                "stage": self.name,
                "cells": len(result.cells),
                "feasible_cells": result.feasible_cells,
                "cells_from_cache": result.cells_from_cache,
                "frontier_size": len(result.frontier),
                "catalog_generation": result.catalog_generation,
                "report": path,
            })
        return {"explore_result": result, "explore_report": report}


# ===========================================================================
# Calibrate
# ===========================================================================
class CalibrateStage(Stage):
    """Harvest this run's telemetry into the calibration store and refit
    the cost model (:mod:`repro_torch.core.calibrate`).

    Placed after a workload stage, it pairs the manifest's planned
    roofline terms with the measured step times (``harvest_run``),
    optionally folds in other finished runs (``runs_root``) and bench
    result files (``bench_paths``), ingests everything into the
    flocked :class:`~repro_torch.core.calibrate.CalibrationStore`, refits the
    per-(chip, kind) coefficients, and reports drift.  With
    ``activate=True`` the fresh fit becomes the process-wide active
    calibration — subsequent plans (and their memo keys) pick it up
    immediately.

    Deliberately uncacheable: its job is absorbing *new* telemetry; a
    cache hit would silently drop this run's samples.
    """

    outputs = ("calibration", "drift_report")

    def __init__(self, name: str = "calibrate",
                 store_path: Optional[str] = None,
                 runs_root: Optional[str] = None,
                 bench_paths: Tuple[str, ...] = (),
                 min_samples: int = 4,
                 drift_threshold: float = 0.25,
                 activate: bool = False):
        super().__init__(name)
        self.store_path = store_path
        self.runs_root = runs_root
        self.bench_paths = tuple(bench_paths)
        self.min_samples = int(min_samples)
        self.drift_threshold = float(drift_threshold)
        self.activate = bool(activate)

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        from repro_torch.core import calibrate

        samples: List[Any] = []
        if ctx.record is not None:
            samples.extend(calibrate.harvest_run(ctx.record))
        if self.runs_root:
            samples.extend(calibrate.harvest_runs_dir(self.runs_root))
        for path in self.bench_paths:
            samples.extend(calibrate.harvest_bench(path))

        store = calibrate.CalibrationStore(self.store_path)
        added = store.ingest(samples)
        cal = store.fit(min_samples=self.min_samples)
        drift = store.drift(threshold=self.drift_threshold,
                            calibration=cal)
        if self.activate:
            calibrate.activate(cal)

        if ctx.record is not None:
            lines = [f"# Calibration (generation {cal.generation})", ""]
            lines.append(f"- samples harvested: {len(samples)} "
                         f"({added} new)")
            for c in cal.cells:
                lines.append(
                    f"- {c.chip}/{c.kind}: mode={c.mode} "
                    f"a_c={c.a_compute:.4f} a_m={c.a_memory:.4f} "
                    f"a_x={c.a_collective:.4f} b={c.intercept:.2e} "
                    f"scale={c.scale:.4f} n={c.n_samples} "
                    f"resid={c.residual:.3e}")
            lines += ["", "## Drift", "", drift.summary(), ""]
            path = f"{ctx.record.artifacts_dir}/calibration.md"
            with open(path, "w", encoding="utf-8") as f:
                f.write("\n".join(lines))
            ctx.record.log_event("calibrate", {
                "stage": self.name,
                "samples": len(samples),
                "new_samples": added,
                "cells": len(cal.cells),
                "generation": cal.generation,
                "drifted": len(drift.drifted),
                "activated": self.activate,
                "report": path,
            })
        return {"calibration": cal, "drift_report": drift}


# ===========================================================================
# Move
# ===========================================================================
class MoveStage(Stage):
    """Explicit cross-backend data movement for one context key.

    Inserted (by hand, or by :func:`repro.core.check.insert_movement_stages`)
    between a producer and a consumer the planner bound to *different*
    slices, where the implicit shared-blackboard handoff would hide a
    real transfer.  In this single-process harness the blackboard already
    holds the value, so the stage's job is to make the movement a
    first-class, observable step: it verifies the key is present,
    emits a ``data_move`` provenance event with a structural size
    summary, and acts as an ordering barrier (consumers are rewired to
    depend on it).  It declares no outputs — the key stays owned by its
    producer, so inserting a move can never trip the duplicate-producer
    validation.
    """

    def __init__(self, name: str, key: str = "", src: str = "", dst: str = ""):
        super().__init__(name)
        self.key = key
        self.src = src
        self.dst = dst
        self.inputs = (key,) if key else ()

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        from repro_torch.core.graph import _describe

        value = ctx.get(self.key)
        if ctx.record is not None:
            ctx.record.log_event("data_move", {
                "stage": self.name, "key": self.key,
                "src": self.src, "dst": self.dst,
                "value": _describe(value),
            })
        return {}


# ===========================================================================
# Eval
# ===========================================================================
class EvalStage(Stage):
    """Held-out loss of a trained state on freshly-seeded batches."""

    inputs = ("cfg", "shape")
    # not process_safe, unlike the reference's: the body runs the model
    # on the card, and a forked child must not touch the parent's CUDA
    # state

    def __init__(self, name: str = "eval", state_key: str = "final_state",
                 num_batches: int = 2, seed_offset: int = 10_000,
                 loss_key: Optional[str] = None):
        super().__init__(name)
        self.state_key = state_key
        self.num_batches = num_batches
        self.seed_offset = seed_offset
        self.loss_key = loss_key or f"eval_loss.{name}"
        self.outputs = (self.loss_key,)

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        import torch

        from repro_torch.data import make_stream

        t = ctx.template
        cfg = ctx.get("cfg")
        shape = ctx.get("shape")
        state = ctx.get(self.state_key)
        model = _build_model(ctx, self, cfg)
        dcfg = dataclasses.replace(t.data, seed=t.data.seed + self.seed_offset)
        stream = make_stream(cfg, shape, dcfg)
        losses = []
        with torch.no_grad():
            for i in range(self.num_batches):
                loss, _ = model.loss(
                    state["params"],
                    _device_batch(stream.batch_at(i), model.device))
                losses.append(float(loss))
        mean = float(np.mean(losses)) if losses else float("nan")
        if ctx.record is not None:
            ctx.record.log_event("eval", {"stage": self.name,
                                          "loss": mean,
                                          "num_batches": self.num_batches})
        return {self.loss_key: mean}


# ===========================================================================
# Validate & visualize
# ===========================================================================
class ValidateStage(Stage):
    """Run the template's checks over the metric history.

    ``source`` limits the history to one stage's rows (for sweeps);
    by default all metric rows count, matching the monolithic runner.
    """

    outputs = ("checks",)

    def __init__(self, name: str = "validate",
                 source: Optional[str] = None,
                 checks: Optional[Tuple[str, ...]] = None):
        super().__init__(name)
        self.source = source
        self.checks = checks

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        _require_record(ctx, self, "checks read the metric history back")
        t = ctx.template
        history = ctx.record.metrics()
        if self.source is not None:
            history = [h for h in history if h.get("stage") == self.source]
        names = self.checks if self.checks is not None else t.checks
        checks: Dict[str, Tuple[bool, str]] = {}
        for name in names:
            checks[name] = CHECKS[name](history)
            ctx.record.log_event("check", {
                "name": name, "ok": checks[name][0],
                "detail": checks[name][1],
            })
        return {"checks": checks}


class VisualizeStage(Stage):
    """Loss-curve artifact (one line per stage when several trained)."""

    def __init__(self, name: str = "visualize", filename: str = "loss.png"):
        super().__init__(name)
        self.filename = filename

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        _require_record(ctx, self, "plots read metrics and write artifacts")
        record = ctx.record
        history = record.metrics()
        if not history:
            return {}
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return {}
        by_stage: Dict[str, Tuple[List, List]] = {}
        for h in history:
            if "loss" not in h:
                continue
            key = str(h.get("stage", "train"))
            xs, ys = by_stage.setdefault(key, ([], []))
            xs.append(h["step"])
            ys.append(h["loss"])
        if not by_stage:
            return {}
        fig, ax = plt.subplots(figsize=(6, 3.5))
        for key, (xs, ys) in sorted(by_stage.items()):
            ax.plot(xs, ys, lw=1.5,
                    label=key if len(by_stage) > 1 else None)
        ax.set_xlabel("step")
        ax.set_ylabel("loss")
        ax.set_title(record.manifest.get("template", "run"))
        if len(by_stage) > 1:
            ax.legend(fontsize=8)
        ax.grid(alpha=0.3)
        fig.tight_layout()
        path = f"{record.artifacts_dir}/{self.filename}"
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return {"loss_plot": path}
