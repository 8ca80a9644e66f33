"""The Workflow Engine (paper §4.2): parameterized, versioned, expert-
crafted templates compiled into composable stage graphs.

Overview
--------
A workflow is a DAG of stages (``repro_torch.core.graph``), each one phase of
the paper's lifecycle — environment/plan, data processing, simulation or
training, result capture/validation, visualization.  The built-in stage
library (``repro_torch.core.stages``) decomposes what used to be a 130-line
monolithic runner; :func:`compile_template` lowers a
:class:`WorkflowTemplate` into the canonical graph::

    plan ─────┐
              ├─> train ──> validate ──> visualize     (kind="train")
    data ─────┘

``plan`` and ``data`` have no edge between them, so they run
concurrently; each stage emits ``stage_start``/``stage_end`` provenance
events with timing and an outputs hash into the RunRecord.  The planner
resolves a separate PlanChoice per stage that declares an intent goal
(`plan_stages`), so a cheap data-prep stage and an expensive train stage
can land on different slices.

Authoring custom workflows
--------------------------
Build a graph directly for anything the canonical shape doesn't cover —
e.g. a fan-out sweep (``examples/pipeline_sweep.py``)::

    g = StageGraph("sweep")
    g.add(PlanStage(stage_goals={"data": "quick_test"}))
    g.add(DataStage())
    for i, lr in enumerate(lrs):
        g.add(TrainStage(f"train-{i}", overrides={"optimizer.lr": lr},
                         state_key=f"state.{i}"),
              depends_on=("plan", "data"))
    g.add_fn("compare", compare_fn, depends_on=[f"train-{i}" ...])
    g.execute(StageContext(template=t, record=rec, params={...}))

Custom stages subclass :class:`~repro_torch.core.graph.Stage` (declare
``inputs``/``outputs``, implement ``run(ctx) -> dict``); graphs nest via
``g.as_stage("name")``.

Compatibility
-------------
``run_workflow(template, store, ...)`` survives as a thin wrapper:
compile, execute, wrap the results — same checks, same provenance keys,
same exceptions (e.g. BudgetExceeded) as the monolith.  ``stages=``
restricts execution to a subgraph (the CLI's ``run --stage``).

A copy of the reference package's ``core/workflow.py``: the same eleven
templates, the same canonical graphs, the same runner, on the port's
torch stages.  ``run_workflow`` takes one more argument, ``device``
(default ``cuda``), which every stage that builds a model reads.
"""
from __future__ import annotations

import dataclasses
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.budget import BudgetExceeded, BudgetLedger, PermissionDenied
from repro_torch.core.executor import Executor, make_executor
from repro_torch.core.graph import Placement, StageContext, StageGraph, StageResult
from repro_torch.core.intent import ResourceIntent
from repro_torch.core.planner import PlanChoice
from repro_torch.core.provenance import ProvenanceStore, RunRecord
from repro_torch.core.stagecache import RunManifest, StageCache
from repro_torch.core.stages import (
    CHECKS,
    DataStage,
    EvalStage,
    PlanStage,
    ServeStage,
    TrainStage,
    ValidateStage,
    VisualizeStage,
)
from repro_torch.data import DataConfig
from repro_torch.ft.failures import FailureSchedule, RestartPolicy
from repro_torch.train import OptimizerConfig


# ===========================================================================
# Templates & registry
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class WorkflowTemplate:
    name: str
    version: str
    description: str
    arch: str
    shape: str
    kind: str = "train"  # train | serve
    num_steps: int = 20
    scale: str = "reduced"  # reduced (CPU-runnable) | full (dry-run/TPU)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    intent_defaults: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # parameter injection (paper: q=0.25 -> 0.5 with one override)
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    checks: Tuple[str, ...] = ("loss_finite", "loss_decreased", "throughput_positive")
    checkpoint_every: int = 10
    visualize: bool = True
    author: str = "platform"

    def config_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d

    def default_intent(self) -> ResourceIntent:
        """The ResourceIntent this template implies when the caller does
        not supply one — the single source for the runner, PlanStage and
        the placement preview, so they can never diverge."""
        return ResourceIntent(
            arch=self.arch, shape=self.shape,
            goal=self.intent_defaults.get("goal", "production"),
            **{k: v for k, v in self.intent_defaults.items()
               if k != "goal"},
        )

    def with_overrides(self, **kw) -> "WorkflowTemplate":
        """Parameter injection: override template fields or optimizer/data
        sub-fields with dotted keys ('optimizer.lr', 'data.seed')."""
        base = self
        flat = dict(base.overrides)
        flat.update(kw)
        opt, data, top = {}, {}, {}
        for k, v in flat.items():
            if k.startswith("optimizer."):
                opt[k.split(".", 1)[1]] = v
            elif k.startswith("data."):
                data[k.split(".", 1)[1]] = v
            else:
                top[k] = v
        new_opt = dataclasses.replace(base.optimizer, **opt) if opt else base.optimizer
        new_data = dataclasses.replace(base.data, **data) if data else base.data
        return dataclasses.replace(
            base, optimizer=new_opt, data=new_data, overrides=flat, **top
        )


class WorkflowRegistry:
    """Versioned template catalog with group visibility."""

    def __init__(self):
        self._templates: Dict[Tuple[str, str], WorkflowTemplate] = {}

    def register(self, t: WorkflowTemplate) -> None:
        key = (t.name, t.version)
        if key in self._templates:
            raise ValueError(f"template {key} already registered (versions are immutable)")
        self._templates[key] = t

    def get(self, name: str, version: Optional[str] = None) -> WorkflowTemplate:
        versions = sorted(v for (n, v) in self._templates if n == name)
        if not versions:
            raise KeyError(f"no template named {name!r}")
        version = version or versions[-1]
        return self._templates[(name, version)]

    def list(self) -> List[Tuple[str, str, str]]:
        return sorted(
            (n, v, t.description) for (n, v), t in self._templates.items()
        )

    def register_from_spec(self, doc_or_path: Any) -> WorkflowTemplate:
        """Register the template carried by a package document (or a
        path to one) — how a shared ``pack`` artifact enters another
        user's registry."""
        from repro_torch.core.spec import (SpecError, load_spec,
                                           unpack_package)

        doc = (load_spec(doc_or_path) if isinstance(doc_or_path, str)
               else doc_or_path)
        template, _, _ = unpack_package(doc)
        if template is None:
            raise SpecError("package carries no template block")
        self.register(template)
        return template


REGISTRY = WorkflowRegistry()


def _default_templates():
    smoke_opt = OptimizerConfig(lr=2e-3, warmup_steps=3, total_steps=400,
                                weight_decay=0.01)
    for arch in ("qwen2-1.5b", "glm4-9b", "xlstm-125m", "hymba-1.5b",
                 "phi3.5-moe-42b-a6.6b", "whisper-large-v3", "qwen1.5-4b",
                 "internlm2-20b", "qwen3-moe-235b-a22b", "phi-3-vision-4.2b"):
        REGISTRY.register(WorkflowTemplate(
            name=f"train-{arch}",
            version="1.0.0",
            description=f"Validated training recipe for {arch} (synthetic stream)",
            arch=arch,
            shape="train_4k",
            optimizer=smoke_opt,
        ))
    REGISTRY.register(WorkflowTemplate(
        name="serve-qwen2-1.5b",
        version="1.0.0",
        description="Batched serving recipe for qwen2-1.5b",
        arch="qwen2-1.5b",
        shape="decode_32k",
        kind="serve",
        checks=("throughput_positive",),
    ))


_default_templates()


# ===========================================================================
# Template -> canonical stage graph
# ===========================================================================
def compile_template(t: WorkflowTemplate, *, with_eval: bool = False) -> StageGraph:
    """Lower a template into its canonical stage graph.

    Train templates become the 5-stage graph
    ``{plan, data} -> train -> validate -> visualize`` (plan and data are
    independent and run concurrently); serve templates become
    ``{plan, data} -> serve -> validate``.  ``with_eval=True`` inserts an
    EvalStage between train and validate.
    """
    g = StageGraph(t.name)
    if t.kind == "train":
        g.add(PlanStage(stage_goals={"data": "quick_test"}))
        g.add(DataStage())
        g.add(TrainStage(), depends_on=("plan", "data"))
        tail = "train"
        if with_eval:
            g.add(EvalStage(), depends_on=("train",))
            tail = "eval"
        g.add(ValidateStage(), depends_on=(tail,))
        if t.visualize:
            g.add(VisualizeStage(), depends_on=("validate",))
    elif t.kind == "serve":
        g.add(PlanStage(stage_goals={"data": "quick_test"}))
        g.add(DataStage(build_stream=False))
        g.add(ServeStage(), depends_on=("plan", "data"))
        g.add(ValidateStage(), depends_on=("serve",))
    else:
        raise ValueError(f"unknown workflow kind {t.kind!r}")
    g.validate()
    return g


def resolve_placement_map(
    graph: StageGraph,
    *,
    template: Optional[WorkflowTemplate] = None,
    intent: Optional[ResourceIntent] = None,
) -> Dict[str, Optional[Placement]]:
    """Static preview of per-stage backend bindings — the same
    resolution the scheduler applies at launch time: a stage's entry in
    the PlanStage's ``stage_goals``, its own ``intent``, or the main
    workload's plan for ``placement_key == "__main__"`` stages.

    Returns :class:`Placement` objects keyed by stage name; ``None``
    marks a stage that runs on the coordinator (PlanStage); stages with
    no resolvable backend are omitted (they run locally).  ``intent``
    defaults to the template's; with neither, only per-stage intents
    resolve.  This is the single source for the CLI's placement
    rendering and the checker's placement-gap analysis (ADV005)."""
    from repro_torch.core.planner import plan_stages

    if intent is None and template is not None:
        intent = template.default_intent()
    intents: Dict[str, ResourceIntent] = {}
    if intent is not None:
        intents["__main__"] = intent
        for s in graph.stages.values():
            if isinstance(s, PlanStage):
                for stage_name, goal in s.stage_goals.items():
                    intents[stage_name] = intent.with_goal(goal)
    for s in graph.stages.values():
        # mirror the scheduler's order: a stage_goals entry wins over the
        # stage's own intent (which is only the runtime fallback)
        if s.intent is not None:
            intents.setdefault(s.name, s.intent)
    plans = plan_stages(intents) if intents else {}
    main = plans.pop("__main__", None)
    out: Dict[str, Optional[Placement]] = {}
    for name, s in graph.stages.items():
        choice = main if s.placement_key == "__main__" else plans.get(name)
        if choice is not None:
            out[name] = Placement.from_choice(name, choice)
        elif isinstance(s, PlanStage):
            out[name] = None  # coordinator (local)
    return out


def resolve_placements(
    t: WorkflowTemplate,
    graph: StageGraph,
    intent: Optional[ResourceIntent] = None,
) -> Dict[str, str]:
    """Render-string form of :func:`resolve_placement_map` (the CLI's
    ``graph --placements``)."""
    return {
        name: (p.render() if p is not None else "coordinator (local)")
        for name, p in resolve_placement_map(
            graph, template=t, intent=intent).items()
    }


# ===========================================================================
# The single-command runner (adviser run analogue) — compat wrapper
# ===========================================================================
@dataclasses.dataclass
class WorkflowResult:
    record: RunRecord
    plan_choice: Optional[PlanChoice]
    checks: Dict[str, Tuple[bool, str]]
    final_state: Any
    ok: bool
    stage_results: Dict[str, StageResult] = dataclasses.field(default_factory=dict)


def run_workflow(
    template: WorkflowTemplate,
    store: ProvenanceStore,
    *,
    user: str = "anonymous",
    workspace: str = "default",
    ledger: Optional[BudgetLedger] = None,
    intent: Optional[ResourceIntent] = None,
    failures: Optional[FailureSchedule] = None,
    steps_override: Optional[int] = None,
    smoke_batch: int = 4,
    smoke_seq: int = 32,
    stages: Optional[Sequence[str]] = None,
    with_eval: bool = False,
    max_workers: int = 4,
    cache: Optional["StageCache"] = None,
    serve_engine: str = "fused",
    serve_chunk: int = 1,
    serve_spec_k: int = 0,
    serve_draft: str = "",
    donate: bool = True,
    stage_retry: Optional[RestartPolicy] = None,
    resume: Optional[str] = None,
    resume_store: bool = True,
    graph: Optional[StageGraph] = None,
    check: bool = False,
    executor: Union[None, str, "Executor"] = None,
    workers: Optional[int] = None,
    device: str = "cuda",
) -> WorkflowResult:
    """Execute a workflow end-to-end on the local backend.

    Thin wrapper over the stage graph: compiles the template
    (:func:`compile_template`), executes it, and repackages the context
    into the legacy WorkflowResult.  ``scale="reduced"`` runs the
    family-faithful reduced config (CPU container); ``scale="full"`` is
    reserved for real fleets and the dry-run path.  The plan is still
    computed for the *full* config — the user sees real resource/cost
    projections either way (that is the Adviser UX: intent in,
    projection + run out).

    ``stages`` limits execution to those stages plus their ancestors
    (the CLI's ``run --stage``); checks that did not run report ok=True
    vacuously only if ValidateStage was included.

    ``cache`` attaches a cross-run :class:`StageCache`: cacheable stages
    (e.g. data prep) whose content-addressed input hash matches a prior
    run are skipped, restoring their outputs and emitting a
    ``stage_cached`` provenance event (the CLI's ``run --no-cache``
    turns this off).

    ``stage_retry`` is the graph-level restart policy: stages failing
    with a retryable exception (node loss / preemption, injected as
    :class:`~repro_torch.ft.failures.InjectedFailure` in drills) re-run up to
    ``max_restarts`` times with backoff, emitting ``stage_failed`` /
    ``stage_retry`` provenance events (the CLI's ``--stage-retries``).

    ``resume`` re-executes an earlier (crashed) run *in place*: the run
    record is loaded instead of created, and every stage whose
    content-addressed input hash matches the run's
    :class:`~repro_torch.core.stagecache.RunManifest` is skipped with its
    outputs restored, so only the incomplete suffix of the graph runs.
    An interrupted TrainStage additionally restores from its newest
    committed checkpoint.  ``resume_store=False`` skips writing the
    per-run manifest entirely (saves the per-stage output pickling on
    runs that will never be resumed; the CLI's ``--no-run-manifest``).
    Budget note: a resumed workload stage charges its full projection
    again — projections are per-attempt authorizations, not metered
    usage — and the plan stage always re-authorizes on resume while a
    ledger is attached (see ``PlanStage.resume_safe``).

    ``graph`` substitutes a pre-built StageGraph (e.g. one reloaded
    from a packed workflow spec) for the canonical compiled one;
    ``check=True`` runs the static checker
    (:func:`repro_torch.core.check.check_workflow`) as a pre-flight gate,
    raising :class:`repro_torch.core.check.CheckError` on any
    error-severity diagnostic before a run record is created or budget
    authorized (the CLI's ``run --check``).

    ``device`` is the torch device of every stage that builds a model
    (``cuda`` by default: without a GPU those stages raise; pass
    ``"cpu"`` to run on the CPU).

    ``executor`` selects the execution substrate for stage bodies (see
    :mod:`repro_torch.core.executor` and docs/executors.md): a kind string
    (``"threads"`` / ``"processes"`` / ``"workers"``, the CLI's
    ``--executor``) builds a backend owned — and shut down — by this
    call, sized by ``workers``; an :class:`Executor` *instance* is
    shared (a :class:`~repro.core.runqueue.RunQueue` fleet passes one
    executor to many runs) and the caller keeps ownership.  None keeps
    the historical inline-threaded behavior.
    """
    from repro_torch.models import resolve_device

    resolve_device(device)  # no GPU for "cuda": raise before any record
    t = template
    graph = graph if graph is not None else compile_template(
        t, with_eval=with_eval)
    if stages:
        graph = graph.subgraph(stages)

    # resolve the intent up-front so run_id/config_hash cover it (same
    # hashing the monolith did) and PlanStage plans exactly this intent
    intent = intent or t.default_intent()

    if check:
        from repro_torch.core.check import CheckError, check_workflow
        from repro_torch.core.spec import default_results, default_waivers

        report = check_workflow(
            graph, template=t, intent=intent,
            results=default_results(graph), waivers=default_waivers(t),
            steps=steps_override or t.num_steps,
        )
        if not report.ok:
            raise CheckError(report)
    if resume is not None:
        record = store.load(resume)
        if record.manifest.get("template") != t.name:
            raise ValueError(
                f"run {resume!r} was created from template "
                f"{record.manifest.get('template')!r}, not {t.name!r}"
            )
        record.log_event("resume", {"run_id": resume})
    else:
        record = store.create_run(
            template=t.name, template_version=t.version,
            config={**t.config_dict(), "intent": dataclasses.asdict(intent)},
            plan={"slice": None, "status": "pending"},
            workspace=workspace,
        )
    ctx = StageContext(
        template=t, record=record, store=store, ledger=ledger,
        user=user, workspace=workspace, cache=cache,
        resume=(RunManifest(record.dir)
                if resume_store or resume is not None else None),
        params={
            "intent": intent, "failures": failures,
            "steps_override": steps_override,
            "smoke_batch": smoke_batch, "smoke_seq": smoke_seq,
            "serve_engine": serve_engine, "serve_chunk": serve_chunk,
            "serve_spec_k": serve_spec_k, "serve_draft": serve_draft,
            "donate": donate, "device": device,
        },
    )
    owned_executor: Optional[Executor] = None
    if isinstance(executor, str):
        executor = owned_executor = make_executor(executor, workers=workers)
    elif executor is None and workers:
        executor = owned_executor = make_executor("threads", workers=workers)
    try:
        stage_results = graph.execute(ctx, max_workers=max_workers,
                                      retry=stage_retry, executor=executor)
    except (BudgetExceeded, PermissionDenied):
        # the monolith authorized before creating the run record; keep
        # denied attempts from leaving phantom runs in the store (but
        # never delete a pre-existing run we were asked to resume)
        if resume is None:
            shutil.rmtree(record.dir, ignore_errors=True)
        raise
    finally:
        if owned_executor is not None:
            owned_executor.shutdown()

    checks = ctx.get("checks", {})
    ok = all(v[0] for v in checks.values())
    record.log_event("done", {"ok": ok})
    # charge only when the main workload stage actually ran (a --stage
    # subgraph that stops at plan/data, or a resume that skipped the
    # whole workload, consumed nothing billable)
    ran_workload = any(
        s in stage_results and not stage_results[s].skipped
        for s in ("train", "serve")
    )
    if ledger is not None and ran_workload and ctx.get("projected_cost", 0.0):
        ledger.charge(workspace, user, ctx.get("projected_cost"),
                      note=record.run_id)
    return WorkflowResult(
        record=record,
        plan_choice=ctx.get("plan_choice", None),
        checks=checks,
        final_state=ctx.get("final_state", None),
        ok=ok,
        stage_results=stage_results,
    )
