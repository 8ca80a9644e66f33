"""Stage graph: the composable workflow DAG (paper §4.2 generalized).

A workflow is a directed acyclic graph of :class:`Stage` objects.  Each
stage declares the context keys it consumes (``inputs``) and produces
(``outputs``), an optional per-stage :class:`ResourceIntent` the planner
resolves independently (a cheap data-prep stage and an expensive train
stage can land on different slices), and a ``run(ctx)`` body.  The graph
executes stages in deterministic topological order, running independent
stages concurrently on a thread pool, and emits per-stage provenance
events (``stage_start`` / ``stage_end`` with timing and an outputs hash)
into the run's :class:`RunRecord`.

Resilience (see docs/architecture.md for the full event vocabulary):

  * **per-stage retry** — a stage failing with a *retryable* exception
    (default: :class:`~repro_torch.ft.failures.InjectedFailure`, standing in
    for preemption/node loss) is re-run under a
    :class:`~repro_torch.ft.failures.RestartPolicy` — per-stage ``retry``
    attribute, falling back to the graph-level policy passed to
    ``execute(retry=...)`` — with ``stage_failed`` / ``stage_retry``
    provenance events and capped exponential backoff between attempts;
  * **resume** — when ``ctx.resume`` carries a
    :class:`~repro_torch.core.stagecache.RunManifest`, every completed stage's
    outputs are persisted under its content-addressed input hash, and a
    re-execution of the same run (``repro run --resume <run_id>``) skips
    stages whose recorded hash still matches, restoring their outputs;
  * **placement** — each stage is bound to its own resolved backend
    (its entry in ``stage_plans``, its own ``intent``, or the main
    workload's ``plan_choice`` when ``placement_key == "__main__"``),
    recorded as a ``placement`` provenance event and readable from the
    stage body via ``ctx.current_placement()``.

Graphs nest: ``inner.as_stage("prep")`` wraps a whole graph as a single
stage of an outer graph; nested stage events are name-prefixed
(``prep/tokenize``).

Authoring a custom stage (expanded guide: docs/authoring-stages.md)::

    class MyStage(Stage):
        inputs = ("cfg",)
        outputs = ("thing",)
        def run(self, ctx):
            return {"thing": make_thing(ctx.get("cfg"))}

    g = StageGraph("demo")
    g.add(DataStage())
    g.add(MyStage("mine"), depends_on=("data",))
    g.execute(StageContext(template=t, record=rec))

A copy of the reference package's ``core/graph.py``.  Its cache and
resume keys also name the package (see :mod:`repro_torch.core.stagecache`)
and, for a ``device_bound`` stage, the device; :meth:`Placement.build_mesh`
raises: one card has no mesh.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.intent import ResourceIntent
from repro_torch.core.provenance import RunRecord, stable_hash
from repro_torch.core.stagecache import PACKAGE
from repro_torch.ft.failures import RestartPolicy


class GraphError(ValueError):
    """Structural problem in a stage graph (duplicate, unknown dep, cycle)."""


def _describe(v):
    """A *structural* summary of a value for hashing: arrays describe by
    dtype/shape (their repr would truncate content and force a device
    sync on multi-GB states), primitives by value, dataclasses by full
    field content, everything else by type name.  Hashes built from this
    detect wiring changes — different keys, shapes, scalar or config
    values — not bitwise array equality."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    shape = getattr(v, "shape", None)
    dtype = getattr(v, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{dtype}{tuple(shape)}"
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {"__dataclass__": type(v).__name__,
                **{f.name: _describe(getattr(v, f.name))
                   for f in dataclasses.fields(v)}}
    if isinstance(v, dict):
        return {str(k): _describe(x)
                for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))}
    if isinstance(v, (list, tuple)):
        return [_describe(x) for x in v]
    return type(v).__name__


def _describe_outputs(out: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _describe(out[k]) for k in sorted(out)}


# attrs serialized at the spec *entry* level (ports, intent, policies) or
# not serializable at all (name is the entry key) — everything else in
# vars(stage) is constructor configuration and lands in the spec's
# ``config`` block (see repro.core.spec)
_SPEC_CONFIG_EXCLUDE = frozenset({
    "name", "inputs", "outputs", "intent", "retry", "checks",
    "placement_key", "resume_payload", "cacheable", "cache_params",
    "cache_template_fields", "cache_version", "unpicklable_outputs",
})


def _spec_value(v: Any) -> Any:
    """A JSON-able rendering of one constructor knob for the declarative
    spec.  Non-JSON-able values become an explicit ``{"__opaque__":
    <type>}`` marker instead of being dropped silently: the static
    checker flags opaque knobs on cacheable stages (they hash by type
    name only — see ADV008 in repro.core.check) and ``from_spec``
    refuses to reconstruct an executable stage from them."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_spec_value(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _spec_value(v[k])
                for k in sorted(v, key=str)}
    return {"__opaque__": type(v).__name__}


class CycleError(GraphError):
    pass


class MissingInputError(KeyError):
    """A stage asked the context for a key no upstream stage produced."""


# ===========================================================================
# Placement: the backend a stage is bound to
# ===========================================================================
@dataclasses.dataclass
class Placement:
    """The resolved backend one stage runs on.

    Derived from the stage's :class:`~repro_torch.core.planner.PlanChoice` —
    slice (the catalog's backend unit), mesh shape/axes, chip count and
    price.  ``build_mesh()`` folds the planned mesh onto the locally
    visible devices (degenerate all-1s mesh on a CPU container, the real
    shape on a fleet) so stage bodies can place arrays on *their* backend
    rather than the global default.
    """

    stage: str
    slice_name: str
    mesh_shape: Tuple[int, ...]
    mesh_axes: Tuple[str, ...]
    chips: int
    price_per_hour: float
    summary: str = ""

    def as_doc(self) -> Dict[str, Any]:
        """JSON-able form for provenance events and CLI rendering."""
        return {
            "stage": self.stage,
            "slice": self.slice_name,
            "mesh_shape": list(self.mesh_shape),
            "mesh_axes": list(self.mesh_axes),
            "chips": self.chips,
            "price_per_hour": self.price_per_hour,
        }

    def render(self) -> str:
        mesh = "x".join(map(str, self.mesh_shape))
        return (f"{self.slice_name} mesh={mesh} chips={self.chips} "
                f"${self.price_per_hour:,.2f}/h")

    def build_mesh(self):
        """A device mesh for this placement: not on one card."""
        raise NotImplementedError(
            "a device mesh for a placement is not ported: ROADMAP queue 1, "
            "parallelism and elasticity")

    @classmethod
    def from_choice(cls, stage: str, choice: Any) -> "Placement":
        return cls(
            stage=stage,
            slice_name=choice.slice.name,
            mesh_shape=tuple(choice.mesh_shape),
            mesh_axes=tuple(choice.mesh_axes),
            chips=choice.slice.total_chips,
            price_per_hour=choice.slice.price_per_hour,
            summary=choice.summary,
        )


# ===========================================================================
# Stage & context
# ===========================================================================
class Stage:
    """One node of a workflow graph.

    Subclasses set ``name`` (unique within a graph), optionally declare
    ``inputs`` / ``outputs`` (context keys, used for validation and the
    CLI's DAG rendering), an ``intent`` (per-stage resource request the
    planner resolves via :func:`repro_torch.core.planner.plan_stages`) and
    ``checks`` (names into the workflow CHECKS table), and implement
    ``run(ctx) -> dict`` returning the produced outputs.
    """

    name: str = "stage"
    inputs: Tuple[str, ...] = ()
    outputs: Tuple[str, ...] = ()
    intent: Optional[ResourceIntent] = None
    checks: Tuple[str, ...] = ()
    # -- executor dispatch ----------------------------------------------
    # False pins the body to the coordinator thread regardless of the
    # run's executor backend.  _SubworkflowStage opts out: its body *is*
    # a nested scheduler, and queueing it behind the very workers it
    # needs would deadlock the fleet.
    dispatchable: bool = True
    # True promises the body is a pure function of its picklable context
    # inputs — safe to marshal into a process-pool child (repro_torch.core
    # .executor.LocalPoolExecutor).  Stages that touch live in-process
    # state (ledgers, models on the card, the run record) must stay
    # False; they run inline even under `--executor processes`.
    process_safe: bool = False
    # -- fault tolerance ------------------------------------------------
    # per-stage restart policy; None inherits the graph-level policy
    # passed to StageGraph.execute(retry=...).  Only exceptions matching
    # the policy's ``retry_on`` classes are retried.
    retry: Optional[RestartPolicy] = None
    # -- placement ------------------------------------------------------
    # how the scheduler binds this stage to a backend: "__main__" uses
    # the workflow's main plan_choice; None falls back to the stage's
    # entry in stage_plans, then to its own ``intent``.
    placement_key: Optional[str] = None
    # -- resume ---------------------------------------------------------
    # False = record this stage in the run manifest hash-only (no output
    # pickle): on resume it re-runs instead of restoring.  Set it on
    # stages with their own durable recovery path — TrainStage opts out
    # because its state is already committed by the checkpointer, and a
    # re-run restores the newest checkpoint without replaying steps.
    resume_payload: bool = True
    # -- cross-run caching (see repro_torch.core.stagecache) ------------------
    # Only stages whose outputs are a pure function of the hashed inputs
    # should opt in; side-effectful stages (budget authorization, metric
    # logging, checkpoint writes) must stay uncacheable.
    cacheable: bool = False
    # ctx.params keys folded into the input hash (the knobs this stage
    # actually reads — keeps unrelated param changes from invalidating).
    # Also folded into the *resume* key, so uncacheable stages should
    # list their knobs too: it keeps `run --resume` from skipping a
    # stage whose effective configuration changed.
    cache_params: Tuple[str, ...] = ()
    # the port: a stage that builds its model on ``ctx.params["device"]``
    # folds the device into its input (cache and resume) hash, beside
    # ``cache_params``, which stay the reference's in a workflow spec
    device_bound: bool = False
    # template fields folded into the input hash; None = whole template
    cache_template_fields: Optional[Tuple[str, ...]] = None
    # code-version salt: bump when the stage's implementation (or code it
    # calls into) changes output semantics, so stale entries can't hit
    cache_version: str = "1"
    # declared output keys whose values cannot be pickled (live handles,
    # compiled callables).  The run manifest / stage cache skip such
    # payloads at runtime; declaring them lets the static checker warn
    # *before* the run that resume/cache persistence will degrade
    # (ADV009 in repro.core.check).
    unpicklable_outputs: Tuple[str, ...] = ()

    def __init__(self, name: Optional[str] = None):
        if name is not None:
            self.name = name

    def run(self, ctx: "StageContext") -> Dict[str, Any]:
        raise NotImplementedError

    def resume_safe(self, ctx: "StageContext") -> bool:
        """May a resumed run skip this stage when its recorded input hash
        still matches?  Override to return False when skipping would
        bypass a side effect the run depends on — e.g. PlanStage refuses
        while a budget ledger is attached, so resume cannot dodge the
        authorization gate."""
        return True

    def signature(self) -> Dict[str, Any]:
        """JSON-able identity of this stage for the cache key: type,
        name, declared I/O, and its primitive constructor config."""
        cfg = {k: v for k, v in sorted(vars(self).items())
               if not k.startswith("_")
               and isinstance(v, (bool, int, float, str, tuple, list,
                                  dict, type(None)))}
        return {"type": type(self).__name__, "name": self.name,
                "version": self.cache_version,
                "inputs": list(self.inputs), "outputs": list(self.outputs),
                "config": _describe(cfg)}

    # -- declarative spec (see repro.core.spec) -------------------------
    def spec_config(self) -> Dict[str, Any]:
        """This stage's constructor configuration as a JSON-able dict —
        the ``config`` block of its spec entry.  Keys already serialized
        at the entry level (ports, intent, retry, cache knobs) are
        excluded; values that can't be rendered to JSON become
        ``{"__opaque__": <type>}`` markers (see :func:`_spec_value`).
        Override when ``vars(self)`` isn't the right inverse of
        ``__init__`` (e.g. ExploreStage's nested spec dataclass)."""
        return {k: _spec_value(v) for k, v in sorted(vars(self).items())
                if not k.startswith("_") and k not in _SPEC_CONFIG_EXCLUDE}

    @classmethod
    def from_spec_config(cls, name: str, config: Dict[str, Any]) -> "Stage":
        """Rebuild a stage from its spec entry's ``config`` block.  The
        default assumes ``config`` keys are constructor kwargs — true
        for every builtin stage; override alongside ``spec_config``."""
        return cls(name, **config)

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class FnStage(Stage):
    """Wrap a plain callable ``fn(ctx) -> dict`` as a stage."""

    def __init__(self, name: str, fn: Callable[["StageContext"], Optional[Dict]],
                 inputs: Sequence[str] = (), outputs: Sequence[str] = (),
                 intent: Optional[ResourceIntent] = None,
                 retry: Optional[RestartPolicy] = None):
        super().__init__(name)
        self.fn = fn
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)
        self.intent = intent
        self.retry = retry

    def run(self, ctx: "StageContext") -> Dict[str, Any]:
        return self.fn(ctx) or {}


@dataclasses.dataclass
class StageContext:
    """Shared state threaded through a graph execution.

    ``outputs`` is the blackboard stages read/write through ``get``/``put``
    (lock-guarded — stages may run concurrently); ``params`` carries
    run-scoped knobs (steps_override, smoke_batch, failures, intent);
    ``cache`` is an optional :class:`repro_torch.core.stagecache.StageCache`
    the scheduler consults to skip cacheable stages across runs;
    ``resume`` is an optional
    :class:`repro_torch.core.stagecache.RunManifest` recording completed
    stages of *this* run so an interrupted execution can be resumed.
    """

    template: Any = None
    record: Optional[RunRecord] = None
    store: Any = None
    ledger: Any = None
    user: str = "anonymous"
    workspace: str = "default"
    cache: Any = None
    resume: Any = None
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    outputs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self._lock = threading.Lock()
        self._placements: Dict[str, Placement] = {}
        self._tls = threading.local()

    def get(self, key: str, default: Any = dataclasses.MISSING) -> Any:
        with self._lock:
            if key in self.outputs:
                return self.outputs[key]
        if default is not dataclasses.MISSING:
            return default
        raise MissingInputError(
            f"context key {key!r} not produced by any completed stage "
            f"(have: {sorted(self.outputs)})"
        )

    def put(self, **kw: Any) -> None:
        with self._lock:
            self.outputs.update(kw)

    # -- placement bindings (written by the scheduler) ------------------
    def bind_placement(self, name: str, placement: Placement) -> None:
        with self._lock:
            self._placements[name] = placement

    def placement(self, name: str) -> Optional[Placement]:
        """The backend the scheduler bound stage ``name`` to, if any.
        Names are as they appear in provenance — nested stages are
        prefixed (``prep/train``)."""
        with self._lock:
            return self._placements.get(name)

    def placements(self) -> Dict[str, Placement]:
        with self._lock:
            return dict(self._placements)

    def current_placement(self) -> Optional[Placement]:
        """The placement of the stage executing on *this* thread — what a
        stage body should read (collision-free even when nested
        subgraphs reuse stage names; the scheduler sets it around every
        ``run()`` call)."""
        return getattr(self._tls, "placement", None)


@dataclasses.dataclass
class StageResult:
    name: str
    ok: bool
    started_at: float
    duration_s: float
    output_keys: Tuple[str, ...] = ()
    error: Optional[str] = None
    cached: bool = False                 # outputs restored from StageCache
    resumed: bool = False                # outputs restored from RunManifest
    outputs_hash: Optional[str] = None   # structural hash of the outputs
    attempts: int = 1                    # 1 = first try succeeded
    placement: Optional[str] = None      # bound backend (render string)

    @property
    def skipped(self) -> bool:
        """True when the stage body never ran (cache or resume skip)."""
        return self.cached or self.resumed


# ===========================================================================
# The graph
# ===========================================================================
class StageGraph:
    """DAG of stages with deterministic, concurrency-aware scheduling."""

    def __init__(self, name: str = "workflow"):
        self.name = name
        self._stages: Dict[str, Stage] = {}
        self._deps: Dict[str, Tuple[str, ...]] = {}

    # -- construction ---------------------------------------------------
    def add(self, stage: Stage, depends_on: Sequence[str] = ()) -> Stage:
        if stage.name in self._stages:
            raise GraphError(f"stage {stage.name!r} already in graph {self.name!r}")
        self._stages[stage.name] = stage
        self._deps[stage.name] = tuple(dict.fromkeys(depends_on))
        return stage

    def add_fn(self, name: str, fn: Callable, depends_on: Sequence[str] = (),
               **kw) -> Stage:
        return self.add(FnStage(name, fn, **kw), depends_on=depends_on)

    @property
    def stages(self) -> Dict[str, Stage]:
        return dict(self._stages)

    def deps(self, name: str) -> Tuple[str, ...]:
        return self._deps[name]

    # -- validation -----------------------------------------------------
    def validate(self) -> None:
        for name, deps in self._deps.items():
            for d in deps:
                if d not in self._stages:
                    raise GraphError(
                        f"stage {name!r} depends on unknown stage {d!r}"
                    )
                if d == name:
                    raise CycleError(f"stage {name!r} depends on itself")
        producers: Dict[str, str] = {}
        for name, stage in self._stages.items():
            for key in stage.outputs:
                first = producers.setdefault(key, name)
                if first != name:
                    raise GraphError(
                        f"stages {first!r} and {name!r} both declare output "
                        f"key {key!r}; the second to finish would silently "
                        f"overwrite the first — rename one output (e.g. via "
                        f"state_key=) or drop the duplicate stage"
                    )
        self.topo_order()  # raises CycleError on cycles

    def _successors(self) -> Dict[str, List[str]]:
        """Successor adjacency (``dep -> [dependents...]``), dependents in
        insertion order — built once per traversal instead of rescanning
        every stage per completed node."""
        succ: Dict[str, List[str]] = {n: [] for n in self._stages}
        for m, deps in self._deps.items():
            for d in deps:
                if d in succ:
                    succ[d].append(m)
        return succ

    def topo_order(self) -> List[str]:
        """Kahn's algorithm; ready stages drain in insertion order, so the
        result is deterministic for a given construction sequence."""
        indeg = {n: 0 for n in self._stages}
        succ = self._successors()
        for n, deps in self._deps.items():
            for d in deps:
                if d in indeg:
                    indeg[n] += 1
        order: List[str] = []
        ready = deque(n for n in self._stages if indeg[n] == 0)
        while ready:
            n = ready.popleft()
            order.append(n)
            for m in succ[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    ready.append(m)
        if len(order) != len(self._stages):
            stuck = sorted(set(self._stages) - set(order))
            raise CycleError(f"cycle among stages {stuck} in graph {self.name!r}")
        return order

    # -- composition ----------------------------------------------------
    def subgraph(self, targets: Sequence[str]) -> "StageGraph":
        """The induced graph of ``targets`` plus all their ancestors —
        what `cli run --stage X` executes."""
        for t in targets:
            if t not in self._stages:
                raise GraphError(
                    f"unknown stage {t!r}; graph has {sorted(self._stages)}"
                )
        keep = set()
        frontier = list(targets)
        while frontier:
            n = frontier.pop()
            if n in keep:
                continue
            keep.add(n)
            frontier.extend(self._deps[n])
        g = StageGraph(f"{self.name}[{','.join(targets)}]")
        for n in self._stages:  # preserve insertion order
            if n in keep:
                g.add(self._stages[n],
                      depends_on=tuple(d for d in self._deps[n] if d in keep))
        return g

    def as_stage(self, name: Optional[str] = None,
                 max_workers: int = 4,
                 retry: Optional[RestartPolicy] = None) -> Stage:
        """Wrap this whole graph as one stage of an outer graph
        (recursive subworkflow nesting).  ``retry`` becomes the inner
        graph's graph-level restart policy."""
        return _SubworkflowStage(name or self.name, self, max_workers, retry)

    # -- rendering ------------------------------------------------------
    def render(self, placements: Optional[Dict[str, str]] = None) -> str:
        """ASCII DAG in topological order (the CLI `graph` subcommand).

        ``placements`` maps stage names to resolved-backend strings
        (the CLI's ``graph --placements``); stages without an entry
        render as running on the local/default backend."""
        lines = [f"graph {self.name} ({len(self._stages)} stages)"]
        for n in self.topo_order():
            s = self._stages[n]
            deps = ", ".join(self._deps[n]) or "-"
            extra = ""
            if s.intent is not None:
                extra = f"  intent(goal={s.intent.goal})"
            io = ""
            if s.inputs or s.outputs:
                io = f"  [{','.join(s.inputs)}] -> [{','.join(s.outputs)}]"
            lines.append(f"  {n:<16s} <- {deps:<24s}{io}{extra}")
            if placements is not None:
                lines.append(f"  {'':<16s}    @ {placements.get(n, 'local')}")
        return "\n".join(lines)

    # -- execution ------------------------------------------------------
    def execute(self, ctx: StageContext, *, max_workers: int = 4,
                prefix: str = "",
                retry: Optional[RestartPolicy] = None,
                executor=None,
                ) -> Dict[str, StageResult]:
        """Run every stage, respecting edges, independent stages in
        parallel.

        ``retry`` is the graph-level restart policy: a stage failing with
        an exception the policy deems retryable is re-run (after backoff)
        up to ``max_restarts`` times, with ``stage_failed`` /
        ``stage_retry`` provenance events per attempt; a stage's own
        ``retry`` attribute overrides it.  Non-retryable stage exceptions
        propagate unchanged (after an ``ok=False`` stage_end event) so
        callers see e.g. BudgetExceeded exactly as the monolithic runner
        raised it.

        ``executor`` selects where stage *bodies* run (see
        :mod:`repro_torch.core.executor`): None keeps them inline on the
        coordinator threads (historical behavior, identical to
        ``ThreadedExecutor``); a backend instance receives every
        ``dispatchable`` stage body via ``executor.submit(...)`` while
        the scheduling, retry, cache and provenance state machine stays
        on the coordinator.  The coordinator pool widens to the
        executor's ``schedule_width`` so a wide backend is never starved
        by a narrow coordinator."""
        self.validate()
        width = max(1, max_workers)
        if executor is not None:
            width = max(width, int(getattr(executor, "schedule_width", 0) or 0))
        indeg = {n: sum(1 for d in self._deps[n]) for n in self._stages}
        succ = self._successors()
        ready = [n for n in self.topo_order() if indeg[n] == 0]
        results: Dict[str, StageResult] = {}
        pending: Dict[Any, str] = {}

        def _launch(pool, name):
            stage = self._stages[name]
            placement = self._resolve_placement(name, ctx)
            if placement is not None:
                ctx.bind_placement(prefix + name, placement)
                if ctx.record is not None:
                    ctx.record.log_event("placement", {
                        **placement.as_doc(), "stage": prefix + name,
                    })
            if ctx.record is not None:
                ctx.record.log_event("stage_start", {"stage": prefix + name})
            input_hash = self._input_hash(name, ctx, results)
            fut = pool.submit(self._run_stage, stage, ctx, prefix,
                              input_hash, retry, placement, executor)
            pending[fut] = name

        failure: Optional[BaseException] = None
        with ThreadPoolExecutor(max_workers=width) as pool:
            for n in ready:
                _launch(pool, n)
            while pending:
                done, _ = wait(list(pending), return_when=FIRST_COMPLETED)
                for fut in done:
                    name = pending.pop(fut)
                    res, err = fut.result()
                    results[name] = res
                    if err is not None:
                        failure = failure or err
                        continue
                    for m in succ[name]:
                        indeg[m] -= 1
                        if indeg[m] == 0 and failure is None:
                            _launch(pool, m)
        if failure is not None:
            raise failure
        return results

    # -- placement ------------------------------------------------------
    def _resolve_placement(self, name: str,
                           ctx: StageContext) -> Optional[Placement]:
        """The backend stage ``name`` should run on, best-effort at launch
        time: the main workload's plan_choice (``placement_key ==
        "__main__"``), the stage's entry in an upstream PlanStage's
        ``stage_plans``, or a fresh planner pass over the stage's own
        ``intent``.  None when nothing is resolvable yet (e.g. a stage
        launched concurrently with the plan stage)."""
        stage = self._stages[name]
        choice = None
        if stage.placement_key == "__main__":
            choice = ctx.get("plan_choice", None)
        if choice is None:
            plans = ctx.get("stage_plans", None) or {}
            choice = plans.get(name)
        if choice is None and stage.intent is not None:
            from repro_torch.core.planner import plan_stages

            try:
                choice = plan_stages({name: stage.intent}).get(name)
            except Exception:
                choice = None  # placement is advisory; never block launch
        if choice is None:
            return None
        return Placement.from_choice(name, choice)

    # -- content addressing ---------------------------------------------
    def _input_hash(self, name: str, ctx: StageContext,
                    results: Dict[str, StageResult]) -> Optional[str]:
        """The stage's content-addressed input key: stage signature +
        declared input values + upstream output hashes + the template
        fields and params the stage reads (see repro_torch.core.stagecache).
        Used both as the cross-run cache key (cacheable stages) and the
        resume key (any stage, when a RunManifest is attached).  None
        when neither consumer is attached or an input is missing."""
        stage = self._stages[name]
        want_cache = stage.cacheable and ctx.cache is not None
        if not want_cache and ctx.resume is None:
            return None
        try:
            inputs = {k: _describe(ctx.get(k)) for k in stage.inputs}
        except MissingInputError:
            return None
        template = None
        if ctx.template is not None:
            fields = stage.cache_template_fields
            if fields is None:
                template = _describe(ctx.template)
            else:
                template = {f: _describe(getattr(ctx.template, f, None))
                            for f in fields}
        key = {
            "package": PACKAGE,
            "stage": stage.signature(),
            "inputs": inputs,
            "upstream": {d: results[d].outputs_hash
                         for d in sorted(self._deps[name]) if d in results},
            "template": template,
            "params": {k: _describe(ctx.params.get(k))
                       for k in stage.cache_params},
        }
        if stage.device_bound:
            key["device"] = _describe(ctx.params.get("device"))
        return stable_hash(key)

    # -- the per-stage state machine ------------------------------------
    def _run_stage(self, stage: Stage, ctx: StageContext, prefix: str,
                   input_hash: Optional[str] = None,
                   graph_retry: Optional[RestartPolicy] = None,
                   placement: Optional[Placement] = None,
                   executor=None,
                   ) -> Tuple[StageResult, Optional[BaseException]]:
        t0 = time.perf_counter()
        started = time.time()
        full_name = prefix + stage.name
        place_str = placement.render() if placement is not None else None
        # expose the binding, the full provenance prefix and the run's
        # executor to the stage body thread-locally: unlike name-keyed
        # lookups this stays correct when nested subgraphs reuse stage
        # names, and lets a subworkflow stage extend the prefix (and
        # reuse the executor) at any nesting depth
        ctx._tls.placement = placement
        ctx._tls.prefix = prefix
        ctx._tls.executor = executor

        # 1) resume: this very run already completed the stage ----------
        if input_hash is not None and ctx.resume is not None \
                and stage.resume_safe(ctx):
            entry = ctx.resume.lookup(full_name, input_hash)
            if entry is not None:
                hit = ctx.resume.load_outputs(full_name, input_hash)
                if hit is not None and all(k in hit for k in stage.outputs):
                    ctx.put(**hit)
                    dt = time.perf_counter() - t0
                    ohash = entry.get("outputs_hash") or stable_hash(
                        _describe_outputs(hit))
                    if ctx.record is not None:
                        ctx.record.log_event("stage_cached", {
                            "stage": full_name, "input_hash": input_hash,
                            "outputs": sorted(hit), "resume": True,
                        })
                        ctx.record.log_event("stage_end", {
                            "stage": full_name, "ok": True,
                            "duration_s": dt, "cached": True, "resumed": True,
                            "outputs": sorted(hit), "outputs_hash": ohash,
                        })
                    return StageResult(stage.name, True, started, dt,
                                       output_keys=tuple(sorted(hit)),
                                       cached=True, resumed=True,
                                       outputs_hash=ohash,
                                       placement=place_str), None

        # 2) cross-run cache hit ----------------------------------------
        use_cache = (input_hash is not None and stage.cacheable
                     and ctx.cache is not None)
        if use_cache:
            hit = ctx.cache.get(input_hash)
            if hit is not None and all(k in hit for k in stage.outputs):
                ctx.put(**hit)
                dt = time.perf_counter() - t0
                ohash = stable_hash(_describe_outputs(hit))
                if ctx.record is not None:
                    ctx.record.log_event("stage_cached", {
                        "stage": full_name,
                        "input_hash": input_hash,
                        "outputs": sorted(hit),
                    })
                    ctx.record.log_event("stage_end", {
                        "stage": full_name, "ok": True,
                        "duration_s": dt, "cached": True,
                        "outputs": sorted(hit), "outputs_hash": ohash,
                    })
                if ctx.resume is not None:
                    # hash-only entry: a resume misses here, falls through
                    # to the cross-run cache and hits there — no need to
                    # pickle the payload a second time into the run dir
                    ctx.resume.record(full_name, input_hash, ohash, hit, dt,
                                      store_payload=False)
                return StageResult(stage.name, True, started, dt,
                                   output_keys=tuple(sorted(hit)),
                                   cached=True, outputs_hash=ohash,
                                   placement=place_str), None

        # 3) run, retrying under the restart policy ---------------------
        policy = stage.retry if stage.retry is not None else graph_retry
        failures = ctx.params.get("failures")
        attempt = 0
        while True:
            t_attempt = time.perf_counter()
            try:
                if failures is not None:
                    failures.check_stage(full_name)
                if executor is not None and stage.dispatchable:
                    out = executor.submit(
                        stage, ctx, name=full_name,
                        placement=placement, prefix=prefix).result()
                    out = out or {}
                else:
                    out = stage.run(ctx) or {}
                break
            except BaseException as e:  # noqa: BLE001 — re-raised below
                dt_attempt = time.perf_counter() - t_attempt
                retryable = policy is not None and policy.retryable(e)
                will_retry = retryable and attempt < policy.max_restarts
                if ctx.record is not None:
                    ctx.record.log_event("stage_failed", {
                        "stage": full_name, "attempt": attempt + 1,
                        "error": repr(e), "retryable": retryable,
                        "duration_s": dt_attempt,
                    })
                if not will_retry:
                    dt = time.perf_counter() - t0
                    res = StageResult(stage.name, False, started, dt,
                                      error=repr(e), attempts=attempt + 1,
                                      placement=place_str)
                    if ctx.record is not None:
                        ctx.record.log_event("stage_end", {
                            "stage": full_name, "ok": False,
                            "duration_s": dt, "error": repr(e),
                            "attempts": attempt + 1,
                        })
                    return res, e
                delay = policy.delay(attempt)
                if ctx.record is not None:
                    ctx.record.log_event("stage_retry", {
                        "stage": full_name, "attempt": attempt + 2,
                        "delay_s": delay,
                    })
                if delay > 0:
                    time.sleep(delay)
                attempt += 1

        # 4) success: validate declared outputs, publish, persist -------
        dt = time.perf_counter() - t0
        missing = [k for k in stage.outputs if k not in out]
        if missing:
            e = GraphError(
                f"stage {stage.name!r} declared outputs {missing} but did "
                f"not produce them (got {sorted(out)})"
            )
            if ctx.record is not None:
                ctx.record.log_event("stage_end", {
                    "stage": full_name, "ok": False,
                    "duration_s": dt, "error": repr(e),
                })
            return StageResult(stage.name, False, started, dt,
                               error=repr(e), attempts=attempt + 1,
                               placement=place_str), e
        ctx.put(**out)
        ohash = stable_hash(_describe_outputs(out))
        res = StageResult(stage.name, True, started, dt,
                          output_keys=tuple(sorted(out)),
                          outputs_hash=ohash, attempts=attempt + 1,
                          placement=place_str)
        if use_cache:
            ctx.cache.put(input_hash, full_name, out, dt)
        if input_hash is not None and ctx.resume is not None:
            # a cacheable stage's payload just went into the cross-run
            # cache — the manifest entry stays hash-only and resume
            # falls through to the cache, same as the hit path
            ctx.resume.record(full_name, input_hash, ohash, out, dt,
                              store_payload=stage.resume_payload
                              and not use_cache)
        if ctx.record is not None:
            end = {
                "stage": full_name, "ok": True, "duration_s": dt,
                "outputs": sorted(out),
                "outputs_hash": ohash,
            }
            if attempt:
                end["attempts"] = attempt + 1
            ctx.record.log_event("stage_end", end)
        return res, None


class _SubworkflowStage(Stage):
    """A nested StageGraph executing as a single stage of an outer graph.

    The inner graph shares the outer context (outputs blackboard, record,
    params); its stage events are prefixed ``<name>/``.
    """

    # the body is a nested scheduler — it must stay on the coordinator
    # thread (dispatching it into a bounded worker fleet could deadlock:
    # the subworkflow would hold a worker while waiting for workers)
    dispatchable = False

    def __init__(self, name: str, graph: StageGraph, max_workers: int = 4,
                 retry: Optional[RestartPolicy] = None):
        super().__init__(name)
        self.graph = graph
        self.max_workers = max_workers
        self.inner_retry = retry
        order = graph.topo_order()
        self.inputs = tuple(dict.fromkeys(
            k for n in order for k in graph.stages[n].inputs))
        self.outputs = tuple(dict.fromkeys(
            k for n in order for k in graph.stages[n].outputs))

    def spec_config(self) -> Dict[str, Any]:
        # the inner graph serializes as a nested "graph" block in the
        # spec entry (see repro.core.spec), not as opaque config
        return {"max_workers": self.max_workers}

    def run(self, ctx: StageContext) -> Dict[str, Any]:
        # extend the prefix we were launched under, so doubly-nested
        # stages register as 'outer/inner/stage' in provenance, failure
        # schedules, placements and the resume manifest
        outer = getattr(ctx._tls, "prefix", "")
        self.graph.execute(ctx, max_workers=self.max_workers,
                           prefix=outer + self.name + "/",
                           retry=self.inner_retry,
                           executor=getattr(ctx._tls, "executor", None))
        return {k: ctx.get(k) for k in self.outputs if k in ctx.outputs}
