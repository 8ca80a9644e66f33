"""Static workflow checker: diagnose a workflow *before* any cloud
resource is provisioned (cwltool's pre-execution ``checker.py``, grown
to cover placement, planning and cache/resume semantics).

Every finding carries a stable diagnostic code, an error/warning
severity, and the stage it anchors to; specs waive individual codes
per stage with a recorded reason (``waivers`` in
:mod:`repro_torch.core.spec`).  The catalog:

========  ========  ====================================================
code      severity  meaning
========  ========  ====================================================
ADV001    error     input key consumed but produced by no stage (and not
                    declared external)
ADV002    warning   output key produced but never consumed and not a
                    declared result
ADV003    error     two stages produce the same output key (silent
                    overwrite)
ADV004    error     a consumer's producer is not among its ancestors —
                    a scheduling race, or a ``run --stage`` subgraph
                    that excludes the producer
ADV005    warning   producer and consumer bound to different slices with
                    no movement stage between them (fix:
                    :func:`insert_movement_stages`)
ADV006    error     a ResourceIntent has zero feasible plan candidates
ADV007    error     the cheapest plan's projected cost exceeds the
                    attached budget envelope
ADV008    warning   cacheable stage with constructor knobs the cache
                    signature can't see (opaque, hashed by type name)
ADV009    warning   resume/cache persistence requested for declared
                    unpicklable outputs (will degrade to re-run)
ADV010    error     spec document fails schema validation / cannot be
                    reconstructed
ADV011    error     graph structure broken (unknown dep, self-dep,
                    cycle, unknown --stage target)
========  ========  ====================================================

Planner-backed checks (ADV005–ADV007) reuse the memoized vectorized
planner (:func:`repro_torch.core.planner.plan`), so checking a workflow stays
sub-second; they are advisory — a planner failure skips them rather
than blocking the check.

Entry points: :func:`check_workflow` (a built graph),
:func:`check_spec` (a spec/package document — what ``cli check`` runs),
:func:`insert_movement_stages` (the ADV005 lowering), and
:class:`CheckError` (the ``run --check`` pre-flight gate).

A copy of the reference package's ``core/check.py`` over the port's
spec, graph and planner: the same diagnostics for the same document.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.graph import CycleError, GraphError, Stage, StageGraph
from repro_torch.core.intent import ResourceIntent
from repro_torch.core.spec import (
    DeclaredStage,
    SpecError,
    from_spec,
    opaque_paths,
    unpack_package,
    validate_spec,
)
from repro_torch.core.stages import MoveStage, PlanStage

CODES: Dict[str, Tuple[str, str]] = {
    "ADV001": ("error", "input produced by no stage"),
    "ADV002": ("warning", "output never consumed"),
    "ADV003": ("error", "duplicate producers for one key"),
    "ADV004": ("error", "producer is not an ancestor of its consumer"),
    "ADV005": ("warning", "cross-slice handoff without a movement stage"),
    "ADV006": ("error", "intent has no feasible plan"),
    "ADV007": ("error", "cheapest plan exceeds the budget envelope"),
    "ADV008": ("warning", "cache signature blind to opaque config"),
    "ADV009": ("warning", "unpicklable outputs under resume/cache"),
    "ADV010": ("error", "spec fails schema validation"),
    "ADV011": ("error", "broken graph structure"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    code: str
    severity: str  # error | warning
    stage: Optional[str]
    message: str
    key: Optional[str] = None  # the context key involved, when one is

    def render(self) -> str:
        where = f" [{self.stage}]" if self.stage else ""
        return f"{self.code} {self.severity}{where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class CheckReport:
    """Outcome of one static check: active diagnostics plus the ones
    waivers suppressed (kept for the audit trail)."""

    name: str
    diagnostics: Tuple[Diagnostic, ...] = ()
    waived: Tuple[Diagnostic, ...] = ()

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "error")

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics
                     if d.severity == "warning")

    @property
    def ok(self) -> bool:
        """No error-severity diagnostics (warnings don't fail a check)."""
        return not self.errors

    def render(self) -> str:
        lines = [f"check {self.name}: "
                 f"{len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s), "
                 f"{len(self.waived)} waived"]
        lines += [f"  {d.render()}" for d in self.diagnostics]
        lines += [f"  waived {d.render()}" for d in self.waived]
        return "\n".join(lines)

    def as_doc(self) -> Dict[str, Any]:
        return {
            "name": self.name, "ok": self.ok,
            "diagnostics": [dataclasses.asdict(d)
                            for d in self.diagnostics],
            "waived": [dataclasses.asdict(d) for d in self.waived],
        }


class CheckError(RuntimeError):
    """Raised by the ``run --check`` pre-flight gate when the checker
    finds error-severity diagnostics."""

    def __init__(self, report: CheckReport):
        self.report = report
        super().__init__(report.render())


# ===========================================================================
# Graph analysis helpers
# ===========================================================================
def _producers(graph: StageGraph) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for name, s in graph.stages.items():
        for k in s.outputs:
            out.setdefault(k, []).append(name)
    return out


def _ancestors(graph: StageGraph) -> Dict[str, Set[str]]:
    """Transitive ancestor sets, accumulated along the topo order."""
    anc: Dict[str, Set[str]] = {}
    for n in graph.topo_order():
        a: Set[str] = set()
        for d in graph.deps(n):
            a.add(d)
            a |= anc.get(d, set())
        anc[n] = a
    return anc


def _structure_diags(graph: StageGraph) -> List[Diagnostic]:
    """ADV011: the structural problems ``StageGraph.validate`` raises
    on, surfaced as diagnostics so one check reports them all."""
    diags: List[Diagnostic] = []
    for name, stage in graph.stages.items():
        for d in graph.deps(name):
            if d == name:
                diags.append(Diagnostic(
                    "ADV011", "error", name,
                    f"stage {name!r} depends on itself"))
            elif d not in graph.stages:
                diags.append(Diagnostic(
                    "ADV011", "error", name,
                    f"stage {name!r} depends on unknown stage {d!r}"))
    if not diags:
        try:
            graph.topo_order()
        except CycleError as e:
            diags.append(Diagnostic("ADV011", "error", None, str(e)))
    return diags


def _slice_map(graph: StageGraph, template: Any,
               intent: Optional[ResourceIntent],
               ) -> Dict[str, Optional[str]]:
    """Stage -> resolved slice name (None = coordinator/local), via the
    same resolution the scheduler applies.  Empty on planner failure —
    placement checks are advisory."""
    from repro_torch.core.workflow import resolve_placement_map

    try:
        placements = resolve_placement_map(graph, template=template,
                                           intent=intent)
    except Exception:
        return {}
    return {name: (p.slice_name if p is not None else None)
            for name, p in placements.items()}


def _is_move(stage: Stage) -> bool:
    if isinstance(stage, MoveStage):
        return True
    return (isinstance(stage, DeclaredStage)
            and stage.declared_type == "move")


def _move_key(stage: Stage) -> Optional[str]:
    if isinstance(stage, MoveStage):
        return stage.key
    return stage.declared_config.get("key") \
        if isinstance(stage, DeclaredStage) else None


# ===========================================================================
# The checker
# ===========================================================================
def check_workflow(
    graph: StageGraph,
    *,
    template: Any = None,
    intent: Optional[ResourceIntent] = None,
    targets: Optional[Sequence[str]] = None,
    results: Sequence[str] = (),
    external_inputs: Sequence[str] = (),
    waivers: Sequence[Dict[str, Any]] = (),
    budget_usd: Optional[float] = None,
    steps: Optional[int] = None,
    slices: Optional[Dict[str, Optional[str]]] = None,
) -> CheckReport:
    """Run every static check over a built graph.

    ``targets`` restricts the check to the induced ``run --stage``
    subgraph (ADV001/ADV004 then report producers the restriction cut
    away); ``results`` / ``external_inputs`` / ``waivers`` /
    ``budget_usd`` mirror the spec fields (:func:`check_spec` threads
    them through); ``steps`` scales the ADV007 cost projection
    (defaults to the template's ``num_steps``); ``slices`` overrides
    the resolved stage→slice placement map used by ADV005 (defaults to
    :func:`repro_torch.core.workflow.resolve_placement_map`).
    """
    full_producers = _producers(graph)
    if targets is not None:
        missing = sorted(set(targets) - set(graph.stages))
        if missing:
            diags = [Diagnostic(
                "ADV011", "error", None,
                f"--stage target(s) {missing} not in graph "
                f"{graph.name!r} (has {sorted(graph.stages)})")]
            return _partition(graph.name, diags, waivers)
        graph = graph.subgraph(targets)

    diags: List[Diagnostic] = list(_structure_diags(graph))
    structure_broken = bool(diags)

    producers = _producers(graph)
    consumers: Dict[str, List[str]] = {}
    for name, s in graph.stages.items():
        for k in s.inputs:
            consumers.setdefault(k, []).append(name)
    external = set(external_inputs)
    results_set = set(results)

    # -- ADV003: duplicate producers ------------------------------------
    for key, owners in producers.items():
        if len(owners) > 1:
            diags.append(Diagnostic(
                "ADV003", "error", owners[1], key=key,
                message=f"stages {owners[0]!r} and {owners[1]!r} both "
                        f"produce {key!r}; the second to finish silently "
                        f"overwrites the first — rename one output"))

    # -- ADV001: consumed but never produced ----------------------------
    for key, users in consumers.items():
        if key in producers or key in external:
            continue
        cut = full_producers.get(key)
        hint = (f" (producer {cut[0]!r} exists in the full graph but is "
                f"excluded by --stage; include it or seed the key)"
                if cut else
                " (declare it in external_inputs if the runner seeds it)")
        diags.append(Diagnostic(
            "ADV001", "error", users[0], key=key,
            message=f"stage {users[0]!r} consumes {key!r} but no stage "
                    f"produces it{hint}"))

    # -- ADV002: produced but never consumed ----------------------------
    for key, owners in producers.items():
        if key in consumers or key in results_set:
            continue
        diags.append(Diagnostic(
            "ADV002", "warning", owners[0], key=key,
            message=f"output {key!r} of stage {owners[0]!r} is never "
                    f"consumed and is not a declared result — dead "
                    f"dataflow, or a missing entry in 'results'"))

    # -- order-dependent checks need an intact structure ----------------
    if not structure_broken:
        anc = _ancestors(graph)

        # ADV004: producer not ordered before its consumer
        for name, s in graph.stages.items():
            for k in s.inputs:
                owners = producers.get(k)
                if not owners or k in external:
                    continue
                if not any(p in anc[name] for p in owners):
                    diags.append(Diagnostic(
                        "ADV004", "error", name, key=k,
                        message=f"stage {name!r} consumes {k!r} from "
                                f"{owners[0]!r}, which is not among its "
                                f"ancestors — the scheduler may run them "
                                f"concurrently; add a depends_on edge"))

        # ADV005: cross-slice handoff without a movement stage
        if slices is None:
            slices = _slice_map(graph, template, intent)
        moves = [(m, _move_key(graph.stages[m]))
                 for m in graph.stages if _is_move(graph.stages[m])]
        for name, s in graph.stages.items():
            dst = slices.get(name)
            if dst is None:
                continue
            for k in s.inputs:
                for p in producers.get(k, ()):
                    src = slices.get(p)
                    if src is None or src == dst or p not in anc[name]:
                        continue
                    covered = any(
                        key == k and p in anc[m] and m in anc[name]
                        for m, key in moves)
                    if not covered:
                        diags.append(Diagnostic(
                            "ADV005", "warning", name, key=k,
                            message=f"{k!r} is produced on {src} "
                                    f"({p!r}) and consumed on {dst} "
                                    f"({name!r}) with no movement stage "
                                    f"between them — apply "
                                    f"insert_movement_stages or add a "
                                    f"MoveStage"))

    # -- ADV006/ADV007: planner dry-run ---------------------------------
    diags.extend(_planner_diags(graph, template, intent, budget_usd,
                                steps))

    # -- ADV008/ADV009: cache & resume safety ---------------------------
    for name, s in graph.stages.items():
        if s.cacheable:
            opaque = opaque_paths(s.spec_config())
            if opaque:
                diags.append(Diagnostic(
                    "ADV008", "warning", name,
                    message=f"cacheable stage {name!r} has constructor "
                            f"knob(s) the cache signature hashes by type "
                            f"name only: {', '.join(opaque)} — changing "
                            f"them would NOT invalidate cached outputs; "
                            f"fold them into cache_params or override "
                            f"signature()"))
        if s.unpicklable_outputs and (s.resume_payload or s.cacheable):
            via = "resume_payload" if s.resume_payload else "the cache"
            diags.append(Diagnostic(
                "ADV009", "warning", name,
                message=f"stage {name!r} declares unpicklable outputs "
                        f"{sorted(s.unpicklable_outputs)} but asks for "
                        f"persistence via {via} — restores will degrade "
                        f"to a re-run; set resume_payload=False or drop "
                        f"cacheable"))

    return _partition(graph.name, diags, waivers)


def _planner_diags(graph: StageGraph, template: Any,
                   intent: Optional[ResourceIntent],
                   budget_usd: Optional[float],
                   steps: Optional[int]) -> List[Diagnostic]:
    """ADV006 (zero feasible candidates) and ADV007 (over budget) via a
    dry run of the memoized planner."""
    from repro_torch.core.planner import plan

    diags: List[Diagnostic] = []
    if intent is None and template is not None:
        intent = template.default_intent()

    # every distinct intent the scheduler would plan, with the stage(s)
    # it anchors to for messaging
    intents: List[Tuple[Optional[str], ResourceIntent]] = []
    if intent is not None:
        intents.append((None, intent))
        for s in graph.stages.values():
            if isinstance(s, PlanStage):
                for stage_name, goal in s.stage_goals.items():
                    if stage_name in graph.stages:
                        try:
                            intents.append((stage_name,
                                            intent.with_goal(goal)))
                        except ValueError as e:
                            diags.append(Diagnostic(
                                "ADV006", "error", s.name,
                                message=f"stage_goals[{stage_name!r}]: "
                                        f"{e}"))
    for name, s in graph.stages.items():
        if s.intent is not None:
            intents.append((name, s.intent))

    choices: List[Any] = []
    seen: Set[Tuple[Optional[str], str]] = set()
    for stage_name, it in intents:
        marker = (stage_name, repr(it))
        if marker in seen:
            continue
        seen.add(marker)
        where = f"stage {stage_name!r}" if stage_name else "the workflow"
        try:
            ranked = plan(it, top_k=1)
        except Exception as e:
            diags.append(Diagnostic(
                "ADV006", "error", stage_name,
                message=f"planner rejected the intent for {where}: {e}"))
            continue
        if not ranked:
            diags.append(Diagnostic(
                "ADV006", "error", stage_name,
                message=f"no feasible plan for {where} "
                        f"(arch={it.arch}, shape={it.shape}, "
                        f"goal={it.goal}): every catalog candidate is "
                        f"filtered by the constraints — relax "
                        f"budget/chip bounds"))
        elif stage_name is None:
            choices.append(ranked[0])

    if budget_usd is not None and choices:
        n = steps or (getattr(template, "num_steps", None) or 0)
        projected = choices[0].est.cost_per_step * n
        if projected > budget_usd:
            diags.append(Diagnostic(
                "ADV007", "error", None,
                message=f"cheapest plan projects "
                        f"${projected:,.2f} for {n} steps, over the "
                        f"budget envelope ${budget_usd:,.2f} "
                        f"({choices[0].slice.name}, "
                        f"${choices[0].est.cost_per_step:,.4f}/step) — "
                        f"raise budget_usd or cut num_steps"))
    return diags


def _partition(name: str, diags: Sequence[Diagnostic],
               waivers: Sequence[Dict[str, Any]]) -> CheckReport:
    """Split diagnostics into active and waived; dedup along the way."""
    def _waived(d: Diagnostic) -> bool:
        return any(
            w.get("code") == d.code
            and (w.get("stage") in (None, d.stage))
            for w in waivers)

    seen: Set[Tuple] = set()
    active: List[Diagnostic] = []
    waived: List[Diagnostic] = []
    for d in diags:
        marker = (d.code, d.stage, d.key, d.message)
        if marker in seen:
            continue
        seen.add(marker)
        (waived if _waived(d) else active).append(d)
    order = {"error": 0, "warning": 1}
    active.sort(key=lambda d: (order[d.severity], d.code,
                               d.stage or "", d.key or ""))
    waived.sort(key=lambda d: (order[d.severity], d.code,
                               d.stage or "", d.key or ""))
    return CheckReport(name, tuple(active), tuple(waived))


# ===========================================================================
# Spec-level entry point (what `cli check` runs)
# ===========================================================================
def check_spec(doc: Dict[str, Any], *,
               targets: Optional[Sequence[str]] = None,
               steps: Optional[int] = None,
               budget_usd: Optional[float] = None,
               intent: Optional[ResourceIntent] = None,
               ) -> CheckReport:
    """Check a spec document (workflow or package kind): schema first
    (ADV010), then reconstruction (non-strict, so unknown stage types
    degrade to declarations instead of blocking analysis), then the
    full :func:`check_workflow` battery with the spec's own results /
    external_inputs / waivers / budget threaded through.  Keyword
    arguments override the corresponding spec fields."""
    name = doc.get("name", "<spec>") if isinstance(doc, dict) else "<spec>"
    errors = validate_spec(doc)
    if errors:
        return CheckReport(name, tuple(
            Diagnostic("ADV010", "error", None, e) for e in errors))

    template = None
    params: Dict[str, Any] = {}
    wf_doc = doc
    if doc.get("kind") == "package":
        try:
            template, wf_doc, params = unpack_package(doc)
        except SpecError as e:
            return CheckReport(name, (
                Diagnostic("ADV010", "error", None, str(e)),))

    try:
        graph = from_spec(wf_doc, strict=False)
    except (SpecError, GraphError) as e:
        return CheckReport(name, (
            Diagnostic("ADV010", "error", None, str(e)),))

    if steps is None:
        steps = params.get("steps_override") or (
            template.num_steps if template is not None else None)
    return check_workflow(
        graph,
        template=template,
        intent=intent,
        targets=targets,
        results=wf_doc.get("results", ()),
        external_inputs=wf_doc.get("external_inputs", ()),
        waivers=wf_doc.get("waivers", ()),
        budget_usd=(budget_usd if budget_usd is not None
                    else wf_doc.get("budget_usd")),
        steps=steps,
    )


# ===========================================================================
# The ADV005 lowering: make cross-slice handoffs explicit
# ===========================================================================
def insert_movement_stages(
    graph: StageGraph,
    slices: Optional[Dict[str, Optional[str]]] = None,
    *,
    template: Any = None,
    intent: Optional[ResourceIntent] = None,
) -> StageGraph:
    """Lower a graph so every cross-slice handoff passes through an
    explicit :class:`~repro_torch.core.stages.MoveStage` — the fix ADV005
    recommends, applied mechanically.

    For each (key, producer-slice, consumer-slice) gap one movement
    stage ``move.<key>.<src>.<dst>`` is inserted depending on the
    producer, and every consumer of that key on ``dst`` gains a
    dependency on it (keeping its original edges).  Stages are shared:
    two consumers of the same key on the same slice get one move.
    ``slices`` defaults to the scheduler's own resolution
    (:func:`repro_torch.core.workflow.resolve_placement_map` via
    ``template``/``intent``).  The input graph is not mutated; stage
    objects are shared with the lowered copy.
    """
    if slices is None:
        slices = _slice_map(graph, template, intent)
    producers = _producers(graph)
    order = graph.topo_order()

    # gap -> (move_name, producer) ; consumer -> extra deps
    moves: Dict[Tuple[str, str, str], Tuple[str, str]] = {}
    extra: Dict[str, List[str]] = {}
    for name in order:
        s = graph.stages[name]
        dst = slices.get(name)
        if dst is None:
            continue
        for k in s.inputs:
            for p in producers.get(k, ()):
                src = slices.get(p)
                if src is None or src == dst:
                    continue
                gap = (k, src, dst)
                if gap not in moves:
                    moves[gap] = (f"move.{k}.{src}.{dst}", p)
                extra.setdefault(name, []).append(moves[gap][0])

    if not moves:
        return graph

    by_producer: Dict[str, List[Tuple[str, Tuple[str, str, str]]]] = {}
    for gap, (mname, producer) in moves.items():
        by_producer.setdefault(producer, []).append((mname, gap))

    lowered = StageGraph(graph.name)
    for name in graph.stages:  # preserve insertion order
        deps = tuple(graph.deps(name)) + tuple(
            dict.fromkeys(extra.get(name, ())))
        lowered.add(graph.stages[name], depends_on=deps)
        # insert this producer's moves right after it so the lowered
        # graph's insertion (and thus topo) order stays deterministic
        for mname, (k, src, dst) in sorted(
                by_producer.get(name, ())):
            lowered.add(MoveStage(mname, key=k, src=src, dst=dst),
                        depends_on=(name,))
    lowered.validate()
    return lowered


__all__ = [
    "CODES", "Diagnostic", "CheckReport", "CheckError",
    "check_workflow", "check_spec", "insert_movement_stages",
]
