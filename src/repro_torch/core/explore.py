"""Cost-performance explorer: the paper's Fig. 4 workflow as a subsystem.

The headline Adviser result is *rapid exploration of cost-performance
tradeoffs and scaling behavior without cloud expertise*: hold the
workload fixed, sweep the resource axis, read off time-to-solution vs
cost-per-solution.  This module turns that journey from a demo script
into a first-class engine:

  * :class:`ExploreSpec` — a declarative sweep grid
    (arch × shape × goal × chip-count × global-batch) plus shared
    constraints (budget, deadline) and a failure model;
  * :func:`explore` — drives the vectorized planner across the grid
    (every cell is one memoized :func:`repro_torch.core.planner.plan` call),
    extracts the **exact Pareto frontier** over the merged cross-intent
    candidate set (step_s vs $/Mtok vs slice $/h, reusing the planner's
    strict-dominance semantics), builds a **scaling report** (parallel
    efficiency vs chips per chip generation, knee detection), and folds
    preemption rates + restart backoff budgets into a **retry-aware
    expected cost** per plan
    (:func:`repro_torch.core.costmodel.retry_expected_cost`);
  * per-cell caching — pass a :class:`repro_torch.core.stagecache.StageCache`
    and each grid cell persists under a content-addressed key that
    includes the catalog generation, so a repeated or resumed sweep
    recomputes only new cells;
  * :func:`report_markdown` — a deterministic Markdown report (tables,
    fixed float formats, no timestamps) suitable for golden tests and
    the run-dir artifact ``runs/<id>/explore.md``.

Entry points: ``repro_torch.launch.cli explore`` (CLI) and
:class:`repro_torch.core.stages.ExploreStage` (stage graphs), both on
this one sweep path.  See docs/exploring-cost-performance.md for the
walkthrough and docs/cost-model.md for the underlying math (the
reference's documents; the port computes the same).

A copy of the reference package's ``core/explore.py`` on the port's
planner.  The scaling report sweeps every chip generation the catalog
holds (:func:`repro_torch.core.catalog.chip_generations`): the
reference's TPU generations, and the card once it is registered.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import calibrate
from repro_torch.core.catalog import catalog_generation, chip_generations
from repro_torch.core.costmodel import RetryCost, retry_expected_cost
from repro_torch.core.intent import ResourceIntent
from repro_torch.core.planner import PlanChoice, plan
from repro_torch.core.provenance import stable_hash
from repro_torch.ft.failures import RestartPolicy


def _as_tuple(v) -> tuple:
    if v is None:
        return ()
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,)


# ===========================================================================
# The sweep grid
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class ExploreSpec:
    """A declarative cost-performance sweep.

    Axes (the cross product defines the grid, in this order): ``archs``
    × ``shapes`` × ``goals`` × ``chip_counts`` × ``global_batches``.
    Empty ``chip_counts`` / ``global_batches`` mean "one cell with the
    planner free to choose" / "the shape's own global batch".

    Constraints (``budget_usd_per_hour``, ``max_step_seconds``,
    ``chip_generation``, ``allow_multi_pod``) apply to every cell.

    The failure model (``preempt_rate_per_chip_hour`` + the restart
    knobs) drives the retry-aware expected-cost column: preemptions
    arrive Poisson per chip-hour, restarts back off under a
    :class:`~repro_torch.ft.failures.RestartPolicy` — see
    :func:`repro_torch.core.costmodel.retry_expected_cost`.
    """

    archs: Tuple[str, ...]
    shapes: Tuple[str, ...] = ("train_4k",)
    goals: Tuple[str, ...] = ("production",)
    chip_counts: Tuple[int, ...] = ()
    global_batches: Tuple[int, ...] = ()
    budget_usd_per_hour: Optional[float] = None
    max_step_seconds: Optional[float] = None
    chip_generation: Optional[str] = None
    allow_multi_pod: bool = True
    top_k: int = 3
    # retry-aware cost projection
    steps: int = 1000
    preempt_rate_per_chip_hour: float = 0.0
    max_restarts: int = 5
    backoff_s: float = 30.0
    max_backoff_s: float = 300.0
    restore_frac: float = 0.5
    # scaling report
    knee_threshold: float = 0.5

    def __post_init__(self):
        for f in ("archs", "shapes", "goals", "chip_counts",
                  "global_batches"):
            object.__setattr__(self, f, _as_tuple(getattr(self, f)))
        if not self.archs:
            raise ValueError("ExploreSpec needs at least one arch")

    def restart_policy(self) -> RestartPolicy:
        return RestartPolicy(max_restarts=self.max_restarts,
                             backoff_s=self.backoff_s,
                             max_backoff_s=self.max_backoff_s)

    def cell_specs(self) -> List["CellSpec"]:
        """The grid in deterministic row-major order."""
        out = []
        for arch in self.archs:
            for shape in self.shapes:
                for goal in self.goals:
                    for chips in self.chip_counts or (None,):
                        for gb in self.global_batches or (None,):
                            out.append(CellSpec(arch, shape, goal,
                                                chips, gb))
        return out


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """One grid cell: the coordinates of a single planner query."""

    arch: str
    shape: str
    goal: str
    chips: Optional[int] = None
    global_batch: Optional[int] = None

    def shape_name(self) -> str:
        """The (possibly derived) shape this cell plans against."""
        if self.global_batch is None:
            return self.shape
        return derived_shape(self.shape, self.global_batch)

    def intent(self, spec: ExploreSpec) -> ResourceIntent:
        return ResourceIntent(
            arch=self.arch, shape=self.shape_name(), goal=self.goal,
            budget_usd_per_hour=spec.budget_usd_per_hour,
            max_step_seconds=spec.max_step_seconds,
            chip_generation=spec.chip_generation,
            min_chips=self.chips, max_chips=self.chips,
            allow_multi_pod=spec.allow_multi_pod,
        )

    def label(self) -> str:
        bits = [self.arch, self.shape, self.goal]
        if self.chips is not None:
            bits.append(f"{self.chips}c")
        if self.global_batch is not None:
            bits.append(f"gb{self.global_batch}")
        return "/".join(bits)


def derived_shape(base: str, global_batch: int) -> str:
    """Register (once) and name a ShapeConfig that is ``base`` with its
    global batch replaced — the explore grid's global-batch axis.  The
    derived shape lives in the ordinary SHAPES registry so the planner's
    name-keyed machinery (memoized scored tables, intent hashes) applies
    unchanged."""
    from repro_torch.configs import SHAPES, ShapeConfig, get_shape

    b = get_shape(base)
    if global_batch == b.global_batch:
        return base
    name = f"{base}@gb{global_batch}"
    if name not in SHAPES:
        SHAPES[name] = ShapeConfig(name, b.seq_len, global_batch, b.kind)
    return name


# ===========================================================================
# Results
# ===========================================================================
@dataclasses.dataclass
class CellResult:
    """One grid cell's plans: the ranked top-k for reporting, plus the
    *full* dominance-pruned survivor set (``survivors``) the merged
    frontier is computed over — truncating to top-k before the merge
    would silently drop true frontier points that rank low under the
    cell's goal key."""

    cell: CellSpec
    shape_name: str
    choices: List[PlanChoice]
    survivors: List[PlanChoice] = dataclasses.field(default_factory=list)
    from_cache: bool = False
    # the catalog generation observed when THIS cell was planned — under
    # a concurrent register_slice the sweep's cells may span generations,
    # and each cache entry must be keyed by the generation its plans were
    # actually computed against (docs/calibration.md §registry)
    generation: int = 0

    @property
    def best(self) -> Optional[PlanChoice]:
        return self.choices[0] if self.choices else None


@dataclasses.dataclass
class FrontierPoint:
    """One Pareto-optimal (cell, candidate) pair of the merged sweep."""

    cell: CellSpec
    choice: PlanChoice
    retry: RetryCost


@dataclasses.dataclass
class ScalingRow:
    chips: int
    slice_name: str
    step_s: float
    cost_per_mtok: float
    efficiency: float  # T(n0)·n0 / (T(n)·n), n0 = family baseline
    bottleneck: str = ""


@dataclasses.dataclass
class ScalingFamily:
    """Strong-scaling behavior of one (arch, shape) on one chip
    generation: efficiency vs chips, plus the knee — the largest chip
    count still at or above the spec's efficiency threshold."""

    arch: str
    shape: str
    generation: str
    rows: List[ScalingRow]
    knee_chips: Optional[int]


@dataclasses.dataclass
class ExploreResult:
    spec: ExploreSpec
    cells: List[CellResult]
    frontier: List[FrontierPoint]
    scaling: List[ScalingFamily]
    catalog_generation: int

    @property
    def cells_from_cache(self) -> int:
        return sum(1 for c in self.cells if c.from_cache)

    @property
    def feasible_cells(self) -> int:
        return sum(1 for c in self.cells if c.choices)

    def to_markdown(self) -> str:
        return report_markdown(self)


# ===========================================================================
# The engine
# ===========================================================================
def cell_cache_key(spec: ExploreSpec, cell: CellSpec, generation: int,
                   engine: str) -> str:
    """Content-addressed key for one grid cell: its coordinates, every
    spec field that changes the planner query or the retry projection,
    the catalog generation (a fleet that gained a slice type must
    re-plan the cell), and the active calibration's per-kind fingerprint
    (new fitted coefficients change step_s, so cached cells must
    miss)."""
    from repro_torch.configs import get_shape

    constraints = {
        "budget_usd_per_hour": spec.budget_usd_per_hour,
        "max_step_seconds": spec.max_step_seconds,
        "chip_generation": spec.chip_generation,
        "allow_multi_pod": spec.allow_multi_pod,
        "top_k": spec.top_k,
    }
    kind = get_shape(cell.shape_name()).kind
    return stable_hash({"explore_cell": dataclasses.asdict(cell),
                        "constraints": constraints,
                        "engine": engine,
                        "catalog_generation": generation,
                        "calibration_state": calibrate.calibration_state(kind),
                        "version": "3"})


def _run_cell(cell: CellSpec, spec: ExploreSpec, engine: str,
              generation: int = 0) -> CellResult:
    intent = cell.intent(spec)
    # one planner query: the full pruned survivor set in ranked order;
    # the reported top-k is its prefix
    survivors = plan(intent, top_k=2 ** 31, engine=engine)
    return CellResult(cell=cell, shape_name=cell.shape_name(),
                      choices=survivors[:spec.top_k], survivors=survivors,
                      generation=generation)


def _weakly_dominated(*axes) -> "Any":
    """True where some other candidate is at least as good on every axis
    and strictly better on at least one (Pareto/weak dominance, "lower
    is better").  This is the frontier-defining predicate: the planner's
    *strict* :func:`repro_torch.core.planner._dominated` is the right tool for
    rank-order-safe pruning, but as a frontier test it would keep every
    same-priced plan that loses on both step time and $/Mtok.  O(n²) in
    float64 — run it on the already-pruned merged set, not raw grids."""
    import numpy as np

    cols = [np.asarray(a, dtype=np.float64) for a in axes]
    # [i, j] == True ⇔ candidate j (weakly/strictly) beats i on the axis
    le = np.ones((len(cols[0]),) * 2, dtype=bool)
    lt = np.zeros_like(le)
    for col in cols:
        le &= col[None, :] <= col[:, None]
        lt |= col[None, :] < col[:, None]
    return (le & lt).any(axis=1)


def _merged_frontier(spec: ExploreSpec,
                     cells: List[CellResult]) -> List[FrontierPoint]:
    """Exact Pareto frontier of the merged cross-intent candidate set,
    on (step_s, cost_per_mtok, slice $/h): a candidate survives iff no
    other is at least as good on all three axes and strictly better on
    one (:func:`_weakly_dominated`).

    Exactness: each cell contributes its full dominance-pruned survivor
    set, not just its goal-ranked top-k.  The planner prunes with
    *strict* dominance on four axes (these three plus hbm_frac), and a
    strict 4-axis dominator is a weak 3-axis dominator, so the survivors
    are a superset of the true frontier and nothing exact is lost.
    Candidates are deduplicated by identity (different goals enumerate
    the same (slice × mesh × geometry) cells), keeping the first cell
    that surfaced them."""
    import numpy as np

    seen: Dict[tuple, Tuple[CellSpec, PlanChoice]] = {}
    for cr in cells:
        for c in cr.survivors or cr.choices:
            key = (cr.cell.arch, cr.shape_name, c.slice.name,
                   tuple(c.mesh_shape), c.geometry)
            if key not in seen:
                seen[key] = (cr.cell, c)
    cands = list(seen.values())
    if not cands:
        return []
    step = np.asarray([c.est.step_s for _, c in cands])
    cost = np.asarray([c.est.cost_per_mtok for _, c in cands])
    price = np.asarray([c.slice.price_per_hour for _, c in cands])
    dom = _weakly_dominated(step, cost, price)
    policy = spec.restart_policy()
    points = [
        FrontierPoint(cell, choice,
                      retry_expected_cost(
                          choice.est, choice.slice, spec.steps,
                          spec.preempt_rate_per_chip_hour, policy,
                          spec.restore_frac))
        for (cell, choice), d in zip(cands, dom) if not d
    ]
    points.sort(key=lambda p: (p.choice.est.step_s,
                               p.choice.est.cost_per_mtok,
                               p.choice.slice.name))
    return points


def _family_cache_key(spec: ExploreSpec, arch: str, shape_name: str,
                      gen: str, generation: int, engine: str) -> str:
    from repro_torch.configs import get_shape

    return stable_hash({
        "explore_scaling": {"arch": arch, "shape": shape_name,
                            "generation": gen},
        "chip_counts": sorted(spec.chip_counts),
        "knee_threshold": spec.knee_threshold,
        "constraints": {
            "budget_usd_per_hour": spec.budget_usd_per_hour,
            "max_step_seconds": spec.max_step_seconds,
            "allow_multi_pod": spec.allow_multi_pod,
        },
        "engine": engine,
        "catalog_generation": generation,
        "calibration_state": calibrate.calibration_state(
            get_shape(shape_name).kind),
        "version": "3",
    })


def _scaling_report(spec: ExploreSpec, engine: str, cache: Any = None,
                    generation: int = 0) -> List[ScalingFamily]:
    """Strong scaling per chip generation: for each (arch, shape) and
    each generation, the fastest feasible plan at every requested chip
    count; efficiency is T(n0)·n0 / T(n)·n against the family's
    smallest feasible count; the knee is the largest count still at or
    above ``spec.knee_threshold``.  Families are cached alongside the
    grid cells (same StageCache, catalog-generation-keyed), so a fully
    warm sweep issues no planner queries at all."""
    if not spec.chip_counts:
        return []
    families: List[ScalingFamily] = []
    generations = ([spec.chip_generation] if spec.chip_generation
                   else chip_generations())
    for arch in spec.archs:
        for shape in spec.shapes:
            for gb in spec.global_batches or (None,):
                shape_name = (derived_shape(shape, gb) if gb is not None
                              else shape)
                for gen in generations:
                    key = _family_cache_key(spec, arch, shape_name, gen,
                                            generation, engine)
                    if cache is not None:
                        hit = cache.get(key)
                        if hit is not None and "family" in hit:
                            if hit["family"] is not None:
                                families.append(hit["family"])
                            continue
                    t0 = time.perf_counter()
                    rows: List[ScalingRow] = []
                    base = None
                    for n in sorted(spec.chip_counts):
                        intent = ResourceIntent(
                            arch=arch, shape=shape_name, goal="exploration",
                            budget_usd_per_hour=spec.budget_usd_per_hour,
                            max_step_seconds=spec.max_step_seconds,
                            chip_generation=gen,
                            min_chips=n, max_chips=n,
                            allow_multi_pod=spec.allow_multi_pod,
                        )
                        best = plan(intent, top_k=1, engine=engine)
                        if not best:
                            continue
                        c = best[0]
                        work = c.est.step_s * n
                        if base is None:
                            base = work
                        rows.append(ScalingRow(
                            chips=n, slice_name=c.slice.name,
                            step_s=c.est.step_s,
                            cost_per_mtok=c.est.cost_per_mtok,
                            efficiency=base / work,
                            bottleneck=c.est.bottleneck,
                        ))
                    fam = None
                    if rows:
                        knee = None
                        for r in rows:
                            if r.efficiency >= spec.knee_threshold:
                                knee = r.chips
                        fam = ScalingFamily(
                            arch=arch, shape=shape_name, generation=gen,
                            rows=rows, knee_chips=knee)
                        families.append(fam)
                    if cache is not None:
                        # infeasible families cache as None so a warm
                        # sweep skips their planner queries too
                        cache.put(key,
                                  f"explore-scaling:{arch}/{shape_name}/{gen}",
                                  {"family": fam},
                                  time.perf_counter() - t0)
    return families


def explore(spec: ExploreSpec, *, cache: Any = None,
            engine: str = "vectorized") -> ExploreResult:
    """Run the sweep: one planner query per grid cell (cached per cell
    when a StageCache is supplied), merged Pareto frontier, scaling
    report, retry-aware cost projections.

    Concurrent catalog mutation is safe: the catalog generation is
    re-read per cell, so each cached cell entry is keyed by the
    generation its plans were actually computed against.  A
    ``register_slice`` landing mid-sweep makes later cells plan (and
    cache) under the new generation — earlier entries stay keyed to the
    old one, and a follow-up sweep recomputes exactly those — while the
    merged frontier remains internally consistent (the weak-dominance
    predicate holds over whatever candidate set the cells produced)."""
    generation = catalog_generation()
    cells: List[CellResult] = []
    for cs in spec.cell_specs():
        cell_gen = catalog_generation()  # per-cell snapshot (see above)
        key = cell_cache_key(spec, cs, cell_gen, engine)
        if cache is not None:
            hit = cache.get(key)
            if hit is not None and "cell" in hit:
                cell = hit["cell"]
                cell.from_cache = True
                cells.append(cell)
                continue
        t0 = time.perf_counter()
        cell = _run_cell(cs, spec, engine, generation=cell_gen)
        dt = time.perf_counter() - t0
        if cache is not None:
            cache.put(key, f"explore:{cs.label()}", {"cell": cell}, dt)
        cells.append(cell)
    frontier = _merged_frontier(spec, cells)
    scaling = _scaling_report(spec, engine, cache=cache,
                              generation=generation)
    return ExploreResult(spec=spec, cells=cells, frontier=frontier,
                         scaling=scaling, catalog_generation=generation)


# ===========================================================================
# The deterministic Markdown report
# ===========================================================================
def _fmt_money(v: float) -> str:
    return f"{v:,.2f}"


def _spec_lines(spec: ExploreSpec) -> List[str]:
    lines = [
        f"- archs: {', '.join(spec.archs)}",
        f"- shapes: {', '.join(spec.shapes)}",
        f"- goals: {', '.join(spec.goals)}",
    ]
    if spec.chip_counts:
        lines.append("- chip counts: "
                     + ", ".join(str(n) for n in spec.chip_counts))
    if spec.global_batches:
        lines.append("- global batches: "
                     + ", ".join(str(n) for n in spec.global_batches))
    if spec.budget_usd_per_hour is not None:
        lines.append(f"- budget: ${_fmt_money(spec.budget_usd_per_hour)}/h")
    if spec.max_step_seconds is not None:
        lines.append(f"- deadline: {spec.max_step_seconds * 1e3:.1f} ms/step")
    if spec.chip_generation:
        lines.append(f"- chip generation: {spec.chip_generation}")
    if not spec.allow_multi_pod:
        lines.append("- multi-pod: disallowed")
    lines.append(
        f"- cost horizon: {spec.steps} steps, preemption rate "
        f"{spec.preempt_rate_per_chip_hour:g}/chip-hour, up to "
        f"{spec.max_restarts} restarts (backoff {spec.backoff_s:g}s base, "
        f"{spec.max_backoff_s:g}s cap)")
    return lines


def report_markdown(result: ExploreResult) -> str:
    """Render the sweep as deterministic Markdown: same spec + same
    catalog ⇒ byte-identical output (fixed float formats, no
    timestamps), so the report is golden-testable and diffs between
    catalog generations are meaningful."""
    spec = result.spec
    out: List[str] = ["# Cost-performance exploration", ""]
    out.extend(_spec_lines(spec))
    out.append(f"- grid: {len(result.cells)} cells "
               f"({result.feasible_cells} feasible), catalog generation "
               f"{result.catalog_generation}")
    out.append("")

    out.append("## Pareto frontier (step time × $/Mtok × $/h)")
    out.append("")
    if result.frontier:
        out.append("| # | arch | shape | gbatch | slice | mesh | remat "
                   "| ubatch | step ms | $/Mtok | $/h | E[$] | E[hours] |")
        out.append("|---|------|-------|--------|-------|------|-------"
                   "|--------|---------|--------|-----|------|----------|")
        for i, p in enumerate(result.frontier, 1):
            e, g = p.choice.est, p.choice.geometry
            mesh = "x".join(map(str, p.choice.mesh_shape))
            gb = (str(p.cell.global_batch)
                  if p.cell.global_batch is not None else "-")
            out.append(
                f"| {i} | {p.cell.arch} | {p.cell.shape} | {gb} "
                f"| {p.choice.slice.name} | {mesh} | {g.remat} "
                f"| {g.microbatch} | {e.step_s * 1e3:.2f} "
                f"| {e.cost_per_mtok:.4f} "
                f"| {_fmt_money(p.choice.slice.price_per_hour)} "
                f"| {_fmt_money(p.retry.expected_cost_usd)} "
                f"| {p.retry.expected_hours:.3f} |")
    else:
        out.append("no feasible candidates under the given constraints")
    out.append("")

    if result.scaling:
        out.append("## Scaling (strong scaling per chip generation)")
        out.append("")
        for fam in result.scaling:
            knee = (f"knee at {fam.knee_chips} chips"
                    if fam.knee_chips is not None
                    else "no chip count meets the efficiency threshold")
            out.append(f"### {fam.arch} × {fam.shape} on {fam.generation} "
                       f"— {knee}")
            out.append("")
            out.append("| chips | slice | step ms | efficiency | $/Mtok "
                       "| bottleneck |")
            out.append("|-------|-------|---------|------------|--------"
                       "|------------|")
            for r in fam.rows:
                out.append(f"| {r.chips} | {r.slice_name} "
                           f"| {r.step_s * 1e3:.2f} | {r.efficiency:.3f} "
                           f"| {r.cost_per_mtok:.4f} | {r.bottleneck} |")
            out.append("")

    out.append("## Cells")
    out.append("")
    out.append("| arch | shape | goal | chips | gbatch | best slice | mesh "
               "| step ms | $/Mtok | E[$] | E[fail] |")
    out.append("|------|-------|------|-------|--------|------------|------"
               "|---------|--------|------|---------|")
    policy = spec.restart_policy()
    for cr in result.cells:
        cs = cr.cell
        chips = str(cs.chips) if cs.chips is not None else "-"
        gb = str(cs.global_batch) if cs.global_batch is not None else "-"
        if cr.best is None:
            out.append(f"| {cs.arch} | {cs.shape} | {cs.goal} | {chips} "
                       f"| {gb} | infeasible | - | - | - | - | - |")
            continue
        c = cr.best
        rc = retry_expected_cost(c.est, c.slice, spec.steps,
                                 spec.preempt_rate_per_chip_hour, policy,
                                 spec.restore_frac)
        mesh = "x".join(map(str, c.mesh_shape))
        out.append(
            f"| {cs.arch} | {cs.shape} | {cs.goal} | {chips} | {gb} "
            f"| {c.slice.name} | {mesh} | {c.est.step_s * 1e3:.2f} "
            f"| {c.est.cost_per_mtok:.4f} "
            f"| {_fmt_money(rc.expected_cost_usd)} "
            f"| {rc.expected_failures:.2f} |")
    out.append("")
    return "\n".join(out)


def frontier_table(result: ExploreResult) -> str:
    """Plain-text frontier rendering for terminals (the CLI's stdout)."""
    if not result.frontier:
        return "no feasible candidates under the given constraints"
    lines = []
    for i, p in enumerate(result.frontier, 1):
        rc = p.retry
        lines.append(
            f"  #{i:<2d} {p.choice.summary}  "
            f"E[$]={rc.expected_cost_usd:,.2f} "
            f"E[h]={rc.expected_hours:.3f} "
            f"({p.cell.label()})")
    return "\n".join(lines)


# ===========================================================================
# Machine-readable result docs + the byte-deterministic compare report
# (``repro explore --compare RUN_ID``: how calibration shifts are
# diffed across explore runs)
# ===========================================================================
def result_doc(result: ExploreResult) -> Dict[str, Any]:
    """A JSON-able summary of a sweep — written next to ``explore.md``
    as ``explore.json`` so a later run can be diffed against it
    (``explore --compare``).  Contains everything the compare report
    needs: the spec (to re-run the identical grid), per-cell best plans,
    the frontier's identity keys, and the catalog + calibration
    generations the sweep saw."""
    def choice_doc(c: Optional[PlanChoice]) -> Optional[Dict[str, Any]]:
        if c is None:
            return None
        return {
            "slice": c.slice.name,
            "mesh": "x".join(map(str, c.mesh_shape)),
            "remat": c.geometry.remat,
            "microbatch": c.geometry.microbatch,
            "step_s": c.est.step_s,
            "cost_per_mtok": c.est.cost_per_mtok,
            "hbm_frac": c.est.hbm_frac,
            "bottleneck": c.est.bottleneck,
            "price_per_hour": c.slice.price_per_hour,
        }

    cal = calibrate.active()
    return {
        "version": 1,
        "spec": dataclasses.asdict(result.spec),
        "catalog_generation": result.catalog_generation,
        "calibration_generation": cal.generation if cal is not None else 0,
        "cells": [{
            "label": cr.cell.label(),
            "cell": dataclasses.asdict(cr.cell),
            "shape_name": cr.shape_name,
            "generation": cr.generation,
            "best": choice_doc(cr.best),
        } for cr in result.cells],
        "frontier": [{
            "cell": p.cell.label(),
            "slice": p.choice.slice.name,
            "mesh": "x".join(map(str, p.choice.mesh_shape)),
            "remat": p.choice.geometry.remat,
            "microbatch": p.choice.geometry.microbatch,
            "step_s": p.choice.est.step_s,
            "cost_per_mtok": p.choice.est.cost_per_mtok,
        } for p in result.frontier],
    }


def spec_from_doc(doc: Dict[str, Any]) -> ExploreSpec:
    """Reconstruct the sweep spec recorded by :func:`result_doc` — the
    compare path re-runs the *identical* grid, whatever axis flags the
    current CLI invocation carries."""
    return ExploreSpec(**doc["spec"])


def _delta_pct(old: float, new: float) -> str:
    if old == 0:
        return "-"
    return f"{(new - old) / old * 100:+.1f}%"


def compare_markdown(old_doc: Dict[str, Any],
                     new_doc: Dict[str, Any]) -> str:
    """Byte-deterministic Markdown diff of two sweep docs: per-cell step
    and $/Mtok deltas, plan changes, and frontier membership changes.
    Same two docs ⇒ identical bytes (fixed float formats, no
    timestamps, no run ids), so the report golden-tests — and a
    calibration-store update shows up as exactly the cells whose
    coefficients moved."""
    out: List[str] = ["# Explore comparison", ""]
    out.append(f"- baseline: catalog generation "
               f"{old_doc.get('catalog_generation', '?')}, calibration "
               f"generation {old_doc.get('calibration_generation', 0)}")
    out.append(f"- current: catalog generation "
               f"{new_doc.get('catalog_generation', '?')}, calibration "
               f"generation {new_doc.get('calibration_generation', 0)}")
    out.append("")

    old_cells = {c["label"]: c for c in old_doc.get("cells", [])}
    new_cells = {c["label"]: c for c in new_doc.get("cells", [])}
    out.append("## Cells")
    out.append("")
    out.append("| cell | step ms (old) | step ms (new) | Δ step "
               "| $/Mtok (old) | $/Mtok (new) | Δ $/Mtok | plan |")
    out.append("|------|---------------|---------------|--------"
               "|--------------|--------------|----------|------|")
    changed = 0
    for label in sorted(set(old_cells) | set(new_cells)):
        o = (old_cells.get(label) or {}).get("best")
        n = (new_cells.get(label) or {}).get("best")
        if o is None and n is None:
            out.append(f"| {label} | - | - | - | - | - | - | infeasible |")
            continue
        if o is None or n is None:
            which = "now feasible" if o is None else "now infeasible"
            got = n or o
            out.append(f"| {label} | - | {got['step_s'] * 1e3:.2f} | - | - "
                       f"| {got['cost_per_mtok']:.4f} | - | {which} |")
            changed += 1
            continue
        same_plan = (o["slice"] == n["slice"] and o["mesh"] == n["mesh"]
                     and o["remat"] == n["remat"]
                     and o["microbatch"] == n["microbatch"])
        plan_note = ("unchanged" if same_plan
                     else f"{o['slice']}/{o['mesh']} → "
                          f"{n['slice']}/{n['mesh']}")
        if not same_plan or abs(n["step_s"] - o["step_s"]) > 1e-12:
            changed += 1
        out.append(
            f"| {label} | {o['step_s'] * 1e3:.2f} | {n['step_s'] * 1e3:.2f} "
            f"| {_delta_pct(o['step_s'], n['step_s'])} "
            f"| {o['cost_per_mtok']:.4f} | {n['cost_per_mtok']:.4f} "
            f"| {_delta_pct(o['cost_per_mtok'], n['cost_per_mtok'])} "
            f"| {plan_note} |")
    out.append("")
    out.append(f"{changed} of {len(set(old_cells) | set(new_cells))} cells "
               f"changed")
    out.append("")

    def fkey(p):
        return (p["cell"], p["slice"], p["mesh"], p["remat"],
                p["microbatch"])

    old_front = {fkey(p): p for p in old_doc.get("frontier", [])}
    new_front = {fkey(p): p for p in new_doc.get("frontier", [])}
    out.append("## Frontier")
    out.append("")
    entered = sorted(set(new_front) - set(old_front))
    left = sorted(set(old_front) - set(new_front))
    out.append(f"- baseline points: {len(old_front)}; current points: "
               f"{len(new_front)}")
    for k in entered:
        p = new_front[k]
        out.append(f"- entered: {p['cell']} {p['slice']} {p['mesh']} "
                   f"remat={p['remat']} ubatch={p['microbatch']} "
                   f"step={p['step_s'] * 1e3:.2f}ms "
                   f"$/Mtok={p['cost_per_mtok']:.4f}")
    for k in left:
        p = old_front[k]
        out.append(f"- left: {p['cell']} {p['slice']} {p['mesh']} "
                   f"remat={p['remat']} ubatch={p['microbatch']} "
                   f"step={p['step_s'] * 1e3:.2f}ms "
                   f"$/Mtok={p['cost_per_mtok']:.4f}")
    if not entered and not left:
        out.append("- membership unchanged")
    out.append("")
    return "\n".join(out)
