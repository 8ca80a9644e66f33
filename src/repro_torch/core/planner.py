"""Planner: ResourceIntent → ranked, feasible execution plans.

This is the Adviser Execution Engine's instance-selection logic adapted to
a TPU fleet: enumerate (slice × mesh split × remat/microbatch geometry)
candidates from the catalog, score each with the analytic roofline cost
model, reject infeasible ones (HBM, budget, step-time caps), and rank by
the intent's goal:

  * ``production``   — lowest $ per token, step time as tie-break within
                       ~2% relative cost bands of the cheapest candidate
                       (the paper's Fig. 4b criterion);
  * ``exploration``  — lowest step time (fastest turnaround);
  * ``quick_test``   — smallest feasible slice (cheapest absolute $/h).

Hot path
--------
``plan()`` runs fully vectorized: the candidate grid is materialized once
per (kind, global_batch) as a structure-of-arrays
(:func:`repro_torch.core.catalog.candidate_table`), scored in one
:func:`repro_torch.core.costmodel.estimate_batch` pass memoized per
(arch, shape), filtered/ranked with NumPy masks and stable lexsorts, and
strictly-dominated candidates (worse on step_s, cost_per_mtok *and*
hbm_frac — with slice $/h as a fourth guard so quick_test ordering is
preserved) are pruned before ranking.  Ranked index orders are memoized
by a canonical intent hash, so ``plan_stages()`` and sweep fan-outs pay
for an enumeration once.  The scalar path survives as
``engine="scalar"`` — the parity oracle the benchmarks and property
tests compare against.

Memo entries record the catalog generation
(:func:`repro_torch.core.catalog.catalog_generation`): when the fleet gains a
slice type, scored tables extend with just the new rows and memoized
intents refresh lazily — incremental re-planning instead of wholesale
invalidation (docs/cost-model.md §incremental re-planning).

The winner's predictions are later validated against the compiled HLO in
the dry-run; :mod:`repro.core.explore` drives this machinery across
sweep grids to reproduce the paper's Fig. 4 journey (Pareto frontiers,
scaling knees, retry-aware expected cost).

A copy of the reference package's ``core/planner.py`` over the same
catalog, so it chooses the reference's plans for the same intents (the
configs are :func:`repro_torch.configs.get_config`'s).  An intent that
names the card (``chip_generation="h100"``, or a slice
``h100-1``/``h100-8``) registers the card's slices first (:func:`repro_torch.core.catalog.
register_card`); no other intent changes the catalog.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import get_config, get_shape
from repro_torch.core import calibrate
from repro_torch.core.catalog import (
    CATALOG,
    CandidateTable,
    SliceType,
    candidate_table,
    catalog_generation,
    find_slice,
    geometries_for,
    mesh_shapes_for,
    names_card,
    register_card,
    table_rows,
)
from repro_torch.core.costmodel import (
    BatchEstimate,
    CostEstimate,
    PlanGeometry,
    concat_batches,
    estimate,
    estimate_batch,
)
from repro_torch.core.intent import ResourceIntent


@dataclasses.dataclass
class PlanChoice:
    slice: SliceType
    mesh_shape: tuple
    mesh_axes: tuple
    geometry: PlanGeometry
    est: CostEstimate

    @property
    def summary(self) -> str:
        g = self.geometry
        return (
            f"{self.slice.name:>14s} mesh={self.mesh_shape!s:<14s} "
            f"remat={g.remat:<5s} ubatch={g.microbatch} "
            f"step={self.est.step_s*1e3:8.2f}ms "
            f"bottleneck={self.est.bottleneck:<10s} "
            f"hbm={self.est.hbm_frac*100:5.1f}% "
            f"$/Mtok={self.est.cost_per_mtok:8.4f}"
        )


def intent_hash(intent: ResourceIntent) -> str:
    """Canonical hash of an intent — the planner's memoization key."""
    payload = json.dumps(dataclasses.asdict(intent), sort_keys=True,
                         default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


# ===========================================================================
# Memoization: scored tables per (arch, shape), ranked orders per intent.
# Entries record the catalog generation they were computed under, so a
# catalog that *gained* slice types extends scored tables with just the
# new rows (incremental re-scoring) and lazily refreshes memoized ranked
# orders — instead of invalidating every memoized intent wholesale.
# ===========================================================================
_BATCH_CACHE: "Dict[Tuple[str, str], Tuple[int, str, CandidateTable, BatchEstimate]]" = {}
_BATCH_CACHE_MAX = 128  # FIFO bound: derived shapes (train_4k@gbN) can
# mint unbounded (arch, shape) keys through the explore global-batch axis
_PLAN_CACHE: "Dict[str, Tuple[int, str, np.ndarray, str, str]]" = {}
_PLAN_CACHE_MAX = 256
_CACHE_LOCK = threading.Lock()

# Observable counters for the incremental re-planning tests and the
# bench: memo hits, cold ranks, and generation-driven refreshes.
PLANNER_STATS: Dict[str, int] = {
    "plan_calls": 0, "memo_hits": 0, "cold_ranks": 0, "stale_refreshes": 0,
    "table_extensions": 0,
}


def reset_planner_stats() -> None:
    for k in PLANNER_STATS:
        PLANNER_STATS[k] = 0


def clear_planner_cache() -> None:
    """Drop memoized batch scores and ranked plans (benchmarks/tests)."""
    with _CACHE_LOCK:
        _BATCH_CACHE.clear()
        _PLAN_CACHE.clear()


def _scored_table(arch: str, shape_name: str) -> Tuple[CandidateTable, BatchEstimate]:
    """The full candidate grid with batch scores, computed once per
    (config, shape) and shared by every intent over that workload.

    Generation-aware: when the catalog grew since the entry was scored,
    only the appended rows go through ``estimate_batch`` and the columns
    are concatenated (the prefix is immutable by construction — see
    :func:`repro_torch.core.catalog.register_slice`).

    Calibration-aware: each entry also records the active calibration's
    per-kind fingerprint (:func:`repro_torch.core.calibrate.calibration_state`).
    New coefficients for this workload's kind change step_s for the
    whole column, so the entry re-scores from scratch; coefficients for
    *other* kinds leave the fingerprint — and the memo — untouched."""
    key = (arch, shape_name)
    gen = catalog_generation()
    shape = get_shape(shape_name)
    cal_state = calibrate.calibration_state(shape.kind)
    with _CACHE_LOCK:
        hit = _BATCH_CACHE.get(key)
    if hit is not None and hit[1] != cal_state:
        hit = None  # calibrated step_s columns are stale end to end
    if hit is not None and hit[0] == gen:
        return hit[2], hit[3]
    cfg = get_config(arch)
    table = candidate_table(shape.kind, shape.global_batch)
    if (hit is not None and len(table) > len(hit[2])
            and table.slices[:len(hit[2])] == hit[2].slices):
        ext = table_rows(table, len(hit[2]))
        batch = concat_batches(hit[3], estimate_batch(cfg, shape, ext))
        PLANNER_STATS["table_extensions"] += 1
    else:
        batch = estimate_batch(cfg, shape, table)
    with _CACHE_LOCK:
        if key not in _BATCH_CACHE and len(_BATCH_CACHE) >= _BATCH_CACHE_MAX:
            _BATCH_CACHE.pop(next(iter(_BATCH_CACHE)))
        _BATCH_CACHE[key] = (gen, cal_state, table, batch)
    return table, batch


def _constraint_mask(intent: ResourceIntent, table: CandidateTable,
                     batch: BatchEstimate) -> np.ndarray:
    """Vectorized equivalent of the scalar enumeration's filters."""
    mask = np.asarray(batch.feasible).copy()
    if intent.slice_name:
        want = find_slice(intent.slice_name).name  # raises on unknown name
        names = np.asarray([s.name for s in CATALOG])
        mask &= names[table.slice_idx] == want
    if intent.chip_generation:
        chips_by_idx = np.asarray([s.chip.name for s in CATALOG])
        mask &= chips_by_idx[table.slice_idx] == intent.chip_generation
    if not intent.allow_multi_pod:
        mask &= ~table.multi_pod
    if intent.min_chips:
        mask &= table.chips >= intent.min_chips
    if intent.max_chips:
        mask &= table.chips <= intent.max_chips
    if intent.budget_usd_per_hour:
        mask &= table.slice_price <= intent.budget_usd_per_hour
    if intent.mesh_shape:
        want_mesh = tuple(intent.mesh_shape)
        mask &= np.fromiter((m == want_mesh for m in table.mesh_shapes),
                            dtype=bool, count=len(table))
    if intent.max_step_seconds:
        mask &= batch.step_s <= intent.max_step_seconds
    return mask


# ===========================================================================
# Dominance pruning
# ===========================================================================
def _dominated(*axes: np.ndarray) -> np.ndarray:
    """True where some other candidate is *strictly* better on every
    axis simultaneously (strict dominance — "lower is better" on all
    axes).  A strictly-dominated candidate can never precede its
    dominator under any sort key built from these axes, so pruning
    cannot perturb the ranked order of survivors.

    The planner calls this with (step_s, cost_per_mtok, hbm_frac,
    slice $/h — the fourth guards the quick_test ranking key); the
    explore engine reuses the same semantics on (step_s, cost_per_mtok,
    slice $/h) for exact cross-intent Pareto frontiers.

    Comparisons run in float32: rounding to f32 is monotone, so a strict
    f32 inequality implies the strict f64 inequality — the test can only
    under-prune, never mis-prune.  Two passes keep it off O(n²): a cheap
    cull against the 2D prefix front of the first two axes, then an
    exact pass whose dominator set is the rows still unmarked (strict
    dominance is transitive, so every dominated row has an undominated
    dominator).
    """
    n = len(axes[0])
    if n == 0:
        return np.zeros(0, dtype=bool)
    cols = [np.asarray(a).astype(np.float32) for a in axes]
    s, c = cols[0], cols[1] if len(cols) > 1 else cols[0]

    def marked_by(cand: np.ndarray) -> np.ndarray:
        worse = cols[0][:, None] > cols[0][None, cand]
        for col in cols[1:]:
            worse &= col[:, None] > col[None, cand]
        return worse.any(axis=1)

    order = np.argsort(s, kind="stable")
    running_min = np.minimum.accumulate(c[order])
    front2d = np.zeros(n, dtype=bool)
    front2d[order] = c[order] <= running_min
    dom = marked_by(np.flatnonzero(front2d))
    dom |= marked_by(np.flatnonzero(~dom))
    return dom


def prune_dominated(choices: List[PlanChoice]) -> List[PlanChoice]:
    """Drop candidates strictly worse than another on every axis a goal
    could care about — same predicate as the vectorized pipeline."""
    if not choices:
        return []
    step = np.asarray([c.est.step_s for c in choices])
    cost = np.asarray([c.est.cost_per_mtok for c in choices])
    hbm = np.asarray([c.est.hbm_frac for c in choices])
    price = np.asarray([c.slice.price_per_hour for c in choices])
    dom = _dominated(step, cost, hbm, price)
    return [c for c, d in zip(choices, dom) if not d]


# ===========================================================================
# Enumeration (both engines return the same candidates in the same order)
# ===========================================================================
def _materialize(table: CandidateTable, batch: BatchEstimate,
                 idx: np.ndarray) -> List[PlanChoice]:
    return [
        PlanChoice(table.slices[i], table.mesh_shapes[i], table.mesh_axes[i],
                   table.geometries[i], batch.estimate_at(i))
        for i in idx
    ]


def _enumerate_scalar(intent: ResourceIntent) -> List[PlanChoice]:
    """The pre-vectorization loop, kept verbatim as the parity oracle."""
    cfg = get_config(intent.arch)
    shape = get_shape(intent.shape)
    slices = CATALOG
    if intent.slice_name:
        slices = [find_slice(intent.slice_name)]
    choices: List[PlanChoice] = []
    for sl in slices:
        if intent.chip_generation and sl.chip.name != intent.chip_generation:
            continue
        if not intent.allow_multi_pod and sl.multi_pod:
            continue
        chips = sl.total_chips
        if intent.min_chips and chips < intent.min_chips:
            continue
        if intent.max_chips and chips > intent.max_chips:
            continue
        if intent.budget_usd_per_hour and sl.price_per_hour > intent.budget_usd_per_hour:
            continue
        for mesh_shape, mesh_axes in mesh_shapes_for(sl):
            if intent.mesh_shape and tuple(mesh_shape) != tuple(intent.mesh_shape):
                continue
            for geom in geometries_for(tuple(mesh_shape), tuple(mesh_axes),
                                       shape.kind, shape.global_batch):
                est = estimate(cfg, shape, sl, geom)
                if not est.feasible:
                    continue
                if intent.max_step_seconds and est.step_s > intent.max_step_seconds:
                    continue
                choices.append(PlanChoice(sl, tuple(mesh_shape),
                                          tuple(mesh_axes), geom, est))
    return choices


def _register_named_card(intent: ResourceIntent) -> None:
    """Naming the card registers its slices: the only way the card
    enters the catalog from a plan."""
    if names_card(intent.chip_generation, intent.slice_name):
        register_card()


def _check_engine(engine: str) -> None:
    if engine not in ("vectorized", "scalar"):
        raise ValueError(
            f"unknown engine {engine!r}; expected 'vectorized' or 'scalar'")


def enumerate_plans(intent: ResourceIntent, *,
                    engine: str = "vectorized") -> List[PlanChoice]:
    """All feasible candidates for an intent (unranked, unpruned)."""
    _check_engine(engine)
    intent.validate()
    _register_named_card(intent)
    if engine == "scalar":
        return _enumerate_scalar(intent)
    table, batch = _scored_table(intent.arch, intent.shape)
    mask = _constraint_mask(intent, table, batch)
    return _materialize(table, batch, np.flatnonzero(mask))


# ===========================================================================
# Ranking
# ===========================================================================
def _production_band(cost: float, cheapest: float) -> int:
    # ~2% relative cost bands anchored at the cheapest candidate — the
    # documented semantics (round(cost, 4) made the bands absolute)
    return int(round(cost / cheapest / 0.02)) if cheapest > 0 else 0


def rank(choices: List[PlanChoice], goal: str) -> List[PlanChoice]:
    if not choices:
        return []
    if goal == "exploration":
        return sorted(choices, key=lambda c: c.est.step_s)
    if goal == "quick_test":
        return sorted(choices, key=lambda c: (c.slice.price_per_hour, c.est.step_s))
    # production: cheapest $ per token (the paper's Fig. 4b criterion),
    # step time as tie-break within ~2% relative cost bands
    cheapest = min(c.est.cost_per_mtok for c in choices)
    return sorted(
        choices,
        key=lambda c: (_production_band(c.est.cost_per_mtok, cheapest),
                       c.est.step_s),
    )


def _rank_indices(table: CandidateTable, batch: BatchEstimate,
                  idx: np.ndarray, goal: str) -> np.ndarray:
    """`rank()` on table rows: stable lexsorts matching the list sort."""
    if len(idx) == 0:
        return idx
    step = batch.step_s[idx]
    if goal == "exploration":
        order = np.argsort(step, kind="stable")
    elif goal == "quick_test":
        order = np.lexsort((step, table.slice_price[idx]))
    else:
        cost = batch.cost_per_mtok[idx]
        cheapest = float(cost.min())
        if cheapest > 0:
            band = np.rint(cost / cheapest / 0.02).astype(np.int64)
        else:
            band = np.zeros(len(idx), dtype=np.int64)
        order = np.lexsort((step, band))
    return idx[order]


# ===========================================================================
# The public entry points
# ===========================================================================
def plan(intent: ResourceIntent, top_k: int = 5, *,
         engine: str = "vectorized") -> List[PlanChoice]:
    """Ranked feasible plans for an intent: enumerate → prune dominated →
    rank by goal → top_k.  The vectorized engine memoizes the ranked
    order per canonical intent hash; ``engine="scalar"`` runs the same
    pipeline through the scalar cost model (the parity oracle).

    Memo entries record the catalog generation.  A memoized intent whose
    generation went stale (the catalog gained slice types) is *refreshed*
    rather than discarded: the scored table extends with only the new
    rows (:func:`_scored_table`), and just the cheap mask/prune/rank
    pipeline re-runs — incremental re-planning, not a cold start.

    Entries are additionally salted by the active calibration's
    per-kind fingerprint: activating fitted coefficients for this
    intent's workload kind invalidates its memoized ranking (the plan
    was computed under different step_s), while intents of untouched
    kinds keep their memo hits."""
    _check_engine(engine)
    intent.validate()
    _register_named_card(intent)
    if engine == "scalar":
        return rank(prune_dominated(_enumerate_scalar(intent)),
                    intent.goal)[:top_k]
    PLANNER_STATS["plan_calls"] += 1
    key = intent_hash(intent)
    gen = catalog_generation()
    cal_state = calibrate.calibration_state(get_shape(intent.shape).kind)
    with _CACHE_LOCK:
        hit = _PLAN_CACHE.get(key)
    if hit is not None and hit[0] == gen and hit[1] == cal_state:
        PLANNER_STATS["memo_hits"] += 1
    else:
        PLANNER_STATS["stale_refreshes" if hit is not None
                      else "cold_ranks"] += 1
        table, batch = _scored_table(intent.arch, intent.shape)
        idx = np.flatnonzero(_constraint_mask(intent, table, batch))
        dom = _dominated(batch.step_s[idx], batch.cost_per_mtok[idx],
                         batch.hbm_frac[idx], table.slice_price[idx])
        idx = idx[~dom]
        ranked = _rank_indices(table, batch, idx, intent.goal)
        hit = (gen, cal_state, ranked, intent.arch, intent.shape)
        with _CACHE_LOCK:
            if key not in _PLAN_CACHE and len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
            _PLAN_CACHE[key] = hit
    _, _, ranked, arch, shape_name = hit
    table, batch = _scored_table(arch, shape_name)
    return _materialize(table, batch, ranked[:top_k])


def plan_stages(
    intents: "dict[str, ResourceIntent]",
) -> "dict[str, Optional[PlanChoice]]":
    """Resolve one PlanChoice per stage of a workflow graph.

    Each stage declares its own ResourceIntent (typically the workflow's
    main intent re-aimed at a stage-appropriate goal), and the planner
    runs an independent enumeration per *distinct* intent — a cheap
    data-prep stage planning ``quick_test`` lands on the smallest
    feasible slice while the train stage's ``production`` intent picks
    the throughput-efficient one.  Identical intents share one
    enumeration (and `plan()` itself memoizes ranked orders by intent
    hash across calls); stages with no feasible plan map to None.
    """
    cache: dict = {}
    out: "dict[str, Optional[PlanChoice]]" = {}
    for name in sorted(intents):
        intent = intents[name]
        if intent in cache:
            out[name] = cache[intent]
            continue
        ranked = plan(intent, top_k=1)
        cache[intent] = ranked[0] if ranked else None
        out[name] = cache[intent]
    return out


def to_runtime_plan(choice: PlanChoice, cfg=None, profile: str = "optimized"):
    """Convert a PlanChoice into the runtime
    :class:`repro_torch.parallel.Plan` consumed by the sharding/step
    layer: the reference's whole plan — data and FSDP axes from the mesh,
    FSDP, remat, microbatch and gradient compression from the geometry.

    ``profile="optimized"`` additionally encodes the reference's
    validated expertise: triangular flash attention everywhere (in the
    port ``attn_impl`` ``"tri"`` and ``"xla"`` both run K1),
    context-parallel attention when heads don't divide the model axis,
    the ``shard_map`` all-to-all MoE, and the chunked selective scan (the
    port trains the scan through K5-bwd's checkpointed adjoint whatever
    ``ssm_chunk`` says).
    """
    from repro_torch.parallel.sharding import Plan

    axes = choice.mesh_axes
    dims = dict(zip(axes, choice.mesh_shape))
    dp = tuple(a for a in ("pod", "data") if a in axes)
    kw = {}
    if profile == "optimized":
        kw["attn_impl"] = "tri"
        if cfg is not None:
            model_deg = dims.get("model", 1)
            if model_deg > 1 and cfg.num_heads % model_deg != 0:
                kw["seq_shard_attn"] = True
            if cfg.num_experts > 0:
                kw["moe_impl"] = "shard_map"
            if cfg.family in ("ssm", "hybrid"):
                kw["ssm_chunk"] = 16
    return Plan(
        name=f"{choice.slice.name}-{'x'.join(map(str, choice.mesh_shape))}",
        dp_axes=dp,
        fsdp_axes=dp,
        fsdp=choice.geometry.fsdp,
        remat=choice.geometry.remat,
        microbatch=choice.geometry.microbatch,
        compress_grads=choice.geometry.compress_grads,
        **kw,
    )
