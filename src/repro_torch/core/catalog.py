"""Resource catalog: the TPU-fleet analogue of the EC2 instance-type list.

The paper's Fig. 1 motivates Adviser with the explosion of instance
choices (1000+ EC2 types).  A TPU fleet has the same shape of problem:
chip generations × slice sizes × single/multi-pod topologies.  The catalog
is the planner's search space; prices are representative on-demand
$/chip-hour (documented here, relative comparisons are what matter — the
paper's Fig. 4 argument).

Chip generations play the role of the paper's m6a → m7a → m8a sweep.

A copy of the reference package's ``core/catalog.py``; ``CHIPS`` is
unchanged, so the default catalog and every default plan equal the
reference's.  The port adds one card, the NVIDIA H100 (:data:`H100`), in
:data:`CARDS`: its slices (one card, one 8-card node) join the catalog
only through an explicit registration, :func:`register_card` (which the
planner calls for an intent that names the card) or a provider offer
(:mod:`repro_torch.core.registry`).  Registration bumps the catalog
generation as any :func:`register_slice` does.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_bf16_flops: float  # FLOP/s
    hbm_bytes: float
    hbm_bw: float  # B/s
    ici_bw: float  # B/s per chip (intra-pod link)
    dci_bw: float  # B/s per chip (cross-pod)
    price_per_hour: float  # $/chip-hour (representative)
    max_pod_chips: int


# v5e is the assignment's target (197 TF bf16 / 819 GB/s HBM / 50 GB/s ICI).
CHIPS: Dict[str, ChipSpec] = {
    "v4": ChipSpec("v4", 275e12, 32e9, 1228e9, 45e9, 12e9, 3.22, 1024 * 2),
    "v5e": ChipSpec("v5e", 197e12, 16e9, 819e9, 50e9, 12.5e9, 1.20, 256),
    "v5p": ChipSpec("v5p", 459e12, 95e9, 2765e9, 90e9, 25e9, 4.20, 1024 * 8),
}

# The NVIDIA H100 SXM 80GB, from its published figures: 989.4e12 dense
# bf16 FLOP/s, 80 GB of HBM3 at 3.35e12 B/s, NVLink 4 at 450e9 B/s a
# direction inside a node, one 400 Gb/s NIC a GPU across nodes (50e9
# B/s), 8 GPUs a node.  Price: AWS EC2 p5.48xlarge (8x H100 SXM 80GB),
# us-east-1, on-demand, $98.32 an instance-hour on AWS's 2024 price list,
# so $12.29 a GPU-hour.
H100 = ChipSpec("h100", 989.4e12, 80e9, 3.35e12, 450e9, 50e9, 12.29, 8)

# Cards the catalog can take beyond CHIPS, by generation name.  Not in
# CHIPS, so build_catalog() and the default plans stay the reference's.
CARDS: Dict[str, ChipSpec] = {"h100": H100}
# the card's slices: one card, and one node of max_pod_chips cards
CARD_SLICE_SIZES = (1, 8)


@dataclasses.dataclass(frozen=True)
class SliceType:
    """One launchable option: a slice of a chip generation, possibly
    spanning pods."""

    name: str
    chip: ChipSpec
    chips_per_pod: int
    num_pods: int

    @property
    def total_chips(self) -> int:
        return self.chips_per_pod * self.num_pods

    @property
    def price_per_hour(self) -> float:
        return self.total_chips * self.chip.price_per_hour

    @property
    def multi_pod(self) -> bool:
        return self.num_pods > 1


def build_catalog() -> List[SliceType]:
    out: List[SliceType] = []
    for chip in CHIPS.values():
        size = 4
        while size <= chip.max_pod_chips:
            out.append(SliceType(f"{chip.name}-{size}", chip, size, 1))
            size *= 2
        # multi-pod assemblies of the largest pod
        for pods in (2, 4, 8):
            size = chip.max_pod_chips
            out.append(
                SliceType(f"{pods}x{chip.name}-{size}", chip, size, pods)
            )
    return out


CATALOG: List[SliceType] = build_catalog()

# Catalog generation: bumped on every mutation of CATALOG so downstream
# caches (candidate tables, the planner's scored tables and ranked-order
# memo) can detect growth and re-score *incrementally* instead of
# invalidating wholesale — the "fleet gained a slice type" path.
_GENERATION = 1
_CATALOG_LOCK = threading.Lock()


def catalog_generation() -> int:
    """Monotonic counter identifying the current CATALOG contents."""
    return _GENERATION


def register_slice(slice_: SliceType) -> SliceType:
    """Append a new slice type to the live catalog (bumps the generation).

    Appending — never inserting — keeps every existing candidate-table
    row index valid, which is what lets the planner extend its scored
    tables with just the new slice's rows (see
    :func:`repro_torch.core.planner.plan`)."""
    global _GENERATION
    with _CATALOG_LOCK:
        if any(s.name == slice_.name for s in CATALOG):
            raise ValueError(f"slice {slice_.name!r} already in catalog")
        CATALOG.append(slice_)
        _GENERATION += 1
    return slice_


def unregister_slice(name: str) -> SliceType:
    """Remove a slice type by name (bumps the generation; downstream
    caches detect the non-append mutation and rebuild from scratch)."""
    global _GENERATION
    with _CATALOG_LOCK:
        for i, s in enumerate(CATALOG):
            if s.name == name:
                del CATALOG[i]
                _GENERATION += 1
                return s
    raise KeyError(f"unknown slice {name!r}; have {[s.name for s in CATALOG]}")


def chip_spec(name: str) -> ChipSpec:
    """A chip generation by name: a TPU of ``CHIPS`` or a card of
    ``CARDS``."""
    if name in CHIPS:
        return CHIPS[name]
    if name in CARDS:
        return CARDS[name]
    raise KeyError(f"unknown chip {name!r}; have {sorted({**CHIPS, **CARDS})}")


def card_slices() -> List[SliceType]:
    """The card's slice types (``h100-1``, ``h100-8``), not registered."""
    return [SliceType(f"{H100.name}-{n}", H100, n, 1)
            for n in CARD_SLICE_SIZES]


_CARD_LOCK = threading.Lock()


def register_card() -> List[SliceType]:
    """Register the card's slices that are not in the catalog yet (one
    generation bump each); returns the card's slices as the catalog holds
    them.  Safe to call from concurrent planner threads."""
    with _CARD_LOCK:
        have = {s.name: s for s in CATALOG}
        return [have.get(sl.name) or register_slice(sl)
                for sl in card_slices()]


def unregister_card() -> List[SliceType]:
    """Withdraw the card's slices from the catalog (those registered by
    :func:`register_card`; a provider's ``<id>/h100-n`` offers stay)."""
    with _CARD_LOCK:
        names = {s.name for s in CATALOG}
        return [unregister_slice(sl.name) for sl in card_slices()
                if sl.name in names]


def names_card(chip_generation: Optional[str],
               slice_name: Optional[str]) -> bool:
    """Whether an intent names the card: by its chip generation or by one
    of the card's slice names."""
    return (chip_generation == H100.name
            or slice_name in {s.name for s in card_slices()})


def chip_generations() -> List[str]:
    """The chip generations the catalog holds slices of: ``CHIPS`` in
    order, then any registered card."""
    present = {s.chip.name for s in CATALOG}
    return list(CHIPS) + [n for n in CARDS if n in present]


def find_slice(name: str) -> SliceType:
    for s in CATALOG:
        if s.name == name:
            return s
    raise KeyError(f"unknown slice {name!r}; have {[s.name for s in CATALOG]}")


def mesh_shapes_for(slice_: SliceType) -> List[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """Candidate (shape, axis-names) meshes for a slice: the planner's
    data/model split search space."""
    n = slice_.chips_per_pod
    out = []
    model = 1
    while model <= n:
        data = n // model
        if data * model == n and data >= 1:
            if slice_.num_pods > 1:
                out.append(
                    ((slice_.num_pods, data, model), ("pod", "data", "model"))
                )
            else:
                out.append(((data, model), ("data", "model")))
        model *= 2
    return out


def catalog_summary() -> Dict[str, int]:
    return {
        "total_options": len(CATALOG),
        "chip_generations": len(CHIPS),
        "multi_pod_options": sum(1 for s in CATALOG if s.multi_pod),
    }


# ===========================================================================
# Vectorized candidate table — the planner hot path's search space,
# materialized once as structure-of-arrays
# ===========================================================================
REMAT_CODES = {"none": 0, "dots": 1, "full": 2}


def geometries_for(mesh_shape: Tuple[int, ...], mesh_axes: Tuple[str, ...],
                   kind: str, global_batch: int) -> list:
    """Candidate PlanGeometry list for one mesh: the (remat × microbatch)
    grid the planner scores.  Single source of truth for both the scalar
    enumeration loop and the vectorized candidate table, so the two
    engines visit identical rows in identical order (stable sorts then
    agree bit-for-bit on ranking)."""
    from repro_torch.core.costmodel import PlanGeometry

    dims = dict(zip(mesh_axes, mesh_shape))
    pods = dims.get("pod", 1)
    data = dims.get("data", 1)
    model = dims.get("model", 1)
    out = []
    remats = ("dots", "full", "none") if kind == "train" else ("none",)
    ubatches = (1, 2, 4) if kind == "train" else (1,)
    for remat in remats:
        for ub in ubatches:
            if global_batch % max(data * pods * ub, 1) != 0:
                continue
            out.append(PlanGeometry(
                data=data, model=model, pods=pods,
                fsdp=True, remat=remat, microbatch=ub,
            ))
    return out or [PlanGeometry(data=data, model=model, pods=pods)]


@dataclasses.dataclass(frozen=True)
class CandidateTable:
    """Structure-of-arrays view of every (slice × mesh × geometry) cell.

    One row per candidate the planner scores.  Object columns (``slices``,
    ``mesh_shapes``, ``mesh_axes``, ``geometries``) carry each row's
    identity for materializing PlanChoices; the numeric columns are
    parallel NumPy arrays consumed by :func:`costmodel.estimate_batch`.
    Row order matches the scalar enumeration loop (CATALOG order ×
    ``mesh_shapes_for`` order × ``geometries_for`` order).
    """

    slices: tuple            # row -> SliceType
    mesh_shapes: tuple       # row -> Tuple[int, ...]
    mesh_axes: tuple         # row -> Tuple[str, ...]
    geometries: tuple        # row -> PlanGeometry
    slice_idx: "np.ndarray"  # row -> index into CATALOG
    chips: "np.ndarray"
    data: "np.ndarray"
    model: "np.ndarray"
    pods: "np.ndarray"
    microbatch: "np.ndarray"
    remat_code: "np.ndarray"
    fsdp: "np.ndarray"
    compress: "np.ndarray"
    peak_flops: "np.ndarray"
    hbm_bytes: "np.ndarray"
    hbm_bw: "np.ndarray"
    ici_bw: "np.ndarray"
    dci_bw: "np.ndarray"
    chip_price: "np.ndarray"   # $/chip-hour
    slice_price: "np.ndarray"  # $/slice-hour
    multi_pod: "np.ndarray"

    def __len__(self) -> int:
        return len(self.slices)


def _build_table(slices: List[SliceType], si_offset: int, kind: str,
                 global_batch: int) -> CandidateTable:
    """Materialize (slice, mesh_shape, geometry) cells for ``slices`` as
    arrays; ``si_offset`` is the CATALOG index of ``slices[0]`` so
    ``slice_idx`` stays a valid index into the full catalog when a table
    extension is built for newly registered slices only."""
    sl_rows: List[SliceType] = []
    mesh_rows: List[Tuple[int, ...]] = []
    axes_rows: List[Tuple[str, ...]] = []
    geom_rows: List = []
    # per-slice numeric columns, expanded to rows with np.repeat below
    counts: List[int] = []
    slice_num: List[Tuple] = []
    # per-geometry numeric columns (one 7-tuple per row)
    geom_num: List[Tuple] = []
    for si, sl in enumerate(slices, start=si_offset):
        n_before = len(geom_rows)
        for mesh_shape, mesh_axes in mesh_shapes_for(sl):
            mesh_shape, mesh_axes = tuple(mesh_shape), tuple(mesh_axes)
            for geom in geometries_for(mesh_shape, mesh_axes,
                                       kind, global_batch):
                sl_rows.append(sl)
                mesh_rows.append(mesh_shape)
                axes_rows.append(mesh_axes)
                geom_rows.append(geom)
                geom_num.append((geom.total, geom.data, geom.model,
                                 geom.pods, geom.microbatch,
                                 REMAT_CODES[geom.remat], geom.fsdp,
                                 geom.compress_grads))
        counts.append(len(geom_rows) - n_before)
        c = sl.chip
        slice_num.append((si, c.peak_bf16_flops, c.hbm_bytes, c.hbm_bw,
                          c.ici_bw, c.dci_bw, c.price_per_hour,
                          sl.price_per_hour, sl.multi_pod))
    if not geom_rows:
        gcols = np.zeros((8, 0), dtype=np.int64)
        scols = np.zeros((9, 0), dtype=np.float64)
    else:
        gcols = np.asarray(geom_num, dtype=np.int64).T
        scols = np.repeat(np.asarray(slice_num, dtype=np.float64),
                          counts, axis=0).T
    return CandidateTable(
        slices=tuple(sl_rows),
        mesh_shapes=tuple(mesh_rows),
        mesh_axes=tuple(axes_rows),
        geometries=tuple(geom_rows),
        slice_idx=scols[0].astype(np.int64),
        chips=gcols[0],
        data=gcols[1],
        model=gcols[2],
        pods=gcols[3],
        microbatch=gcols[4],
        remat_code=gcols[5],
        fsdp=gcols[6].astype(bool),
        compress=gcols[7].astype(bool),
        peak_flops=scols[1],
        hbm_bytes=scols[2],
        hbm_bw=scols[3],
        ici_bw=scols[4],
        dci_bw=scols[5],
        chip_price=scols[6],
        slice_price=scols[7],
        multi_pod=scols[8].astype(bool),
    )


def concat_tables(a: CandidateTable, b: CandidateTable) -> CandidateTable:
    """Row-wise concatenation — how a cached table absorbs the rows of
    newly registered slices without rebuilding its prefix."""
    def cat(fa, fb):
        if isinstance(fa, tuple):
            return fa + fb
        return np.concatenate([fa, fb])

    return CandidateTable(**{
        f.name: cat(getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(CandidateTable)
    })


def table_rows(table: CandidateTable, start: int,
               stop: Optional[int] = None) -> CandidateTable:
    """The sub-table of rows ``start:stop`` (used to score just the rows
    a catalog extension added)."""
    sl = slice(start, stop)
    return CandidateTable(**{
        f.name: getattr(table, f.name)[sl]
        for f in dataclasses.fields(CandidateTable)
    })


# (kind, global_batch) -> (generation, catalog-snapshot, table).  On an
# append-only catalog change the cached table is *extended* with the new
# slices' rows (row order still matches the scalar enumeration, which
# walks CATALOG in order); any other mutation rebuilds from scratch.
_TABLE_CACHE: Dict[Tuple[str, int],
                   Tuple[int, Tuple[SliceType, ...], CandidateTable]] = {}
_TABLE_CACHE_MAX = 64  # FIFO bound (matches the old lru_cache maxsize)
_TABLE_LOCK = threading.Lock()


def candidate_table(kind: str, global_batch: int) -> CandidateTable:
    """Materialize all (slice, mesh_shape, geometry) cells as arrays.

    The candidate grid depends on the workload only through
    ``(kind, global_batch)`` — remat/microbatch options come from the
    kind, microbatch divisibility from the global batch — so one table
    serves every (config, shape) with that signature.  Tables are cached
    per catalog generation: when the catalog *grows*
    (:func:`register_slice`), only the new slices' rows are built and
    appended; any other mutation rebuilds from scratch.
    """
    key = (kind, global_batch)
    with _TABLE_LOCK:
        gen = _GENERATION
        catalog = tuple(CATALOG)
        hit = _TABLE_CACHE.get(key)
    if hit is not None:
        hit_gen, snap, table = hit
        if hit_gen == gen:
            return table
        if (len(catalog) > len(snap)
                and all(catalog[i] is snap[i] for i in range(len(snap)))):
            ext = _build_table(list(catalog[len(snap):]), len(snap), kind,
                               global_batch)
            table = concat_tables(table, ext)
            _table_cache_put(key, (gen, catalog, table))
            return table
    table = _build_table(list(catalog), 0, kind, global_batch)
    _table_cache_put(key, (gen, catalog, table))
    return table


def _table_cache_put(key, entry) -> None:
    with _TABLE_LOCK:
        if key not in _TABLE_CACHE and len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
            _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
        _TABLE_CACHE[key] = entry


def _table_cache_clear() -> None:
    with _TABLE_LOCK:
        _TABLE_CACHE.clear()


# benchmarks/tests call candidate_table.cache_clear() (the old lru_cache
# spelling); keep that interface on the generation-aware cache
candidate_table.cache_clear = _table_cache_clear
