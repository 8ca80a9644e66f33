"""Analytic roofline cost model: the planner's scoring function.

For a (model config × shape × slice × plan) cell it estimates the three
roofline terms the assignment defines —

    compute    = FLOPs / (chips × peak)
    memory     = HBM bytes / (chips × hbm_bw)
    collective = collective bytes / (chips × link_bw)

plus per-device memory occupancy (feasibility) and $ cost.  The dry-run
later *verifies* these against the compiled HLO (cost_analysis /
memory_analysis / collective parse) — the planner must be cheap because it
scores hundreds of candidates per intent, the compiler is the ground
truth for the chosen one.

A copy of the reference package's ``core/costmodel.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import calibrate
from repro_torch.core.catalog import CandidateTable, SliceType


@dataclasses.dataclass(frozen=True)
class PlanGeometry:
    """The parallel geometry the planner scores (mirror of parallel.Plan,
    decoupled so the cost model has no framework dependency)."""

    data: int = 1
    model: int = 1
    pods: int = 1
    fsdp: bool = True
    remat: str = "full"  # none | dots | full
    microbatch: int = 1
    compress_grads: bool = False

    @property
    def total(self) -> int:
        return self.data * self.model * self.pods

    @property
    def dp_total(self) -> int:
        return self.data * self.pods


@dataclasses.dataclass
class CostEstimate:
    compute_s: float
    memory_s: float
    collective_s: float
    step_s: float
    bytes_per_device: float
    hbm_frac: float
    cost_per_step: float
    cost_per_mtok: float  # $ per million tokens
    bottleneck: str
    feasible: bool
    detail: Dict[str, float]


BYTES = {"bfloat16": 2, "float32": 4, "int8": 1}


def _train_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """fwd+bwd FLOPs per step (model = 6·N_active·tokens + attention)."""
    tokens = shape.tokens_per_step
    base = 6.0 * cfg.active_param_count() * tokens
    # attention scores+values: fwd 4·B·S²·H·Dh (causal ÷2), bwd ×2
    S, B = shape.seq_len, shape.global_batch
    if cfg.family in ("ssm",):
        attn = 0.0
    else:
        w = cfg.sliding_window or S
        eff = min(S, w)
        attn = 3.0 * 4.0 * B * S * eff * cfg.num_heads * cfg.head_dim * 0.5
        attn *= cfg.num_layers
    return base + attn


def _decode_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B = shape.global_batch
    base = 2.0 * cfg.active_param_count() * B
    S = shape.seq_len
    if cfg.family == "ssm":
        attn = 0.0
    else:
        w = cfg.sliding_window or S
        ctx_local = min(S, w)
        n_global = len(cfg.global_attn_layers) if cfg.global_attn_layers else 0
        n_local = cfg.num_layers - n_global
        ctx = n_local * ctx_local + n_global * S if n_global else cfg.num_layers * ctx_local
        attn = 4.0 * B * ctx * cfg.num_heads * cfg.head_dim
    return base + attn


def _prefill_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    t = _train_flops(cfg, shape)
    return t / 3.0  # fwd only


def state_bytes(cfg: ModelConfig, geom: PlanGeometry, kind: str,
                moment_dtype: str = "float32") -> float:
    """Global bytes of persistent state (params + opt for train; params
    for serve)."""
    n = cfg.param_count()
    pb = n * BYTES["float32"]  # master params f32
    if kind != "train":
        return n * BYTES[cfg.dtype]
    mb = 2 * n * BYTES[moment_dtype]
    return pb + mb


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    B, S = shape.global_batch, shape.seq_len
    bt = BYTES[cfg.dtype]
    if cfg.family == "ssm":
        d_in = 2 * cfg.d_model
        dh = d_in // cfg.num_heads
        return cfg.num_layers * B * cfg.num_heads * dh * dh * 4.0
    per_layer_full = 2 * B * S * cfg.num_kv_heads * cfg.head_dim * bt
    if cfg.family == "hybrid" and cfg.sliding_window:
        W = min(cfg.sliding_window, S)
        n_global = len(cfg.global_attn_layers)
        n_local = cfg.num_layers - n_global
        per_layer_win = 2 * B * W * cfg.num_kv_heads * cfg.head_dim * bt
        ssm = cfg.num_layers * B * (2 * cfg.d_model) * cfg.ssm_state * 4.0
        return n_global * per_layer_full + n_local * per_layer_win + ssm
    total = cfg.num_layers * per_layer_full
    if cfg.is_encoder_decoder:
        total += 2 * cfg.num_layers * B * cfg.encoder_frames * cfg.num_kv_heads * cfg.head_dim * bt
    return total


def activation_bytes(cfg: ModelConfig, shape: ShapeConfig, geom: PlanGeometry) -> float:
    """Live activation bytes per device during train fwd+bwd (remat-aware,
    per-microbatch)."""
    if shape.kind != "train":
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            S = 1
        return B * S * cfg.d_model * BYTES[cfg.dtype] * 8 / geom.total
    B = shape.global_batch / max(geom.dp_total, 1) / max(geom.microbatch, 1)
    S = shape.seq_len
    bt = BYTES[cfg.dtype]
    d = cfg.d_model
    if geom.remat == "full":
        per_layer = B * S * d * bt  # only the block input is saved
        live = cfg.num_layers * per_layer + 4 * B * S * d * bt
    elif geom.remat == "dots":
        per_layer = 3 * B * S * d * bt
        live = cfg.num_layers * per_layer + 4 * B * S * d * bt
    else:
        ff = max(cfg.d_ff, d * 2)
        per_layer = (6 * d + 2 * ff) * B * S * bt / max(geom.model, 1) * 1.0
        live = cfg.num_layers * per_layer
    # logits are the spike for big-vocab models
    logits = B * S * cfg.vocab_size * 4.0 / max(geom.model, 1)
    return live / max(geom.model, 1) + logits


def collective_bytes(cfg: ModelConfig, shape: ShapeConfig, geom: PlanGeometry,
                     kind: str) -> Dict[str, float]:
    """Per-step global collective traffic by category (bytes summed over
    devices, ring-algorithm convention: volume ≈ 2·payload·(n-1)/n ≈ 2·payload)."""
    bt = BYTES[cfg.dtype]
    n = cfg.param_count()
    out: Dict[str, float] = {"tp_allreduce": 0.0, "dp_gradreduce": 0.0,
                             "fsdp_gather": 0.0, "ep_alltoall": 0.0,
                             "pod_gradreduce": 0.0}
    tokens = shape.tokens_per_step
    act = tokens * cfg.d_model * bt
    if geom.model > 1:
        # 2 allreduce per block fwd (attn out + mlp out), x3 for bwd
        nblocks = cfg.num_layers + (cfg.encoder_layers if cfg.is_encoder_decoder else 0)
        mult = 3.0 if kind == "train" else 1.0
        out["tp_allreduce"] = 2.0 * act * 2 * nblocks * mult
    if kind == "train":
        grad_bytes = n * BYTES["float32"]
        if geom.fsdp:
            # params all-gather fwd+bwd, grads reduce-scatter
            out["fsdp_gather"] = 2 * n * bt + grad_bytes
        if geom.dp_total > 1 and not geom.fsdp:
            out["dp_gradreduce"] = 2 * grad_bytes
        if geom.pods > 1:
            pod_bytes = 2 * grad_bytes / max(geom.data * geom.model, 1)
            if geom.compress_grads:
                pod_bytes /= 4.0  # int8 + scales
            out["pod_gradreduce"] = pod_bytes
    if cfg.num_experts > 0:
        disp = tokens * cfg.top_k * cfg.moe_capacity_factor * cfg.d_model * bt
        mult = 3.0 if kind == "train" else 1.0
        out["ep_alltoall"] = 2.0 * disp * cfg.num_layers * mult / max(1, 1)
    return out


def estimate(cfg: ModelConfig, shape: ShapeConfig, slice_: SliceType,
             geom: PlanGeometry, moment_dtype: str = "float32") -> CostEstimate:
    chip = slice_.chip
    chips = geom.total
    kind = shape.kind

    if kind == "train":
        flops = _train_flops(cfg, shape)
    elif kind == "prefill":
        flops = _prefill_flops(cfg, shape)
    else:
        flops = _decode_flops(cfg, shape)
    compute_s = flops / (chips * chip.peak_bf16_flops)

    # HBM traffic: weights stream once per microbatch (+opt update r/w in
    # train), activations once, kv cache read per decode step
    sbytes = state_bytes(cfg, geom, kind, moment_dtype)
    act = activation_bytes(cfg, shape, geom)
    if kind == "train":
        hbm = sbytes * 3.0 * geom.microbatch + act * chips
    elif kind == "prefill":
        hbm = cfg.param_count() * BYTES[cfg.dtype] + act * chips
    else:
        hbm = cfg.param_count() * BYTES[cfg.dtype] + kv_cache_bytes(cfg, shape)
    memory_s = hbm / (chips * chip.hbm_bw)

    colls = collective_bytes(cfg, shape, geom, kind)
    intra = sum(v for k, v in colls.items() if k != "pod_gradreduce")
    inter = colls["pod_gradreduce"]
    collective_s = intra / (chips * chip.ici_bw) + (
        inter / (chips * chip.dci_bw) if inter else 0.0
    )
    # latency floor: ring collectives cost ~2(n-1) hops regardless of size.
    # This is what makes over-provisioning small workloads lose — the real
    # phenomenon behind the paper's Table 2 efficiency collapse.
    HOP_ICI, HOP_DCI = 1e-6, 10e-6
    nblocks = cfg.num_layers + (cfg.encoder_layers if cfg.is_encoder_decoder else 0)
    n_ops = 0.0
    if geom.model > 1:
        n_ops += 4.0 * nblocks * (3.0 if kind == "train" else 1.0)
    if kind == "train" and (geom.fsdp or geom.dp_total > 1):
        n_ops += 2.0 * nblocks
    if cfg.num_experts > 0:
        n_ops += 2.0 * cfg.num_layers * (3.0 if kind == "train" else 1.0)
    ring = max(geom.data * geom.model, 2)
    collective_s += n_ops * 2 * (ring - 1) * HOP_ICI / max(geom.microbatch, 1) ** 0
    if geom.pods > 1 and kind == "train":
        collective_s += 2 * (geom.pods - 1) * HOP_DCI * 2 * nblocks

    # per-device occupancy
    dev_state = sbytes / chips
    dev_cache = kv_cache_bytes(cfg, shape) / chips if kind != "train" else 0.0
    dev_grads = cfg.param_count() * 4.0 / chips if kind == "train" else 0.0
    dev_act = act
    bytes_per_device = dev_state + dev_cache + dev_grads + dev_act
    hbm_frac = bytes_per_device / chip.hbm_bytes

    # roofline combine: dominant term with 15% tax for imperfect overlap;
    # when a calibration is active for this (chip, kind), its fitted
    # prediction replaces the combine (estimate_batch applies the exact
    # same CellCalibration.predict, preserving scalar/batch parity)
    cal = calibrate.active_cell(chip.name, kind)
    if cal is not None:
        step_s = float(cal.predict(compute_s, memory_s, collective_s))
    else:
        step_s = max(compute_s, memory_s, collective_s)
        step_s = step_s + 0.15 * (compute_s + memory_s + collective_s - step_s)

    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    price_s = slice_.chip.price_per_hour * chips / 3600.0
    cost_per_step = price_s * step_s
    tokens = shape.tokens_per_step
    cost_per_mtok = cost_per_step / max(tokens, 1) * 1e6
    feasible = hbm_frac <= 0.92 and chips == slice_.total_chips

    return CostEstimate(
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        step_s=step_s,
        bytes_per_device=bytes_per_device,
        hbm_frac=hbm_frac,
        cost_per_step=cost_per_step,
        cost_per_mtok=cost_per_mtok,
        bottleneck=bottleneck,
        feasible=feasible,
        detail={**terms, **colls, "flops": flops, "hbm_bytes": hbm},
    )


# ===========================================================================
# Batched estimation over a CandidateTable — the vectorized planner hot
# path.  The scalar `estimate()` above stays the parity oracle: every
# formula here mirrors it operation-for-operation on whole float64
# columns, so the two agree bit-for-bit per cell.
# ===========================================================================
BOTTLENECK_NAMES = ("compute", "memory", "collective")


@dataclasses.dataclass(frozen=True)
class BatchEstimate:
    """Columnar CostEstimate: one float64 entry per CandidateTable row."""

    compute_s: np.ndarray
    memory_s: np.ndarray
    collective_s: np.ndarray
    step_s: np.ndarray
    bytes_per_device: np.ndarray
    hbm_frac: np.ndarray
    cost_per_step: np.ndarray
    cost_per_mtok: np.ndarray
    bottleneck_code: np.ndarray  # index into BOTTLENECK_NAMES
    feasible: np.ndarray         # bool
    colls: Dict[str, np.ndarray]
    flops: float
    hbm: np.ndarray

    def __len__(self) -> int:
        return len(self.step_s)

    def estimate_at(self, i: int) -> CostEstimate:
        """Materialize one row as the scalar CostEstimate `estimate()`
        would have returned for the same cell."""
        terms = {
            "compute": float(self.compute_s[i]),
            "memory": float(self.memory_s[i]),
            "collective": float(self.collective_s[i]),
        }
        return CostEstimate(
            compute_s=terms["compute"],
            memory_s=terms["memory"],
            collective_s=terms["collective"],
            step_s=float(self.step_s[i]),
            bytes_per_device=float(self.bytes_per_device[i]),
            hbm_frac=float(self.hbm_frac[i]),
            cost_per_step=float(self.cost_per_step[i]),
            cost_per_mtok=float(self.cost_per_mtok[i]),
            bottleneck=BOTTLENECK_NAMES[int(self.bottleneck_code[i])],
            feasible=bool(self.feasible[i]),
            detail={**terms,
                    **{k: float(v[i]) for k, v in self.colls.items()},
                    "flops": self.flops, "hbm_bytes": float(self.hbm[i])},
        )


def _activation_bytes_batch(cfg: ModelConfig, shape: ShapeConfig,
                            table: CandidateTable) -> np.ndarray:
    if shape.kind != "train":
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            S = 1
        return B * S * cfg.d_model * BYTES[cfg.dtype] * 8 / table.chips
    dp_total = np.maximum(table.data * table.pods, 1)
    B = shape.global_batch / dp_total / np.maximum(table.microbatch, 1)
    S = shape.seq_len
    bt = BYTES[cfg.dtype]
    d = cfg.d_model
    model = np.maximum(table.model, 1)
    live_full = cfg.num_layers * (B * S * d * bt) + 4 * B * S * d * bt
    live_dots = cfg.num_layers * (3 * B * S * d * bt) + 4 * B * S * d * bt
    ff = max(cfg.d_ff, d * 2)
    live_none = cfg.num_layers * ((6 * d + 2 * ff) * B * S * bt / model * 1.0)
    live = np.where(table.remat_code == 2, live_full,
                    np.where(table.remat_code == 1, live_dots, live_none))
    logits = B * S * cfg.vocab_size * 4.0 / model
    return live / model + logits


def _collective_bytes_batch(cfg: ModelConfig, shape: ShapeConfig,
                            table: CandidateTable,
                            kind: str) -> Dict[str, np.ndarray]:
    bt = BYTES[cfg.dtype]
    n = cfg.param_count()
    z = np.zeros(len(table))
    out = {"tp_allreduce": z, "dp_gradreduce": z, "fsdp_gather": z,
           "ep_alltoall": z, "pod_gradreduce": z}
    tokens = shape.tokens_per_step
    act = tokens * cfg.d_model * bt
    nblocks = cfg.num_layers + (cfg.encoder_layers if cfg.is_encoder_decoder else 0)
    mult = 3.0 if kind == "train" else 1.0
    out["tp_allreduce"] = np.where(table.model > 1,
                                   2.0 * act * 2 * nblocks * mult, 0.0)
    if kind == "train":
        grad_bytes = n * BYTES["float32"]
        out["fsdp_gather"] = np.where(table.fsdp, 2 * n * bt + grad_bytes, 0.0)
        out["dp_gradreduce"] = np.where(
            (table.data * table.pods > 1) & ~table.fsdp, 2 * grad_bytes, 0.0)
        pod_bytes = 2 * grad_bytes / np.maximum(table.data * table.model, 1)
        pod_bytes = np.where(table.compress, pod_bytes / 4.0, pod_bytes)
        out["pod_gradreduce"] = np.where(table.pods > 1, pod_bytes, 0.0)
    if cfg.num_experts > 0:
        disp = tokens * cfg.top_k * cfg.moe_capacity_factor * cfg.d_model * bt
        out["ep_alltoall"] = np.full(
            len(table), 2.0 * disp * cfg.num_layers * mult / max(1, 1))
    return out


# Instrumentation: how much scoring work the process has done.  The
# incremental re-planning tests assert on these — adding a slice type to
# the catalog must re-score only the new rows, so ``rows_scored`` is the
# observable that proves memoized intents were extended, not rebuilt.
SCORING_STATS: Dict[str, int] = {"batch_calls": 0, "rows_scored": 0}


def reset_scoring_stats() -> None:
    SCORING_STATS["batch_calls"] = 0
    SCORING_STATS["rows_scored"] = 0


def estimate_batch(cfg: ModelConfig, shape: ShapeConfig,
                   table: CandidateTable,
                   moment_dtype: str = "float32") -> BatchEstimate:
    """`estimate()` over every row of a CandidateTable at once."""
    SCORING_STATS["batch_calls"] += 1
    SCORING_STATS["rows_scored"] += len(table)
    kind = shape.kind
    if kind == "train":
        flops = _train_flops(cfg, shape)
    elif kind == "prefill":
        flops = _prefill_flops(cfg, shape)
    else:
        flops = _decode_flops(cfg, shape)
    compute_s = flops / (table.chips * table.peak_flops)

    sbytes = state_bytes(cfg, PlanGeometry(), kind, moment_dtype)
    act = _activation_bytes_batch(cfg, shape, table)
    if kind == "train":
        hbm = sbytes * 3.0 * table.microbatch + act * table.chips
    elif kind == "prefill":
        hbm = cfg.param_count() * BYTES[cfg.dtype] + act * table.chips
    else:
        hbm = np.broadcast_to(np.float64(
            cfg.param_count() * BYTES[cfg.dtype] + kv_cache_bytes(cfg, shape)
        ), (len(table),))
    memory_s = hbm / (table.chips * table.hbm_bw)

    colls = _collective_bytes_batch(cfg, shape, table, kind)
    intra = (colls["tp_allreduce"] + colls["dp_gradreduce"]
             + colls["fsdp_gather"] + colls["ep_alltoall"])
    inter = colls["pod_gradreduce"]
    collective_s = intra / (table.chips * table.ici_bw) + np.where(
        inter != 0, inter / (table.chips * table.dci_bw), 0.0)
    HOP_ICI, HOP_DCI = 1e-6, 10e-6
    nblocks = cfg.num_layers + (cfg.encoder_layers if cfg.is_encoder_decoder else 0)
    kmult = 3.0 if kind == "train" else 1.0
    n_ops = np.zeros(len(table))
    n_ops = n_ops + np.where(table.model > 1, 4.0 * nblocks * kmult, 0.0)
    if kind == "train":
        n_ops = n_ops + np.where(table.fsdp | (table.data * table.pods > 1),
                                 2.0 * nblocks, 0.0)
    if cfg.num_experts > 0:
        n_ops = n_ops + 2.0 * cfg.num_layers * kmult
    ring = np.maximum(table.data * table.model, 2)
    collective_s = collective_s + n_ops * 2 * (ring - 1) * HOP_ICI
    if kind == "train":
        collective_s = collective_s + np.where(
            table.pods > 1, 2 * (table.pods - 1) * HOP_DCI * 2 * nblocks, 0.0)

    dev_state = sbytes / table.chips
    dev_cache = (kv_cache_bytes(cfg, shape) / table.chips
                 if kind != "train" else 0.0)
    dev_grads = (cfg.param_count() * 4.0 / table.chips
                 if kind == "train" else 0.0)
    bytes_per_device = dev_state + dev_cache + dev_grads + act
    hbm_frac = bytes_per_device / table.hbm_bytes

    peak = np.maximum(np.maximum(compute_s, memory_s), collective_s)
    step_s = peak + 0.15 * (compute_s + memory_s + collective_s - peak)
    cal_map = calibrate.active_for_kind(kind)
    if cal_map:
        # per-row calibrated override, chip by chip — the same
        # CellCalibration.predict the scalar oracle applies, elementwise
        chip_names = np.asarray([s.chip.name for s in table.slices])
        for name in sorted(cal_map):
            row_mask = chip_names == name
            if row_mask.any():
                pred = cal_map[name].predict(compute_s, memory_s,
                                             collective_s)
                step_s = np.where(row_mask, pred, step_s)
    bottleneck_code = np.argmax(
        np.stack([compute_s, memory_s, collective_s]), axis=0)
    price_s = table.chip_price * table.chips / 3600.0
    cost_per_step = price_s * step_s
    tokens = shape.tokens_per_step
    cost_per_mtok = cost_per_step / max(tokens, 1) * 1e6
    # chips == slice.total_chips holds by construction (mesh shapes always
    # multiply out to the slice size), so feasibility is the HBM gate alone
    feasible = hbm_frac <= 0.92

    return BatchEstimate(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        step_s=step_s, bytes_per_device=bytes_per_device, hbm_frac=hbm_frac,
        cost_per_step=cost_per_step, cost_per_mtok=cost_per_mtok,
        bottleneck_code=bottleneck_code, feasible=feasible,
        colls=colls, flops=flops, hbm=np.asarray(hbm, dtype=np.float64),
    )


def concat_batches(a: BatchEstimate, b: BatchEstimate) -> BatchEstimate:
    """Row-wise concatenation of two BatchEstimates over the same
    workload — how a memoized scored table absorbs the rows a catalog
    extension added without re-scoring its prefix."""
    def cat(x, y):
        return np.concatenate([np.atleast_1d(np.asarray(x)),
                               np.atleast_1d(np.asarray(y))])

    return BatchEstimate(
        compute_s=cat(a.compute_s, b.compute_s),
        memory_s=cat(a.memory_s, b.memory_s),
        collective_s=cat(a.collective_s, b.collective_s),
        step_s=cat(a.step_s, b.step_s),
        bytes_per_device=cat(a.bytes_per_device, b.bytes_per_device),
        hbm_frac=cat(a.hbm_frac, b.hbm_frac),
        cost_per_step=cat(a.cost_per_step, b.cost_per_step),
        cost_per_mtok=cat(a.cost_per_mtok, b.cost_per_mtok),
        bottleneck_code=cat(a.bottleneck_code, b.bottleneck_code),
        feasible=cat(a.feasible, b.feasible).astype(bool),
        colls={k: cat(a.colls[k], b.colls[k]) for k in a.colls},
        flops=a.flops,
        hbm=cat(a.hbm, b.hbm),
    )


# ===========================================================================
# Retry-aware expected cost — folding preemption rates and restart
# backoff budgets into a plan's $ projection (docs/cost-model.md has the
# derivation; tests assert monotonicity in the failure rate).
# ===========================================================================
@dataclasses.dataclass(frozen=True)
class RetryCost:
    """Expected-cost projection for a run under preemptions + restarts.

    ``expected_cost_usd`` is the billed projection (failure-free cost
    plus re-done work); ``expected_hours`` is the wall-clock projection
    (billed hours plus restart backoff, which is waited but not billed —
    the slice is gone while we back off)."""

    base_cost_usd: float        # failure-free: steps × cost_per_step
    expected_cost_usd: float    # base + expected re-done work
    expected_cost_per_mtok: float
    run_hours: float            # failure-free duration
    expected_hours: float       # run + wasted + backoff (wall clock)
    expected_failures: float    # Poisson mean, capped at max_restarts
    backoff_s: float            # expected total restart backoff
    failure_rate_per_hour: float  # slice-level rate (per-chip rate × chips)


def retry_expected_cost(est: CostEstimate, slice_: SliceType, steps: int,
                        preempt_rate_per_chip_hour: float = 0.0,
                        policy=None,
                        restore_frac: float = 0.5) -> RetryCost:
    """Fold a preemption rate and a :class:`~repro_torch.ft.failures.RestartPolicy`
    into a plan's cost projection.

    Model: preemptions arrive Poisson at ``rate × total_chips`` per hour
    (bigger slices expose more failure domains), so a run of
    failure-free duration ``T`` expects ``E = min(λ·T, max_restarts)``
    failures.  The ``E`` failures split the run into ``E + 1`` segments;
    with checkpoint-restart, each failure re-does ``restore_frac`` of
    its segment on average, so the expected wasted (and billed) time is
    ``E/(E+1) · restore_frac · T`` — bounded by ``restore_frac · T``
    however unreliable the fleet gets.  Backoff between restarts
    (:meth:`RestartPolicy.expected_total_backoff_s`) extends the wall
    clock but is not billed.  Every term is monotone non-decreasing in
    the preemption rate.
    """
    run_hours = steps * est.step_s / 3600.0
    base_cost = steps * est.cost_per_step
    lam = preempt_rate_per_chip_hour * slice_.total_chips
    expected_failures = lam * run_hours
    if policy is not None:
        expected_failures = min(expected_failures,
                                float(policy.max_restarts))
    waste_frac = (expected_failures / (expected_failures + 1.0)
                  * restore_frac)
    wasted_hours = waste_frac * run_hours
    billed_hours = run_hours + wasted_hours
    expected_cost = base_cost * (1.0 + waste_frac)
    backoff_s = (policy.expected_total_backoff_s(expected_failures)
                 if policy is not None else 0.0)
    scale = expected_cost / base_cost if base_cost > 0 else 1.0
    return RetryCost(
        base_cost_usd=base_cost,
        expected_cost_usd=expected_cost,
        expected_cost_per_mtok=est.cost_per_mtok * scale,
        run_hours=run_hours,
        expected_hours=billed_hours + backoff_s / 3600.0,
        expected_failures=expected_failures,
        backoff_s=backoff_s,
        failure_rate_per_hour=lam,
    )
