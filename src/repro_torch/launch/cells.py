"""Cell building and counting: the step of one (architecture × shape ×
mesh × plan) assignment cell, and its per-rank counts.

Counterpart of the reference package's ``launch/cells.py``, shared by
the dry-run (``launch/dryrun.py``) and the perf-iteration loop
(``launch/hillclimb.py``).  Where the reference lowers and compiles the
cell's jitted step and reads XLA's ``memory_analysis``,
``cost_analysis`` and partitioned HLO, :func:`analyze_cell` runs the
port's own step once on fake tensors of one rank's local blocks
(``FakeTensorMode``) under :class:`~repro_torch.launch.op_stats.
OpCounter`, on the mesh's (fake) world: the counter's FLOPs, bytes,
collectives and live-memory peak stand in for XLA's.

Train cells go through ``make_train_artifacts`` (the sharded step).
Prefill and decode cells take bf16 parameters and go through
``serve/sharded.py``'s ``make_serve_artifacts`` on any mesh, as the
reference lays them out: the parameters by ``make_param_shardings``
(their ``model`` dims — heads, MLP, vocab, the MoE's experts — and FSDP
over the data axes, gathered a layer at a time except the dims the
split keeps), the batch over the data axes, the cache by ``cache_spec``
(its K/V sequence over ``model``, every other leaf by its batch), the
step split over ``model`` (the xLSTM's gathered whole and repeated on
each ``model`` rank).  The ``long_500k`` cells of hymba and the xLSTM,
whose layout splits their states over ``model``, are refused (ROADMAP,
"sharded serving cells").
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import get_config, get_shape, shape_applicable
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import op_stats
from repro_torch.models.api import Model
from repro_torch.parallel.sharding import Plan, batch_specs
from repro_torch.serve.sharded import make_serve_artifacts
from repro_torch.train import OptimizerConfig, make_train_artifacts
from repro_torch.tree import Tree, tree_map


def default_plan(cfg: ModelConfig, mesh, *, remat: str = "full",
                 microbatch: int = 1, **kw) -> Plan:
    dp = tuple(a for a in ("pod", "data") if a in mesh.shape)
    return Plan(
        name="baseline",
        dp_axes=dp,
        fsdp_axes=dp,
        remat=remat,
        microbatch=microbatch,
        **kw,
    )


@dataclasses.dataclass
class LoweredCell:
    arch: str
    shape: str
    mesh_desc: str
    kind: str
    fn: Callable  # the step (called once on fake local blocks)
    args: Tuple  # meta-tensor trees of the global arguments
    plan: Plan
    shardings: Tuple = ()  # the layout trees of ``args``


def build_cell(arch: str, shape_name: str, mesh,
               plan: Optional[Plan] = None,
               opt_cfg: Optional[OptimizerConfig] = None, *,
               cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeConfig] = None) -> LoweredCell:
    """The cell's step and its arguments' specs and layouts.  ``cfg`` and
    ``shape`` replace the registry's (a reduced config, a smaller
    shape)."""
    cfg = cfg or get_config(arch)
    shape = shape or get_shape(shape_name)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} × {shape_name}: {why}")
    model = Model(cfg, mesh.device)
    plan = plan or default_plan(cfg, mesh)
    opt_cfg = opt_cfg or OptimizerConfig()
    desc = "x".join(str(s) for s in mesh.shape.values())

    if shape.kind == "train":
        art = make_train_artifacts(model, mesh, plan, opt_cfg, shape)
        return LoweredCell(arch, shape_name, desc, "train", art.step_fn,
                           (art.state_specs, art.batch_input_specs), plan,
                           (art.state_shardings, art.batch_shardings))

    # serving paths use bf16 parameters
    p_specs, _ = model.param_specs()
    p_specs = tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.bfloat16, device="meta")
        if s.dtype == torch.float32 else s, p_specs)
    return _serving_cell(model, shape, mesh, plan, p_specs,
                         (arch, shape_name, desc))


def _serving_cell(model: Model, shape: ShapeConfig, mesh, plan: Plan,
                  p_specs: Tree, names) -> LoweredCell:
    """A prefill or decode cell on the reference's serving layouts, its
    step ``make_serve_artifacts``' (the prompt's cache of ``seq_len``
    positions; the prefill takes the batch's other inputs: the
    encoder-decoder's frames, the VLM's image embeddings)."""
    B = shape.global_batch
    art = make_serve_artifacts(model, mesh, plan, B, shape.seq_len)
    if shape.kind == "prefill":
        b_specs = model.input_specs(shape)

        def prefill_fn(params, batch):
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            return art.prefill_fn(params, batch["tokens"], extra or None)

        return LoweredCell(*names, "prefill", prefill_fn, (p_specs, b_specs),
                           plan, (art.param_shardings,
                                  batch_specs(b_specs, mesh, plan)))
    specs = model.input_specs(shape)
    tok_shard = batch_specs({"tokens": specs["tokens"]}, mesh,
                            plan)["tokens"]
    return LoweredCell(*names, "decode", art.decode_fn,
                       (p_specs, art.cache_specs, specs["tokens"]), plan,
                       (art.param_shardings, art.cache_shardings, tok_shard))


def _local_fakes(specs, shardings):
    """Uninitialised tensors (fake under a ``FakeTensorMode``) of each
    leaf's local block (trees of dicts and lists, as caches are)."""
    if isinstance(specs, dict):
        return {k: _local_fakes(v, shardings[k]) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_local_fakes(v, sh)
                           for v, sh in zip(specs, shardings))
    return torch.empty(shardings.local_shape(), dtype=specs.dtype)


def count_cell(cell: LoweredCell) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Run the cell's step once on fake tensors of this rank's local
    blocks under an :class:`~repro_torch.launch.op_stats.OpCounter`.
    Returns ``(counts, op record)``: the counts in the reference's
    ``analyze_compiled`` keys, the record for ``reanalyze``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    counter = op_stats.OpCounter(track_memory=True)
    with fake:
        args = tuple(_local_fakes(s, sh)
                     for s, sh in zip(cell.args, cell.shardings))
        with counter:
            arg_bytes = counter.add_arguments(args)
            t0 = time.time()
            out = cell.fn(*args)
            trace_s = time.time() - t0
            out_bytes, alias_bytes = counter.output_bytes(out)
    del out, args
    stats = counter.stats()
    counts = {
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": counter.peak_bytes,
        "alias_size_in_bytes": alias_bytes,
        "flops": stats["flops"],
        "bytes_accessed": stats["hbm_bytes"],
        "transcendentals": stats["transcendentals"],
        "collectives": op_stats.collectives_summary(stats),
        "hlo_stats": stats,
        "trace_s": trace_s,
    }
    return counts, counter.record()


def analyze_cell(cell: LoweredCell) -> Dict[str, Any]:
    """The counterpart of the reference's ``analyze_compiled``: memory,
    cost and collective counts of one rank's step (:func:`count_cell`)."""
    return count_cell(cell)[0]
