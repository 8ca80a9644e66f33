"""Train step of the port: loss -> gradients -> AdamW, with microbatch
accumulation and the remat policy of a :class:`Plan`.

Counterpart of the reference package's ``train/step.py`` for one card.
``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)`` over the state ``{"params", "opt": {"m", "v", "count"},
"step"}`` that ``init_train_state`` builds; the metrics carry the
reference's names (``loss``, ``ce``, ``aux``, ``tokens``, ``lr``,
``grad_norm``).  The step updates the state in place (the reference's
donation); :func:`keep_input_state` gives the step that leaves the
caller's state intact (the reference's step jitted without donation).

The reference's mesh, sharding hints and error-feedback gradient
compression (``shard_map``, ``train/compression.py``) wait for ROADMAP
queue 1, parallelism and elasticity: asking for them raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models.api import Model
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update)
from repro_torch.tree import Tree, flatten, leaves, tree_map, unflatten

_PARALLELISM = ("ROADMAP queue 1, parallelism and elasticity (sharding, "
                "gradient compression)")


@dataclasses.dataclass(frozen=True)
class Plan:
    """The train-step knobs of the reference's ``parallel.sharding.Plan``
    that one card can use (the rest describe a mesh)."""

    remat: str = "full"  # none | dots | full
    microbatch: int = 1


def init_train_state(model: Model, seed: int, opt_cfg: OptimizerConfig,
                     plan: Optional[Plan] = None) -> Dict[str, Any]:
    _check_plan(plan)
    params = model.init(seed)
    return {"params": params, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def _check_plan(plan) -> None:
    if getattr(plan, "compress_grads", False):
        raise NotImplementedError(
            f"gradient compression is not ported yet: {_PARALLELISM}")


def make_train_step(model: Model, opt_cfg: OptimizerConfig, plan: Plan,
                    mesh=None) -> Callable:
    if mesh is not None:
        raise NotImplementedError(
            f"a device mesh (sharded train step) is not ported yet: "
            f"{_PARALLELISM}")
    _check_plan(plan)
    nm = plan.microbatch

    def grads_of(params: Tree, batch: Dict[str, torch.Tensor]):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = model.loss(params, batch, remat=plan.remat)
        grads = torch.autograd.grad(loss, flat)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def compute_grads(params: Tree, batch: Dict[str, torch.Tensor]):
        if nm <= 1:
            return grads_of(params, batch)
        B = batch["tokens"].shape[0]
        if B % nm:
            raise ValueError(f"batch {B} is not a multiple of microbatch {nm}")
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        total = 0.0
        for i in range(nm):
            mb = {k: v[i * (B // nm):(i + 1) * (B // nm)]
                  for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.float() / nm)
            total = total + loss / nm
            del grads
        return total, metrics, acc  # the last microbatch's metrics

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params = state["params"]
        _, metrics, grads = compute_grads(params, batch)
        grad_tree = _like(params, grads)
        del grads
        _, _, opt_metrics = adamw_update(grad_tree, state["opt"], params,
                                         opt_cfg)
        del grad_tree
        state["step"].add_(1)
        return state, {**metrics, **opt_metrics}

    return train_step


def _like(tree: Tree, flat) -> Tree:
    """``flat`` (leaves in ``tree``'s order) in ``tree``'s structure."""
    return unflatten((path, x) for (path, _), x in zip(flatten(tree), flat))


def keep_input_state(step_fn: Callable) -> Callable:
    """The step on a copy of the state, so the caller's state is left as
    it was: the reference's train step jitted without donation."""

    def step(state, batch):
        copy = tree_map(lambda x: x.detach().clone(), state)
        return step_fn(copy, batch)

    return step
