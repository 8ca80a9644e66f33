"""AdamW and learning-rate schedules of the port.

Counterpart of the reference package's ``train/optimizer.py``: decoupled
weight decay on parameters with more than one dimension, global-norm
clipping, and float32 or bfloat16 moments.  The arithmetic follows the
reference op for op in float32.  Where the reference returns new trees,
:func:`adamw_update` writes the new parameters and moments into the
given tensors, which is what the reference's donated train step
(``jit_train_step(donate=True)``) amounts to: no second copy of the
state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.tree import Tree, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"  # cosine | linear | constant
    moment_dtype: str = "float32"  # float32 | bfloat16


def lr_at(cfg: OptimizerConfig,
          step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warmup to ``cfg.lr`` over ``warmup_steps``, then the decay
    of ``cfg.schedule`` to 0 at ``total_steps``; a float32 scalar on
    ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = torch.ones_like(frac)
    return cfg.lr * warm * decay


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(tree: Tree,
                        max_norm: float) -> Tuple[Tree, torch.Tensor]:
    """The tree scaled so its global norm is at most ``max_norm``, and the
    norm before clipping."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def adamw_init(params: Tree, cfg: OptimizerConfig) -> Dict[str, Any]:
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=mdt, device=p.device)

    device = leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


# the update walks a leaf in blocks of rows of at most this many elements,
# so its float32 temporaries stay small beside the state (a 3.2 GB leaf,
# phi-3-vision's stacked MLP weight, would otherwise take about six 3.2 GB
# temporaries at once); the update is elementwise, so the result is the
# same bit for bit
_BLOCK_ELEMS = 1 << 26


def _row_blocks(*xs: torch.Tensor):
    """Views of ``xs`` (tensors of one shape) over the same blocks of
    rows of their leading axis, each of at most ``_BLOCK_ELEMS``
    elements (one block per leaf for small leaves and scalars)."""
    x = xs[0]
    if x.dim() == 0 or x.numel() <= _BLOCK_ELEMS:
        return [xs]
    rows = max(1, _BLOCK_ELEMS // (x.numel() // x.shape[0]))
    return list(zip(*(t.split(rows) for t in xs)))


@torch.no_grad()
def adamw_update(grads: Tree, state: Dict[str, Any], params: Tree,
                 cfg: OptimizerConfig, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, written in place into ``params`` and ``state``'s
    moments and count; weight decay applies to parameters with more than
    one dimension.  Returns ``(params, state, {"lr", "grad_norm"})``, the
    same objects it was given, as the reference returns its new trees.
    ``gnorm`` is the gradient's global norm when ``grads`` are one rank's
    blocks of it (the sharded step's), else the norm of ``grads``."""
    count = state["count"] + 1
    b1, b2 = cfg.betas
    lr = lr_at(cfg, count)
    cf = count.to(torch.float32)
    bc1 = 1.0 - b1 ** cf
    bc2 = 1.0 - b2 ** cf
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    mdt = getattr(torch, cfg.moment_dtype)
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), leaves(params)):
        decay = cfg.weight_decay and p.dim() > 1
        for g, m, v, p in _row_blocks(g, m, v, p):
            g32 = (g.float() * scale).to(g.dtype).float()  # clipped gradient
            m32 = m.float() * b1 + g32 * (1 - b1)
            v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
            step_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
            if decay:
                step_ = step_ + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * step_)
            m.copy_(m32.to(mdt))
            v.copy_(v32.to(mdt))
    state["count"].copy_(count)
    return params, state, {"lr": lr, "grad_norm": gnorm}
