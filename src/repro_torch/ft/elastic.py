"""Elastic rescaling: re-plan to a different device count and reshard
the checkpointed state.

Counterpart of the reference package's ``ft/elastic.py``.  The flow
(what the Execution Engine does after losing or gaining nodes):

  1. the planner picks the best feasible plan for the *new* device count;
  2. a new mesh is built; the layouts are derived again from the same
     logical axes (models know no mesh);
  3. the checkpoint is restored onto the new layouts — shapes unchanged,
     each rank keeping its block of each leaf;
  4. the data stream continues from the restored step — the pipeline is a
     pure function of (seed, step), so no data is lost or repeated.

:func:`state_shardings` is the shared mapping: the layout tree of a
train state's structure on a mesh for a plan, used by
:func:`reshard_state`, :func:`elastic_restart` and the train stage's
resume, which restores its newest committed checkpoint onto the mesh of
whatever placement the re-plan bound it to.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch.models.api import Model
from repro_torch.parallel.sharding import Plan
from repro_torch.tree import Tree, tree_map

Pytree = Any


def state_shardings(state_like: Tree, model: Model, mesh,
                    plan: Plan) -> Tree:
    """The layout tree matching a train state's structure: parameters,
    moments (and ``grad_err`` when the state has one) by the model's
    logical axes, the step and the Adam count whole.  ``state_like``
    only supplies the structure."""
    from repro_torch.train.step import state_layouts

    return state_layouts(model, mesh, plan, "grad_err" in state_like)


def reshard_state(state: Tree, model: Model, mesh, plan: Plan) -> Tree:
    """This rank's blocks of a whole train state (on any device), on the
    mesh's device."""

    def one(x, lay):
        block = lay.local(x)
        return block.to(mesh.device, copy=block is not x)

    return tree_map(one, state, state_shardings(state, model, mesh, plan))


def elastic_restart(checkpointer, like_state: Tree, model: Model,
                    new_mesh, plan: Plan) -> Tuple[Tree, int]:
    """Restore the newest checkpoint onto a *new* mesh (another device
    count than the mesh that wrote it): ``(this rank's blocks, step)``."""
    return checkpointer.restore(
        like_state,
        shardings=state_shardings(like_state, model, new_mesh, plan))
