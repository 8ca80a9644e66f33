"""The port's parallel layer: the planner's :class:`Plan`, the layout of
every tensor on a mesh (``sharding``) and the collectives that the
sharded train step and the expert-parallel MoE make (``collectives``).
The reference's ``parallel/hints.py`` has no counterpart: its hooks are
GSPMD layout constraints, and each rank's activations here are already
its local shard."""
from repro_torch.parallel.sharding import (Plan, Sharding, batch_specs,
                                           cache_specs_sharding, gather_tree,
                                           make_param_shardings, param_spec,
                                           replicated, shard_tree)

__all__ = ["Plan", "Sharding", "batch_specs", "cache_specs_sharding",
           "gather_tree", "make_param_shardings", "param_spec", "replicated",
           "shard_tree"]
