"""The port's parallel layer: the planner's :class:`Plan`, the layout of
every tensor on a mesh (``sharding``), the collectives that the sharded
train step, the split dense compute and the expert-parallel MoE make
(``collectives``), the ZeRO-3 gather of the parameters one layer at a
time (``fsdp``), and the split over ``model`` (``tensor``): Megatron's
head- and hidden-split blocks, the SSM heads split by their channels,
the vocab-parallel embedding, head and loss, and context-parallel
attention, which the reference gets from GSPMD through its layouts and
``parallel/hints.py``'s logits and query constraints.  The dense and MoE
decoders, the VLM, the encoder-decoder and the hybrid are split; the
xLSTM repeats its data shard's compute on each ``model`` rank."""
from repro_torch.parallel.sharding import (Plan, Sharding, batch_specs,
                                           cache_specs_sharding, gather_tree,
                                           make_param_shardings, param_spec,
                                           replicated, shard_tree)

__all__ = ["Plan", "Sharding", "batch_specs", "cache_specs_sharding",
           "gather_tree", "make_param_shardings", "param_spec", "replicated",
           "shard_tree"]
