"""Serving on a mesh: the dense and MoE decoders' and the VLM's prefill
and decode split over ``model``, on the reference's serving layouts.

Counterpart of the serving half of the reference package's
``launch/cells.py`` (``build_cell`` for a prefill or decode shape): the
parameters laid out by ``make_param_shardings`` (the ``model`` dims of
heads, MLP and vocab, FSDP over the data axes), the batch over the data
axes, and every decode-cache leaf by ``cache_spec`` (the batch over the
data axes, the K/V sequence of 1024 positions or more over ``model``,
``pos`` by its batch).  Where the reference hands those layouts to GSPMD,
each rank here holds its blocks and :func:`make_serve_artifacts`' steps
install, around the model's own ``prefill`` and ``decode_step``:

  * the gathering of ``parallel/fsdp.py`` (on a mesh of more than one
    rank): each layer's slices gathered over the axes their layouts name,
    one layer at a time, except the dims the split keeps;
  * the split of ``parallel/tensor.py`` (over a ``model`` axis of more
    than one rank): attention by heads where they divide the axis (else
    unsplit, or by the query rows under ``Plan.seq_shard_attn``, as the
    train step decides), the MLP by its hidden dim, the embedding and
    head by vocab blocks, with ``cache_seq`` the cache's positions;
    the MoE decoders' routed experts held split by their experts dim,
    as the reference's serving layout puts ``experts`` on ``model``
    (``_Layout(..., experts=True)``; the router gathered whole): every
    rank routes all its tokens, runs its ``E/m`` experts' slots through
    K4 and the partial outputs are summed over ``model``
    (``models/moe.py`` ``apply_moe_split``).  The VLM's image embeddings
    replace the first positions after the vocab blocks' sum, as in its
    split training.

The prefill then emits this rank's block of the cache (its rows, its
``max_seq / m`` positions) and the decode reads and writes that block
(``models/attention.py``: each rank's partial softmax over its block,
merged over ``model``).  The logits come back whole over the vocab for
this rank's rows.  On a mesh of one rank nothing is gathered or split
and the steps are the model's own calls, bit for bit.

Only the dense and MoE decoders and the VLM are served so; hymba, the
xLSTM and whisper raise on a mesh of more than one rank (ROADMAP,
"sharded serving cells").
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.models.api import Model
from repro_torch.parallel import fsdp, tensor
from repro_torch.parallel.sharding import (Plan, Sharding,
                                           cache_specs_sharding)
from repro_torch.train.step import _Layout
from repro_torch.tree import Tree, flatten, leaves

SERVING_ROADMAP = "sharded serving cells"
SPLIT_FAMILIES = ("dense", "moe", "vlm")


@dataclasses.dataclass
class ServeArtifacts:
    """The layouts of the parameters and of the decode cache, and the two
    steps over this rank's blocks: ``prefill_fn(params, tokens,
    extra=None, lens=None) -> (logits (B/dp, V), cache block)`` and
    ``decode_fn(params, cache, tokens) -> (logits (B/dp, V), cache)``."""

    prefill_fn: Callable
    decode_fn: Callable
    param_shardings: Tree
    cache_specs: Tree
    cache_shardings: Tree


def make_serve_artifacts(model: Model, mesh, plan: Plan, batch: int,
                         max_seq: int) -> ServeArtifacts:
    """Serving of ``batch`` slots and a cache of ``max_seq`` positions on
    ``mesh``.  Raises ``NotImplementedError`` for a family not in
    ``SPLIT_FAMILIES`` on a mesh of more than one rank, and ``ValueError``
    when the cache layout does not split the K/V sequence over ``model``
    where ``model`` has more than one rank (a split decode never gathers
    the cache whole)."""
    cfg = model.cfg
    ranks = mesh.size(tuple(mesh.shape))
    m = mesh.shape.get(tensor.AXIS, 1)
    if ranks > 1 and cfg.family not in SPLIT_FAMILIES:
        raise NotImplementedError(
            f"serving {cfg.name} ({cfg.family}) on a mesh of {ranks} ranks "
            f"is not ported (ROADMAP, '{SERVING_ROADMAP}')")
    layout = _Layout(model, mesh, plan, experts=True)
    cache_specs = model.cache_specs(batch, max_seq)
    cache_sh = cache_specs_sharding(cache_specs, mesh, plan, batch, max_seq)
    if m > 1:
        _check_seq_split(cache_sh, max_seq)
    gathers = ranks > 1

    def run(seq_len: int, params: Tree, fn: Callable):
        split = layout.split(seq_len)
        if split is not None:
            split = dataclasses.replace(split, cache_seq=max_seq)
        gathering = fsdp.Gathering(leaves(params), layout.leaf_plans(
            split)) if gathers else None
        with torch.no_grad(), fsdp.installed(gathering), \
                tensor.split(split):
            return fn()

    def prefill_fn(params: Tree, tokens: torch.Tensor,
                   extra: Optional[Dict[str, torch.Tensor]] = None,
                   lens: Optional[torch.Tensor] = None):
        return run(tokens.shape[1], params, lambda: model.prefill(
            params, tokens, extra, max_seq=max_seq, lens=lens))

    def decode_fn(params: Tree, cache: Tree, tokens: torch.Tensor):
        return run(tokens.shape[1], params,
                   lambda: model.decode_step(params, cache, tokens))

    return ServeArtifacts(prefill_fn, decode_fn, layout.tree, cache_specs,
                          cache_sh)


def _check_seq_split(cache_sh: Tree, max_seq: int) -> None:
    """Raise unless every K/V leaf's sequence dim is split over ``model``
    alone (and nothing else over ``model``)."""
    for path, sh in flatten(cache_sh):
        assert isinstance(sh, Sharding), path
        for d, e in enumerate(sh.spec):
            seq = path.rsplit("/", 1)[-1] in ("k", "v") and d == 2
            if (tensor.AXIS in e) != seq or (seq and tuple(e) != (
                    tensor.AXIS,)):
                raise ValueError(
                    f"cache leaf {path} {sh.shape} laid out {sh.spec}: the "
                    f"split decode reads a cache whose {max_seq} positions "
                    f"alone are split over {tensor.AXIS}")
