"""Serving on a mesh: every family's prefill and decode split over
``model``, on the reference's serving layouts.

Counterpart of the serving half of the reference package's
``launch/cells.py`` (``build_cell`` for a prefill or decode shape): the
parameters laid out by ``make_param_shardings`` (the ``model`` dims of
heads, MLP and vocab, FSDP over the data axes), the batch over the data
axes, and every decode-cache leaf by ``cache_spec`` (the batch over the
data axes, the K/V sequence of 1024 positions or more over ``model``,
every other leaf by its batch alone).  Where the reference hands those
layouts to GSPMD, each rank here holds its blocks and
:func:`make_serve_artifacts`' steps install, around the model's own
``prefill`` and ``decode_step``:

  * the gathering of ``parallel/fsdp.py`` (on a mesh of more than one
    rank): each layer's slices gathered over the axes their layouts name,
    one layer at a time, except the dims the split keeps;
  * the split of ``parallel/tensor.py`` (over a ``model`` axis of more
    than one rank): attention by heads where they divide the axis (else
    unsplit, or by the query rows under ``Plan.seq_shard_attn``, as the
    train step decides), the MLP by its hidden dim, the hybrid's SSM
    heads by their channels in the prefill, the embedding and head by
    vocab blocks, with ``cache_seq`` the cache's positions; the MoE
    decoders' routed experts held split by their experts dim, as the
    reference's serving layout puts ``experts`` on ``model``
    (``_Layout(..., experts=True)``; the router gathered whole): every
    rank routes all its tokens, runs its ``E/m`` experts' slots through
    K4 and the partial outputs are summed over ``model``
    (``models/moe.py`` ``apply_moe_split``).  The VLM's image embeddings
    replace the first positions after the vocab blocks' sum, as in its
    split training; the encoder-decoder's frames go through its encoder,
    split as its training splits it.  The xLSTM is not split
    (``train/step.py``'s ``GATHER_AND_REPEAT``): every ``model`` rank
    gathers each layer whole and runs its rows' prefill and decode.

The prefill then emits this rank's block of each K/V leaf whose
sequence the layout splits (the dense decoders', the encoder-decoder's
self-attention, the hybrid's global layers' K/V and ``slot_pos``: its
rows, its ``max_seq / m`` positions), and the decode reads and writes
that block (``models/attention.py``: each rank's partial softmax over
its block, merged over ``model``).  The logits come back whole over the
vocab for this rank's rows.

Every other cache leaf is held whole over ``model``, and after the
prefill and after every decode step it is bit for bit the same on every
``model`` rank of a data group:

  * computed alike by every rank from the same inputs, no collective:
    the encoder-decoder's cross cache ``xk``/``xv`` (every KV head, from
    the encoder's states held alike: sliced where the rank's K/V hold
    them all, else projected whole from ``xattn_wk``/``xattn_wv``, which
    are held alike); the hybrid's window rings and their ``slot_pos``
    (the prompt's last ``window`` positions of every KV head, sliced or
    projected so; each decode step every rank writes the new token's
    K/V of every KV head, projected from ``wk``/``wv``, into the same
    slot); the hybrid's SSM state in the decode (this module gathers the
    SSM heads' leaves whole for the decode, a layer at a time, and every
    rank steps the whole state of its rows); the xLSTM's states, and
    every family's ``pos``;
  * computed in blocks and gathered once: the hybrid's SSM state after
    the prefill, whose scan runs on the rank's channels (one all-gather
    of ``h`` and ``conv`` a layer, ``models/recurrent.py``).

On a mesh of one rank nothing is gathered or split and the steps are
the model's own calls, bit for bit.  A layout that puts anything else
over ``model`` raises (:func:`_check_seq_split`): the ``long_500k``
cells' (a batch of 1, its K/V sequence over the data and ``model`` axes
together, the hybrid's and the xLSTM's states over ``model`` by their
largest dim) are not served (ROADMAP, "sharded serving cells").
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
# the cache leaves whose sequence the serving layout may split over
# ``model`` (the K/V and, for the hybrid, the positions its slots hold)
SEQ_LEAVES = ("k", "v", "slot_pos")


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
    ``mesh``.  Where ``model`` has more than one rank, raises
    ``NotImplementedError`` for a cache layout that splits a state over
    ``model`` (the ``long_500k`` cells) and ``ValueError`` for one that
    does not split the K/V sequence over ``model`` (a split decode never
    gathers the cache whole)."""
    cfg = model.cfg
    m = mesh.shape.get(tensor.AXIS, 1)
    layout = _Layout(model, mesh, plan, experts=True)
    cache_specs = model.cache_specs(batch, max_seq)
    cache_sh = cache_specs_sharding(cache_specs, mesh, plan, batch, max_seq)
    if m > 1:
        if cfg.family == "hybrid" and cfg.sliding_window >= max_seq:
            raise ValueError(
                f"a window layer's ring of {max_seq} slots (window "
                f"{cfg.sliding_window}) would be split over {tensor.AXIS}: "
                f"the split decode reads a ring whole")
        _check_seq_split(cache_sh, max_seq)
    gathers = mesh.size(tuple(mesh.shape)) > 1

    def run(seq_len: int, params: Tree, fn: Callable, whole=frozenset()):
        split = layout.split(seq_len)
        if split is not None:
            split = dataclasses.replace(split, cache_seq=max_seq,
                                        regions=split.regions - whole)
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
        # the SSM heads step the whole state: their leaves gathered whole
        return run(tokens.shape[1], params,
                   lambda: model.decode_step(params, cache, tokens),
                   frozenset({"ssm"}))

    return ServeArtifacts(prefill_fn, decode_fn, layout.tree, cache_specs,
                          cache_sh)


def _check_seq_split(cache_sh: Tree, max_seq: int) -> None:
    """The reference's serving layout, as the split steps read it: every
    K/V leaf (and ``slot_pos``) whose sequence dim has ``max_seq``
    positions has that dim over ``model`` alone, at whatever index it
    sits; no other dim of any leaf is over ``model``.  A leaf with a
    ``model`` entry anywhere else (the ``long_500k`` layout: the states
    split over ``model``, the sequence over the data axes and ``model``
    together) raises ``NotImplementedError``; a sequence left whole over
    ``model`` (fewer than 1024 positions) raises ``ValueError``.  Both
    name the leaf."""
    for path, sh in flatten(cache_sh):
        assert isinstance(sh, Sharding), path
        seq = path.rsplit("/", 1)[-1] in SEQ_LEAVES
        for d, e in enumerate(sh.spec):
            at_seq = seq and sh.shape[d] == max_seq and d > 0
            if tensor.AXIS in e and not (at_seq and tuple(e) == (
                    tensor.AXIS,)):
                raise NotImplementedError(
                    f"cache leaf {path} {sh.shape} laid out {sh.spec}: dim "
                    f"{d} over {e}, which the split serving steps do not "
                    f"read (ROADMAP, '{SERVING_ROADMAP}')")
            if at_seq and tensor.AXIS not in e:
                raise ValueError(
                    f"cache leaf {path} {sh.shape} laid out {sh.spec}: the "
                    f"split decode reads a cache whose {max_seq} positions "
                    f"alone are split over {tensor.AXIS}")
