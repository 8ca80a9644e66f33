"""The ZeRO-3 gather of the sharded train step, one layer at a time.

Each rank holds its block of every parameter (``parallel/sharding.py``).
The reference's GSPMD gathers a layer's leaves inside its scan over the
layers; here the step installs a :class:`Gathering` for each forward and
backward (:func:`installed`, as ``parallel/tensor.py``'s split is
installed) and the model gathers where it reads:

  * a stacked leaf (leading ``layers`` dim) reaches the model as this
    rank's block; :func:`layers` cuts it into per-layer slices
    (``unbind``) and each layer's function gathers its slices first thing
    (:func:`layer`), so under remat the recompute gathers again and
    autograd saves no gathered tensor;
  * a leaf without a ``layers`` dim (the embedding, the head, the final
    norms, the encoder's final norm) is gathered at its first use
    (:func:`leaf`), and that one gathered tensor serves the later uses
    (the tied head), so its gradient is reduced once.

The gather is one autograd Function (:class:`_Gather`).  Forward: an
all-gather of the block over every split dim except those the compute
keeps split (:attr:`Leaf.keep`: the expert dim under ``shard_map``, the
dims ``tensor.kept_dim`` keeps).  Backward: the gradient summed over the
data axes, and over ``model`` for a leaf that a split region reads but
holds alike (``tensor.Split.partial``), by a reduce-scatter where one dim
is split over exactly those axes, else an all-reduce; then this rank's
block is kept.  A stacked leaf so gets its gradient one layer at a time
through ``unbind``'s backward, and no whole-shaped gradient of it
exists.  FSDP may split the ``layers`` dim itself over the data axes
(where it is the largest dim that divides: hymba's ``d_in``-by-16 SSM
matrices on 16×16); each layer then lives on one rank of those axes,
its slice is gathered over them and the owner's block taken, and the
summed gradient goes back to the owner alone.

Remat decides how long a gathered leaf lives.  Under ``full`` and
``dots`` a layer's gathered leaves live during its forward, and again
during its recompute and backward.  Under ``none`` autograd keeps what
each layer's products save, the gathered weights among them, until that
layer's backward, so at the end of the forward a rank holds every
layer's gathered leaves (the encoder-decoder's encoder, which is never
rematerialised, is always so).

With no gathering installed (no mesh, a mesh of one rank, every serving
path) :func:`layers` is ``unbind``, and :func:`layer` and :func:`leaf`
return what they are given.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import collectives

Spec = Tuple[Tuple[str, ...], ...]


@dataclasses.dataclass(frozen=True)
class Leaf:
    """How a leaf (or one layer's slice of a stacked leaf) is gathered and
    its gradient reduced: the layout of the gathered tensor (``spec``),
    the dims kept local (``keep``), the axes its gradient is summed over
    (``axes``) and, for a layer whose ``layers`` dim is split, the axes
    of that split and the block that holds the layer (``owner``)."""

    mesh: Any
    spec: Spec
    keep: Tuple[int, ...] = ()
    axes: Tuple[str, ...] = ()
    owner: Optional[Tuple[Tuple[str, ...], int]] = None

    def trivial(self) -> bool:
        """Nothing to gather and nothing to reduce."""
        return self.owner is None and self.mesh.size(self.axes) == 1 and \
            all(d in self.keep or self.mesh.size(e) == 1
                for d, e in enumerate(self.spec))

    def layer(self, i: int, local_layers: int) -> "Leaf":
        """Layer ``i``'s slice of a stacked leaf whose block holds
        ``local_layers`` layers."""
        assert 0 not in self.keep, self.keep
        e = self.spec[0]
        owner = None
        if self.mesh.size(e) > 1:
            if not set(e) <= set(self.axes):
                raise ValueError(f"layers dim split over {e}, whose "
                                 f"gradient is not summed over them")
            owner = (e, i // local_layers)
        return Leaf(self.mesh, self.spec[1:],
                    tuple(d - 1 for d in self.keep), self.axes, owner)


def gather(x: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    """The tensor the compute reads, from this rank's block ``x``."""
    mesh, out = leaf.mesh, x
    if leaf.owner is not None:
        axes, block = leaf.owner
        out = collectives.all_gather_dim(x.unsqueeze(0), 0, mesh,
                                         axes)[block]
    for d, e in enumerate(leaf.spec):
        if d not in leaf.keep and mesh.size(e) > 1:
            out = collectives.all_gather_dim(out, d, mesh, e)
    return out


def reduce(g: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    """The compute-shaped gradient ``g`` (this rank's term) summed over
    ``leaf.axes``, this rank's block kept."""
    mesh, spec, axes = leaf.mesh, leaf.spec, leaf.axes
    done = set(leaf.keep)
    if mesh.size(axes) > 1:
        dims = [d for d, e in enumerate(spec) if set(e) & set(axes)]
        if len(dims) == 1 and set(spec[dims[0]]) == set(axes) \
                and dims[0] not in done:
            d = dims[0]
            g = collectives.reduce_scatter_dim(g, d, mesh, spec[d])
            done.add(d)
        else:  # in place, on a copy: autograd may hold g elsewhere
            g = collectives.all_reduce(
                g.clone(memory_format=torch.contiguous_format), mesh, axes)
    if leaf.owner is not None and mesh.index(leaf.owner[0]) != leaf.owner[1]:
        g = torch.zeros_like(g)  # another rank holds this layer
    sliced = False
    for d, e in enumerate(spec):
        if d not in done and mesh.size(e) > 1:
            g = collectives.slice_block(g, d, mesh, e)
            sliced = True
    return g.clone() if sliced else g  # let the compute-shaped one go


class _Gather(torch.autograd.Function):
    """Forward :func:`gather`, backward :func:`reduce`."""

    @staticmethod
    def forward(ctx, x, leaf):
        ctx.leaf = leaf
        out = gather(x, leaf)
        return x.view_as(x) if out is x else out

    @staticmethod
    def backward(ctx, g):
        return reduce(g, ctx.leaf), None


def _apply(x: torch.Tensor, leaf: Leaf) -> torch.Tensor:
    return x if leaf.trivial() else _Gather.apply(x, leaf)


class Layer(dict):
    """One layer's slices of the stacked leaves (this rank's blocks), with
    the :class:`Leaf` of each (``leaves``): what :func:`layer` gathers."""

    def __init__(self, slices: Dict[str, torch.Tensor],
                 leaves: Dict[str, Leaf]):
        super().__init__(slices)
        self.leaves = leaves


class Gathering:
    """The leaves of one forward and backward (this rank's blocks, the
    tensors the model is given) with the :class:`Leaf` of each."""

    def __init__(self, blocks: Sequence[torch.Tensor],
                 leaves: Sequence[Leaf]):
        self._leaf = {id(t): (t, lf) for t, lf in zip(blocks, leaves)}
        self._gathered: Dict[int, torch.Tensor] = {}

    def _lookup(self, t: torch.Tensor) -> Leaf:
        got = self._leaf.get(id(t))  # the leaves are held: ids stay theirs
        if got is None:
            raise KeyError(f"a tensor of shape {tuple(t.shape)} that is no "
                           f"leaf of the gathering")
        return got[1]

    def leaf(self, t: torch.Tensor) -> torch.Tensor:
        if id(t) not in self._gathered:
            self._gathered[id(t)] = _apply(t, self._lookup(t))
        return self._gathered[id(t)]

    def layers(self, blocks: Dict[str, torch.Tensor]) -> List[Layer]:
        per = {k: (v.unbind(0), self._lookup(v)) for k, v in blocks.items()}
        n = {lf.mesh.size(lf.spec[0]) * len(parts)
             for parts, lf in per.values()}
        assert len(n) == 1, n
        out = []
        for i in range(n.pop()):
            slices, leaves = {}, {}
            for k, (parts, lf) in per.items():
                slices[k] = parts[i % len(parts)]
                leaves[k] = lf.layer(i, len(parts))
            out.append(Layer(slices, leaves))
        return out


_current: Optional[Gathering] = None


def active() -> Optional[Gathering]:
    return _current


@contextlib.contextmanager
def installed(g: Optional[Gathering]):
    """Install ``g`` for a block of code (one forward and backward of
    the sharded step), restored after."""
    global _current
    saved = _current
    _current = g
    try:
        yield
    finally:
        _current = saved


def layers(blocks: Dict[str, torch.Tensor]) -> Optional[List[Layer]]:
    """Per-layer slices of stacked leaves under a gathering; None with no
    gathering installed."""
    return None if _current is None else _current.layers(blocks)


def layer(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A layer's parameters as its function reads them: the slices of a
    :class:`Layer` gathered; any other dict as it is."""
    if not isinstance(p, Layer):
        return p
    return {k: _apply(v, p.leaves[k]) for k, v in p.items()}


def leaf(t: torch.Tensor) -> torch.Tensor:
    """A leaf without a ``layers`` dim as the compute reads it: gathered
    at its first use under a gathering, itself otherwise."""
    return t if _current is None else _current.leaf(t)


def norm_leaves(params: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The gain (and bias) of the norm ``prefix`` as :func:`leaf` gives
    them, for ``apply_norm``."""
    return {k: leaf(params[k]) for k in (f"{prefix}_g", f"{prefix}_b")
            if k in params}
