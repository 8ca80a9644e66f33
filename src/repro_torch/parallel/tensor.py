"""Tensor and context parallelism over the mesh's ``model`` axis: the
split context that the sharded train step installs for its forward and
backward, and the operators the model's split functions call.

The reference gets this split from GSPMD: the parameters' layouts put
``heads``, ``mlp`` and ``vocab`` on ``model``, its ``hints.logits`` pins
the logits' vocab there (``src/repro/parallel/hints.py:60-67``) and, under
``Plan.seq_shard_attn``, its ``hints.attn_q`` splits the queries on the
sequence over ``model`` (``hints.py:69-79``; the planner sets it when the
head count does not divide the ``model`` axis).  Here each rank holds its
blocks of those leaves and computes only its block, Megatron's way: the
activations between the split regions are held alike by every ``model``
rank, a region opens with :meth:`Split.sum_grad` (the identity, its
backward summed over ``model``) and a region whose output is a sum of
the ranks' terms closes with :meth:`Split.reduce_sum` (the sum, its
backward the identity).  The regions (``models/attention.py``,
``models/lm.py``):

  * attention by heads (``attn == "heads"``): ``wq``, ``bq`` and ``wo``
    hold the rank's ``H/m`` heads; ``wk`` and ``wv`` are held alike and
    each rank takes the KV heads its query heads read, so their gradients
    are partial sums that the step adds over ``model``;
  * attention by the sequence (``attn == "seq"``, context parallelism):
    the rank's ``S/m`` query rows against the whole K and V through K1's
    ``q_offset``, the output gathered back over the sequence; every
    attention weight is held alike and its gradient is partial;
  * the MLP by its hidden dim (columns of ``mlp_wg``/``mlp_wu``, rows of
    ``mlp_wd``);
  * the hybrid's SSM heads by their channels (``d_in``: columns of
    ``ssm_w_in``, ``ssm_w_z``, ``ssm_w_dt2``, ``ssm_conv_w``,
    ``ssm_b_dt``, ``ssm_D``; rows of ``ssm_A_log``, ``ssm_w_B``,
    ``ssm_w_C``, ``ssm_w_dt1``, ``ssm_w_out``): the scan runs on the
    rank's channels, the B, C and low-rank dt products and the output
    projection, which contract over the channels, summed over ``model``;
  * the embedding and the head by vocab blocks, and the float32
    next-token loss over the vocab blocks (``lm.token_nll``).

Attention (``attn_*``, and the encoder-decoder's cross attention
``xattn_*``) takes its mode call by call (:meth:`Split.attn_mode`): by
the sequence only where the call's own query length splits, so the
encoder of 1500 frames is not split by the sequence over 16 ranks while
the decoder's 4096 positions are, and its leaves' gradients are then not
partial (:meth:`Split.partial` with the sequence a leaf is read at).

Which leaves each region reads, and which of their dims it keeps split,
is declared here once (:data:`REGIONS`, :func:`kept_dim`): the train
step keeps those dims local, installs the regions it split, and sums
over ``model`` the gradient of every other leaf a split region reads
(:meth:`Split.partial`), so a leaf added to a region is summed with no
table to update.  The model's split functions ask :meth:`Split.splits`.

Serving installs the same split for a forward with no backward
(``serve/sharded.py``, the dense decoders), with :attr:`Split.cache_seq`
the decode cache's positions, whose sequence the serving layout splits
over ``model``: the prefill emits each rank's block of it and the
decode's attention reads the rank's block, the blocks' partial
softmaxes merged over ``model`` (``models/attention.py``).

Over a ``model`` group of one rank nothing is split: :func:`active` is
None and every split function runs the unsplit code.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, FrozenSet, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives

AXIS = "model"


# The split regions: the names of the leaves each reads (a name ending in
# ``_`` is a prefix) and the logical dim it keeps split over ``model``.
# Attention keeps its heads split only when split by heads; split by the
# sequence it keeps no dim split.
REGIONS = {"attn": (("attn_", "xattn_"), "heads"),
           "mlp": (("mlp_",), "mlp"),
           "ssm": (("ssm_",), "mlp"),
           "vocab": (("embed", "lm_head"), "vocab")}


def region_of(name: str) -> Optional[str]:
    """The region that reads the leaf ``name`` (its last path part), or
    None."""
    for region, (names, _) in REGIONS.items():
        if any(name.startswith(n) if n.endswith("_") else name == n
               for n in names):
            return region
    return None


def kept_dim(name: str, axes: Sequence[str], spec, heads: bool
             ) -> Optional[int]:
    """The dim of the leaf ``name`` (logical ``axes``, layout ``spec``)
    that its region keeps split over ``model``: the region's logical dim
    when it is laid out over ``model`` alone, the heads only when
    attention is split by ``heads``.  None: the leaf is held alike by
    every ``model`` rank (or is read by no region)."""
    region = region_of(name)
    if region is None or (region == "attn" and not heads):
        return None
    logical = REGIONS[region][1]
    if logical not in axes:
        return None
    d = list(axes).index(logical)
    if tuple(spec[d]) == (AXIS,):
        return d
    if region == "attn":
        raise ValueError(f"{name}: heads dim laid out over {spec[d]}, "
                         f"not over {AXIS}")
    return None


@dataclasses.dataclass(frozen=True)
class Split:
    """The mesh, the attention mode (``"heads"``, ``"seq"`` or None:
    attention not split) and the regions split (``REGIONS``' keys,
    ``"attn"`` with the mode) of one forward and backward; for a serving
    forward (no backward), ``cache_seq``: the positions of the decode
    cache whose sequence the serving layout splits over ``model``
    (``sharding.cache_spec``), each rank holding the block of
    ``cache_seq / m`` positions at its index (0: a train forward, no
    cache)."""

    mesh: Any
    attn: Optional[str] = None
    regions: FrozenSet[str] = frozenset()
    cache_seq: int = 0

    def splits(self, region: str) -> bool:
        """Whether ``region`` computes this rank's block."""
        return region in self.regions

    def partial(self, name: str, kept: bool,
                seq_len: Optional[int] = None) -> bool:
        """Whether the gradient of the leaf ``name`` is this rank's term,
        to be summed over ``model``: a split region reads it and it is
        held alike by every ``model`` rank (not ``kept`` split).  An
        attention leaf read at ``seq_len`` query positions (the
        encoder's frames; None: the forward's own sequence) is partial
        only where that call is split (:meth:`attn_mode`)."""
        region = region_of(name)
        if region == "attn" and seq_len is not None \
                and self.attn_mode(seq_len) is None:
            return False
        return self.size > 1 and not kept and self.splits(region)

    def attn_mode(self, seq_len: int) -> Optional[str]:
        """The mode of one attention call over ``seq_len`` query
        positions: the forward's, but the sequence split only where
        ``seq_len`` splits over ``model`` as :func:`attn_mode` asks."""
        if self.attn == "seq" and (seq_len % self.size
                                   or seq_len < 2 * self.size):
            return None
        return self.attn

    @property
    def size(self) -> int:
        return self.mesh.size(AXIS)

    @property
    def rank(self) -> int:
        """This rank's block index along ``model``."""
        return self.mesh.index(AXIS)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """A split region's input: the identity, its gradient summed over
        ``model``."""
        return collectives.sum_grad(x, self.mesh, AXIS)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' terms summed over ``model``, the gradient passed
        through."""
        return collectives.reduce_sum(x, self.mesh, AXIS)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of ``dim`` gathered; the gradient's block
        back."""
        return collectives.gather(x, dim, self.mesh, AXIS)

    def cache_block(self, positions: int) -> int:
        """The positions of this rank's block of a decode cache of
        ``positions`` in all; raises unless the serving layout splits
        that cache's sequence over ``model`` (a split forward never
        gathers the cache whole)."""
        if not self.cache_seq or positions != self.cache_seq \
                or positions % self.size:
            raise ValueError(
                f"a split serving step reads and writes a decode cache of "
                f"{positions} positions in blocks over {AXIS} "
                f"({self.size} ranks), but the serving layout splits "
                f"{self.cache_seq or 'no cache'} positions so")
        return positions // self.size

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over ``model`` of a tensor with no
        gradient (in place)."""
        return collectives.all_reduce(x, self.mesh, AXIS,
                                      op=dist.ReduceOp.MAX)


_current: Optional[Split] = None


def active() -> Optional[Split]:
    """The installed split when its ``model`` group has more than one
    rank; None otherwise (nothing installed, or one rank)."""
    s = _current
    return s if s is not None and s.size > 1 else None


@contextlib.contextmanager
def split(s: Optional[Split]):
    """Install ``s`` for a block of code (a train step's forward and
    backward), restored after."""
    global _current
    saved = _current
    _current = s
    try:
        yield
    finally:
        _current = saved


def heads_split(cfg, plan, m: int) -> bool:
    """Attention split by heads: the heads divide the ``model`` axis and
    the plan does not ask for the sequence split."""
    return not plan.seq_shard_attn and cfg.num_heads % m == 0


def attn_mode(cfg, plan, m: int, seq_len: int) -> Optional[str]:
    """``"heads"``, ``"seq"`` or None (not split) for a forward of
    ``seq_len`` positions over ``m`` ``model`` ranks: by the sequence
    under the plan's ``seq_shard_attn`` where the reference's
    ``hints.attn_q`` splits it (``S % m == 0`` and ``S >= 2m``)."""
    if heads_split(cfg, plan, m):
        return "heads"
    if plan.seq_shard_attn and seq_len % m == 0 and seq_len >= 2 * m:
        return "seq"
    return None
