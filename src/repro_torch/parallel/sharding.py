"""Logical-axis -> mesh sharding: the piece of the Execution Engine that
turns a planner decision into the layout of every tensor on a mesh.

Counterpart of the reference package's ``parallel/sharding.py``.  Models
annotate parameters with *logical* axis names ("embed", "heads", "mlp",
"experts", ...; ``models/api.param_table``).  A :class:`Plan` maps logical
names to mesh axes and adds FSDP ("ZeRO") sharding of the remaining
largest dimension over the data axes.

The reference hands these layouts to GSPMD as ``NamedSharding``s.  The
port has no GSPMD: each rank holds plain local tensors, its shard of each
leaf, and the train step makes the collectives itself.  A layout here is
a :class:`Sharding`: the mesh, the global shape, and for each tensor dim
the tuple of mesh axes that split it (``()`` for none), the same tuples
as the reference's ``PartitionSpec`` entries.  An entry of several axes,
such as ``("data", "model")``, splits its dim in the tuple's order, the
first axis major, as JAX does (not in the mesh's order).

:func:`param_spec`, :func:`batch_specs` and :func:`cache_specs_sharding`
are pure functions of shapes and the mesh's ``{axis: size}``: a
:class:`~repro_torch.launch.mesh.Mesh` or a plain dict.  The reference's
``constraint`` (``with_sharding_constraint`` inside a jit) has no
counterpart: each rank's activations are already its local shard.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import Tree, tree_map

Spec = Tuple[Tuple[str, ...], ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    """A parallelism plan: what the planner hands to the runtime (every
    field of the reference's ``Plan``).

    Fields the port reads differently from the reference, by design:

      * ``attn_impl`` ``"xla"`` and ``"tri"`` both run K1 (flash
        attention with a causal skip), and ``flash_block_q``/``_k`` are
        the reference's Pallas tiles: K1 chooses its own;
      * ``ssm_chunk``: the selective scan always trains through K5-bwd's
        checkpointed adjoint, whatever the chunk;
      * ``seq_shard_attn`` (context-parallel attention): the train step
        splits attention's query rows over ``model`` (K1's
        ``q_offset``) where the reference's ``hints.attn_q`` does;
        without it attention is split by heads when they divide the
        ``model`` axis (``parallel/tensor.py``).  The MLP, the hybrid's
        SSM heads, the embedding, the head and the loss are split over
        ``model`` either way, for every family but the xLSTM, which
        repeats its data shard's compute on each ``model`` rank
        (``train/step.py``'s ``GATHER_AND_REPEAT``).
    """

    name: str = "tp+fsdp"
    # logical axis name -> mesh axis (or tuple of mesh axes)
    logical: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {
            "vocab": "model",
            "heads": "model",
            "mlp": "model",
            "experts": "model",
        }
    )
    # mesh axes used for data parallelism (batch) and FSDP weight sharding
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp_axes: Tuple[str, ...] = ("data",)
    fsdp: bool = True
    # train-step knobs
    remat: str = "full"  # none | dots | full
    microbatch: int = 1
    shard_cache_seq: bool = True
    compress_grads: bool = False
    attn_impl: str = "xla"  # xla | tri: both run K1
    seq_shard_attn: bool = False  # context-parallel attention
    ssm_chunk: int = 0  # the port trains the scan through K5-bwd always
    moe_impl: str = "scatter"  # scatter | shard_map (explicit a2a)
    flash_block_q: int = 512
    flash_block_k: int = 1024

    def with_(self, **kw) -> "Plan":
        return dataclasses.replace(self, **kw)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a :class:`~repro_torch.launch.mesh.Mesh` or of
    a plain dict."""
    return dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)


def _axes_of(sizes: Dict[str, int], names: Sequence[str]) -> int:
    out = 1
    for n in names:
        out *= sizes[n]
    return out


def _as_tuple(x) -> Tuple[str, ...]:
    if x is None:
        return ()
    if isinstance(x, str):
        return (x,)
    return tuple(x)


# when a logical dim cannot take its mesh axes (divisibility), try these
# sibling dims of the same tensor instead (the reference's rule: head_dim
# is deliberately no fallback)
_FALLBACK_ORDER = ("mlp", "embed", "vocab")


def param_spec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
               mesh, plan: Plan) -> Spec:
    """The mesh axes of each dim of one parameter, the reference's rule:
    every assignment divisibility-checked, axes that cannot land on their
    preferred dim fall back to sibling dims in ``_FALLBACK_ORDER``,
    vocab-bearing tensors shard only their vocab dim, and with
    ``plan.fsdp`` a leaf of at least 2^20 elements shards its largest
    still-unsharded dim over the FSDP axes not used yet."""
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries: list = [() for _ in shape]
    homeless: list = []  # mesh axes whose preferred dim refused them
    vocab_tensor = "vocab" in axes

    def try_assign(i: int, mesh_axes: Tuple[str, ...]) -> bool:
        dim = shape[i]
        size = _axes_of(sizes, entries[i]) * _axes_of(sizes, mesh_axes)
        if dim % size == 0 and dim >= size:
            entries[i] = entries[i] + mesh_axes
            used.update(mesh_axes)
            return True
        return False

    for i, name in enumerate(axes):
        if vocab_tensor and name != "vocab":
            continue
        for mx in _as_tuple(plan.logical.get(name)) if name else ():
            if mx in used:
                continue
            if not try_assign(i, (mx,)):
                homeless.append(mx)

    for mx in homeless:
        if mx in used or vocab_tensor:
            continue
        for fb in _FALLBACK_ORDER:
            if fb in axes and try_assign(axes.index(fb), (mx,)):
                break

    total = 1
    for d in shape:
        total *= d
    if plan.fsdp and total >= (1 << 20):
        avail = tuple(a for a in plan.fsdp_axes if a not in used)
        if avail:
            fsdp_size = _axes_of(sizes, avail)
            cand = [
                (dim, i) for i, (dim, e) in enumerate(zip(shape, entries))
                if not e and dim % fsdp_size == 0 and dim >= fsdp_size
                and not (vocab_tensor and axes[i] != "vocab")
            ]
            if cand:
                _, idx = max(cand)
                entries[idx] = avail
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """One leaf's layout on a mesh: its global ``shape`` and, for each
    dim, the mesh axes that split it (``spec``; ``()`` for none).  A rank
    holds the block of the global tensor at its coordinates along each
    dim's axes (:meth:`local`); :meth:`full` gathers the blocks back.
    ``mesh`` None is the layout of one process with no mesh: the local
    tensor is the global one."""

    mesh: Any
    spec: Spec
    shape: Tuple[int, ...]

    def local_shape(self) -> Tuple[int, ...]:
        if self.mesh is None:
            return tuple(self.shape)
        return tuple(d // self.mesh.size(e)
                     for d, e in zip(self.shape, self.spec))

    def is_replicated(self) -> bool:
        return self.mesh is None or all(self.mesh.size(e) == 1
                                        for e in self.spec)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``full``: a view (the
        tensor itself where no dim is split)."""
        if self.is_replicated():
            return full
        out = full
        for d, e in enumerate(self.spec):
            n = self.mesh.size(e)
            if n > 1:
                step = full.shape[d] // n
                out = out.narrow(d, self.mesh.index(e) * step, step)
        return out

    def full(self, local: torch.Tensor, keep: Sequence[int] = ()
             ) -> torch.Tensor:
        """The global tensor gathered from every rank's block (the local
        tensor itself where no dim is split); the dims in ``keep`` stay
        local (the expert dim of the expert-parallel MoE's weights)."""
        from repro_torch.parallel import collectives

        out = local
        for d, e in enumerate(self.spec):
            if d not in keep and self.mesh is not None \
                    and self.mesh.size(e) > 1:
                out = collectives.all_gather_dim(out, d, self.mesh, e)
        return out


def replicated(mesh, shape=()) -> Sharding:
    """The layout of a leaf every rank holds whole (the step, the Adam
    count)."""
    return Sharding(mesh, tuple(() for _ in shape), tuple(shape))


def make_param_shardings(mesh, axes_tree: Tree, specs_tree: Tree,
                         plan: Plan) -> Tree:
    """The tree of :class:`Sharding`s of ``specs_tree`` (tensors or meta
    tensors; only shapes are read) whose logical axes ``axes_tree``
    gives, in the same structure."""
    return tree_map(
        lambda spec, axes: Sharding(
            mesh, param_spec(tuple(axes), tuple(spec.shape), mesh, plan),
            tuple(spec.shape)),
        specs_tree, axes_tree)


def batch_spec(shape: Tuple[int, ...], mesh, plan: Plan) -> Spec:
    """Shard a batch input on its leading (batch) dimension over the data
    axes the mesh has, when the batch divides."""
    sizes = mesh_sizes(mesh)
    dp = [a for a in plan.dp_axes if a in sizes]
    if shape[0] % _axes_of(sizes, dp) != 0:
        dp = []
    return (tuple(dp),) + tuple(() for _ in shape[1:])


def batch_specs(batch_tree: Tree, mesh, plan: Plan) -> Tree:
    """The :class:`Sharding` of every batch input: its leading (batch)
    dim over the data axes (:func:`batch_spec`)."""
    return tree_map(lambda x: Sharding(
        mesh, batch_spec(tuple(x.shape), mesh, plan), tuple(x.shape)),
        batch_tree)


def cache_spec(shape: Tuple[int, ...], mesh, plan: Plan, batch: int,
               max_seq: int) -> Spec:
    """Decode-cache layout, the reference's rule: the batch axis over the
    data axes, the sequence axis of big K/V leaves over ``model`` (over
    data and ``model`` when the batch could not shard), and for recurrent
    state leaves (no sequence axis) the largest divisible dim over the
    ``model`` axes.  The dense decoders' sharded serving reads and
    writes the cache so (``serve/sharded.py``)."""
    sizes = mesh_sizes(mesh)
    dp = tuple(a for a in plan.dp_axes if a in sizes)
    dp_size = _axes_of(sizes, dp)
    model_axes = tuple(
        a for a in _as_tuple(plan.logical.get("heads", "model"))
        if a in sizes) or ("model",)
    entries: list = [() for _ in shape]
    used: set = set()
    batch_assigned = False
    for i, d in enumerate(shape):
        if d == batch and dp and batch % dp_size == 0 and batch >= dp_size:
            entries[i] = dp
            used.update(dp)
            batch_assigned = True
            break
    if plan.shard_cache_seq:
        for i, d in enumerate(shape):
            if not entries[i] and d == max_seq and d >= 1024:
                cand = model_axes if batch_assigned else dp + model_axes
                avail = tuple(a for a in cand if a not in used)
                if avail and d % _axes_of(sizes, avail) == 0:
                    entries[i] = avail
                    used.update(avail)
                break
    if not any(entries):
        avail = tuple(a for a in model_axes if a not in used)
        if avail:
            size = _axes_of(sizes, avail)
            cand = [(d, i) for i, d in enumerate(shape)
                    if d % size == 0 and d >= size and d != batch]
            if cand:
                _, idx = max(cand)
                entries[idx] = avail
    return tuple(entries)


def cache_specs_sharding(cache_tree: Tree, mesh, plan: Plan, batch: int,
                         max_seq: int) -> Tree:
    """The :class:`Sharding` of every decode-cache leaf
    (:func:`cache_spec`)."""
    return tree_map(lambda x: Sharding(
        mesh, cache_spec(tuple(x.shape), mesh, plan, batch, max_seq),
        tuple(x.shape)), cache_tree)


def shard_tree(tree: Tree, shardings: Tree) -> Tree:
    """Each rank's blocks of a tree of global tensors."""
    return tree_map(lambda x, s: s.local(x), tree, shardings)


def gather_tree(tree: Tree, shardings: Tree) -> Tree:
    """The global tensors of a tree of local blocks (a collective: every
    rank of the mesh calls it)."""
    return tree_map(lambda x, s: s.full(x), tree, shardings)
