"""Device meshes of the port, on ``torch.distributed``.

Counterpart of the reference package's ``launch/mesh.py``.  A
:class:`Mesh` lays the ranks of the default process group out row-major
over named axes (``init_device_mesh``) and hands out the process group
of any set of its axes.  On a CUDA device the backend is NCCL, on the
CPU gloo; there is no other.  Where no process group exists,
:func:`local_mesh` (and the other mesh functions, for a mesh of one) starts a
world of one on a ``HashStore``, so no TCP port is taken.  A world of
more than one is started by its launcher (``torchrun``, or
``init_process_group`` with an address, a world size and a rank).

The dry-run lays its meshes over a *fake* world (:func:`fake_world`):
the default group of ``torch.distributed``'s ``fake`` backend, this
process rank 0 of 256 or 512, whose collectives return at once.  Such a
mesh is a CPU mesh; nothing of it touches CUDA.  A process with a real
world never starts a fake one, nor the other way round.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


FAKE = "fake"


def is_fake_world() -> bool:
    """Whether the default process group is a fake world."""
    return dist.is_initialized() and dist.get_backend() == FAKE


def fake_world(size: int) -> None:
    """Make the default process group a fake world of ``size`` ranks,
    this process rank 0 (``FakeStore``); a fake world of another size is
    replaced.  Raises where a real world exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if not is_fake_world():
            raise RuntimeError(f"a fake world cannot start beside the real "
                               f"{dist.get_backend()} world of this process")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group(FAKE, store=FakeStore(), rank=0,
                            world_size=size)


def ensure_world(device) -> None:
    """Start a world of one on a ``HashStore`` where no process group
    exists; check that an existing one has ``device``'s backend (a fake
    world serves CPU meshes only, and raises for a CUDA device before
    touching it)."""
    device = torch.device(device)
    want = backend_for(device)
    if is_fake_world():
        if device.type != "cpu":
            raise RuntimeError(f"a {device.type} mesh cannot stand on the "
                               f"fake world of this process")
        return
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    if not dist.is_initialized():
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    have = dist.get_backend()
    if want not in have:
        raise RuntimeError(f"a {device.type} mesh needs a {want} process "
                           f"group; the default group is {have}")


class Mesh:
    """The ranks of the default process group over named axes, row-major
    (the last axis minor), as ``jax.make_mesh`` lays devices out.
    ``shape`` is ``{axis: size}`` in the mesh's order, as the reference's
    ``mesh.shape``; :meth:`coord`, :meth:`index` and :meth:`group` give
    this rank's place and its groups."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device):
        from torch.distributed.device_mesh import init_device_mesh

        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.device = torch.device(device)
        ensure_world(self.device)
        n = 1
        for d in shape:
            n *= d
        world = dist.get_world_size()
        if n != world:
            raise ValueError(f"a mesh of {tuple(shape)} ({n} ranks) on a "
                             f"world of {world}: every rank needs a place")
        self.axis_names = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(axes, shape))
        self.device_mesh = init_device_mesh(
            self.device.type, tuple(shape), mesh_dim_names=tuple(axes))
        self.rank = dist.get_rank()
        self._coords = dict(zip(axes, self.device_mesh.get_coordinate()))
        self._grid = self.device_mesh.mesh.reshape(tuple(shape)).tolist() \
            if len(shape) else []
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._orders: Dict[Tuple[str, ...], Optional[List[int]]] = {}
        # the groups of several axes, made now and in one order on every
        # rank (a new group is a collective of the whole world)
        for k in range(2, len(axes) + 1):
            for sub in itertools.combinations(self.axis_names, k):
                self._groups[sub] = self._new_group(sub)

    # ------------------------------------------------------------------
    def _ranks_along(self, axes: Tuple[str, ...], fixed: Dict[str, int]
                     ) -> List[int]:
        """The global ranks over every coordinate of ``axes`` (mesh
        order), the other axes at ``fixed``."""
        out = []
        for vals in itertools.product(*(range(self.shape[a]) for a in axes)):
            c = dict(fixed, **dict(zip(axes, vals)))
            r = self._grid
            for a in self.axis_names:
                r = r[c[a]]
            out.append(int(r))
        return out

    def _new_group(self, axes: Tuple[str, ...]):
        if len(axes) == len(self.axis_names):
            return dist.group.WORLD
        others = [a for a in self.axis_names if a not in axes]
        mine = None
        for vals in itertools.product(*(range(self.shape[a])
                                        for a in others)):
            ranks = self._ranks_along(axes, dict(zip(others, vals)))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def _key(self, axes) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.shape]
        if unknown or len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} of a mesh over {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (1 for none)."""
        out = 1
        for a in self._key(axes):
            out *= self.shape[a]
        return out

    def coord(self, axis: str) -> int:
        return self._coords[axis]

    def index(self, axes) -> int:
        """This rank's block along ``axes`` in the tuple's order, the
        first axis major (how JAX splits a dim over several axes)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self._coords[a]
        return idx

    def group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates on every axis outside ``axes``."""
        key = self._key(axes)
        if not key:
            raise ValueError("a group needs at least one axis")
        if len(key) == 1:
            return self.device_mesh.get_group(key[0])
        return self._groups[key]

    def block_order(self, axes) -> Optional[List[int]]:
        """For each rank of ``group(axes)`` in its group order, its block
        index along ``axes`` in the tuple's order; None when that is the
        group order itself (axes in the mesh's order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes not in self._orders:
            self._orders[axes] = self._block_order(axes)
        return self._orders[axes]

    def _block_order(self, axes: Tuple[str, ...]) -> Optional[List[int]]:
        ranks = dist.get_process_group_ranks(self.group(axes))
        where = {}
        for vals in itertools.product(*(range(s) for s in self.shape.values())):
            r = self._grid
            for v in vals:
                r = r[v]
            where[int(r)] = dict(zip(self.axis_names, vals))
        order = []
        for r in ranks:
            idx = 0
            for a in axes:
                idx = idx * self.shape[a] + where[r][a]
            order.append(idx)
        return None if order == list(range(len(order))) else order

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({dims}, device={self.device})"


def make_mesh(shape: Tuple[int, ...], axes: Optional[Tuple[str, ...]] = None,
              device=None) -> Mesh:
    """A mesh of ``shape`` over the world (its axes named as the
    reference names them by rank when ``axes`` is None) on ``device``
    (default ``cuda``)."""
    if axes is None:
        axes = {1: ("data",), 2: ("data", "model"),
                3: ("pod", "data", "model")}[len(shape)]
    return Mesh(tuple(shape), tuple(axes),
                "cuda" if device is None else device)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh over a fake world: 16×16
    ``("data", "model")`` (256 ranks) or 2×16×16 ``("pod", "data",
    "model")`` (512 ranks), on the CPU."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for d in shape:
        n *= d
    fake_world(n)
    return Mesh(shape, axes, "cpu")


def local_mesh(device=None) -> Mesh:
    """The ``(1, 1)`` ``("data", "model")`` mesh of one process (a world
    of one is started if none exists)."""
    return make_mesh((1, 1), ("data", "model"), device)


def _largest_divisor_at_most(n: int, cap: int) -> int:
    best = 1
    for c in range(1, min(n, cap) + 1):
        if n % c == 0:
            best = c
    return best


def fold_shape(shape: Tuple[int, ...], n: int) -> Tuple[int, ...]:
    """A planned mesh shape clamped to ``n`` ranks, the reference's fold:
    the planned shape as it is when it fits, else each dim the largest
    divisor of what is left, later axes (model) first."""
    want = 1
    for d in shape:
        want *= d
    if want <= n:
        return tuple(shape)
    dims = [1] * len(shape)
    rem = n
    for i in range(len(shape) - 1, -1, -1):
        dims[i] = _largest_divisor_at_most(rem, shape[i])
        rem //= dims[i]
    return tuple(dims)


def mesh_for_placement(shape: Tuple[int, ...], axes: Tuple[str, ...],
                       device=None) -> Mesh:
    """A planned mesh folded onto the world (:func:`fold_shape` with the
    world size in place of the reference's ``jax.device_count()``): on a
    world of one every planned mesh is all 1s; on a world whose size
    matches, the planned shape is used as it is.  The axis names stay the
    plan's, so layouts resolve unchanged."""
    device = torch.device("cuda" if device is None else device)
    ensure_world(device)
    return Mesh(fold_shape(tuple(shape), dist.get_world_size()),
                tuple(axes), device)
