"""The collectives the sharded train step and the expert-parallel MoE
make, over the groups of a :class:`~repro_torch.launch.mesh.Mesh`.

Where the reference leaves communication to GSPMD, each rank here holds
its local blocks and calls these.  A gather or a reduce-scatter over a
group of one rank returns the tensor it was given, so a mesh of one
copies nothing.  All-reduces of small tensors (token counts, norms, the
router's statistics) are made on every group, one rank or more.

The autograd functions are the pairs the expert-parallel MoE and the
split dense compute need on top of ``torch.distributed.nn``'s
all-to-all: the slice of a replicated tensor and its inverse gather
(each the other's backward), Megatron's two operators — the identity
whose backward sums over a group (:func:`sum_grad`) and the sum over a
group whose backward is the identity (:func:`reduce_sum`) —, and the
mean over a group whose backward is the local share.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def all_gather_dim(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The blocks of every rank along ``axes`` concatenated on ``dim`` in
    the order of ``mesh.index(axes)``; ``x`` itself over one rank."""
    axes = _axes(axes)
    n = mesh.size(axes)
    if n == 1:
        return x
    x = x.detach()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group(axes))
    out = out.view((n,) + tuple(x.shape))
    order = mesh.block_order(axes)
    if order is not None:  # group order -> block order
        inv = [0] * n
        for g, b in enumerate(order):
            inv[b] = g
        out = out.index_select(0, torch.tensor(inv, device=out.device))
    out = out.movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= n
    return out.reshape(shape)


def reduce_scatter_dim(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axes``, of which this rank
    keeps its block of ``dim`` (``mesh.index(axes)``); ``x`` itself over
    one rank."""
    axes = _axes(axes)
    n = mesh.size(axes)
    if n == 1:
        return x
    xm = x.detach().movedim(dim, 0)
    order = mesh.block_order(axes)
    if order is not None:  # block order -> group order
        xm = xm.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
        xm = xm.index_select(0, torch.tensor(order, device=x.device))
        xm = xm.flatten(0, 1)
    xm = xm.contiguous()
    out = xm.new_empty((xm.shape[0] // n,) + tuple(xm.shape[1:]))
    dist.reduce_scatter_tensor(out, xm, op=dist.ReduceOp.SUM,
                               group=mesh.group(axes))
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, mesh, axes,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` summed (or ``op``) over the ranks along ``axes``, in place;
    made on a group of one rank too."""
    axes = _axes(axes)
    if axes:
        y = x if x.is_contiguous() else x.contiguous()
        dist.all_reduce(y, op=op, group=mesh.group(axes))
        if y is not x:
            x.copy_(y)
    return x


def slice_block(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """This rank's block of ``dim`` along ``axes`` (a view)."""
    n = mesh.size(axes)
    if n == 1:
        return x
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.index(_axes(axes)) * step, step)


class _Scatter(torch.autograd.Function):
    """Forward: this rank's block of a tensor every rank of the group
    holds alike.  Backward: the blocks' gradients gathered, so the
    replicated tensor upstream gets every rank's share."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return slice_block(x, dim, mesh, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), *ctx.args), None, None, None


class _Gather(torch.autograd.Function):
    """Forward: the blocks of the group gathered along ``dim``.
    Backward: this rank's block of the gradient (downstream every rank
    computes the same, so the blocks' gradients are not summed)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.args = (dim, mesh, axes)
        return all_gather_dim(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return slice_block(g, *ctx.args).contiguous(), None, None, None


class _SumGrad(torch.autograd.Function):
    """Forward: the identity.  Backward: the gradient summed over the
    group (a replicated weight used on each rank's own tokens)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), *ctx.args), None, None


class _ReduceSum(torch.autograd.Function):
    """Forward: the sum over the group (each rank's partial term of a
    product split over it).  Backward: the identity (downstream every
    rank computes the same, so each term gets the sum's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.detach().clone(
            memory_format=torch.contiguous_format), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Mean(torch.autograd.Function):
    """Forward: the mean over the group.  Backward: the local share
    (gradient over the group size); the gradients of the ranks' own
    inputs add up, through the step's reduction, to the mean's."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = mesh.size(axes)
        out = all_reduce(x.detach().clone(), mesh, axes)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def scatter(x, dim: int, mesh, axes):
    return x if mesh.size(axes) == 1 else _Scatter.apply(x, dim, mesh, axes)


def gather(x, dim: int, mesh, axes):
    return x if mesh.size(axes) == 1 else _Gather.apply(x, dim, mesh, axes)


def sum_grad(x, mesh, axes):
    return x if mesh.size(axes) == 1 else _SumGrad.apply(x, mesh, axes)


def reduce_sum(x, mesh, axes):
    """``x`` summed over the ranks along ``axes``, its gradient passed
    through unchanged; ``x`` itself over one rank."""
    return x if mesh.size(axes) == 1 else _ReduceSum.apply(x, mesh, axes)


def mean(x, mesh, axes: Sequence[str]):
    """The mean of ``x`` over the ranks along ``axes``; its gradient on
    each rank is the local share."""
    if not axes or mesh.size(axes) == 1:
        return x
    return _Mean.apply(x, mesh, axes)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x``'s ``n`` equal chunks along dim 0 exchanged over ``axis``
    (chunk ``j`` to the rank at index ``j``; the result's chunk ``j``
    from that rank), differentiable; ``x`` itself over one rank."""
    if mesh.size(axis) == 1:
        return x
    from torch.distributed.nn.functional import all_to_all_single

    out = x.new_empty(x.shape)
    return all_to_all_single(out, x.contiguous(), group=mesh.group(axis))
