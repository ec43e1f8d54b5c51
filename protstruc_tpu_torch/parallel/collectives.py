"""Differentiable collectives over a process group: what GSPMD inserts for the
JAX package's sharded models, written out for the port's.

Each function is a ``torch.autograd.Function`` whose backward is its
transpose, so a sharded model's gradients are the unsharded model's:

* :func:`all_gather` (forward) and :func:`reduce_scatter` (backward), and
  the other way round: the sp pair.  A rank's loss is its share of the
  global loss (masked means divide by counts summed over the data and
  sequence axes), so the cotangent a rank holds of a gathered tensor is its
  share too, and the shares of a block are summed on the block's owner;
* :func:`copy_to` (identity forward, all-reduce backward) and
  :func:`reduce_from` (all-reduce forward, identity backward): Megatron's
  pair for tp (Shoeybi et al. 2019, section 3).  Every tp rank computes the
  same loss, so a replicated activation entering a head-split region has a
  partial cotangent on each rank (summed by ``copy_to``), and the partial
  products leaving it are summed once (``reduce_from``);
* :func:`split_to` (this rank's chunk forward, all-gather backward): a
  replicated tensor whose chunks the tp ranks use, each its own;
* :func:`all_to_all`: chunk ``i`` along one dim to rank ``i``, the received
  chunks concatenated along another; its transpose is the same exchange with
  the two dims swapped;
* :func:`psum`: all-reduce forward and backward, a sum of shares whose
  value every rank then uses as its share.

On a group of one rank every function still issues its collective (a copy),
so a one-rank mesh runs the same code as a wide one.  ``group=None`` is no
group at all, an unsharded model's: every function is then the identity and
issues nothing (unlike ``torch.distributed``, where None names the world
group), so a module runs one body with or without a mesh.  Every rank of a group
must issue the same collectives in the same order, forward and backward:
that includes remat's recompute, which re-issues the collectives inside a
checkpointed block (``parallel/p2p.py`` states the same rule for the ring).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "reduce_scatter", "copy_to", "reduce_from", "split_to", "all_to_all",
           "psum"]


def _all_gather_tensor(out, x, group):
    # torch 2.13 renames the tensor forms; older releases have only the old
    # names (looked up per call, so a wrapper of either sees the call)
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(out, x, group=group)


def _reduce_scatter_tensor(out, x, group):
    (getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor)(out, x, group=group)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_tensor(out, x, group)
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    _reduce_scatter_tensor(out, x, group)
    return out.movedim(0, dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


def _chunk(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {n} ranks")
    return x.chunk(n, dim)[r].contiguous()


def _exchange(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} does not split over "
                         f"{n} ranks")
    send = [c.contiguous() for c in x.chunk(n, split_dim)]
    recv = [torch.empty_like(send[0]) for _ in range(n)]
    dist.all_to_all(recv, send, group=group)
    return torch.cat(recv, dim=cat_dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _chunk(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _exchange(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _exchange(g, cat_dim, split_dim, ctx.group), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` in rank order;
    backward: reduce-scatter (each block's cotangents summed on its rank)."""
    if group is None:
        return x
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """``x`` summed over the ranks, this rank's block along ``dim`` kept;
    backward: all-gather."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, dim, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; backward: the cotangent summed over ``group`` (a replicated
    activation entering a head-split region)."""
    if group is None:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (the partial products of a head-split
    region); backward: identity."""
    if group is None:
        return x
    return _ReduceFrom.apply(x, group)


def split_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk of a replicated ``x`` along ``dim``; backward:
    the chunks' cotangents gathered (no sum)."""
    if group is None:
        return x
    return _SplitTo.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    """Chunk ``i`` of ``x`` along ``split_dim`` to rank ``i``; the chunks
    received, in rank order, concatenated along ``cat_dim``.  Backward: the
    same exchange with the dims swapped."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim, cat_dim, group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, on every rank; backward: the cotangents
    summed too (each rank's use of the sum is a share of the loss)."""
    if group is None:
        return x
    return _Psum.apply(x, group)
