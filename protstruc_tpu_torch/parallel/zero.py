"""Data parallelism with ZeRO-1 (port of ``protstruc_tpu/parallel/zero.py``).

The JAX package shards the Adam moments with NamedShardings and lets GSPMD
insert the traffic; here it is written out for a ``dp`` process group:

* each rank takes its ``B / dp`` structures of the same global batch;
* the losses are masked means over the whole batch, so a rank's mean of its
  shard is not ``1 / dp`` of the global mean when its mask counts differ.
  The trainer hands the losses its dp group (their ``count_group``
  argument) and every masked-mean denominator (:func:`mean_denominator`) is
  the count summed over it, so each rank's loss is its share of the global
  loss, the shares sum to it, and the summed gradients are the
  single-process gradients;
* :func:`all_reduce_` sums gradients (one flat buffer); a sharded model's
  (``FoldModel(mesh=)``) are summed by :func:`sum_sharded_grads_`: over its
  dp x sp ranks, whose losses are shares of one loss, and, for the
  replicated leaves each tp rank uses in part (its heads' slice), over tp
  too; a leaf split over tp, or used whole by every tp rank, is not summed
  over tp (it would count tp times);
* ZeRO-1 (Rajbhandari et al. 2020, section 5.1): :func:`zero1_owners` gives
  every parameter one owner rank, largest first onto the least-loaded rank
  (each rank then holds about 1/dp of the moment bytes, within one leaf);
  the owner alone keeps its AdamW moments and updates it, and
  :func:`broadcast_from_owners_` sends the updated parameters to every rank.
  Under a sharded model the owners are ranks of the dp group, within each
  (sp, tp) coordinate, whose ranks hold the same chunks.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

__all__ = ["mean_denominator", "all_reduce_", "sum_sharded_grads_", "zero1_owners",
           "broadcast_from_owners_"]

def mean_denominator(count: torch.Tensor, group=None) -> torch.Tensor:
    """``max(count, 1)`` for a masked mean, the count first summed over the
    data-parallel ``group`` unless it is None (the count carries no
    gradient)."""
    if group is not None:
        count = count.detach().float().clone()
        dist.all_reduce(count, group=group)
    return torch.clamp_min(count, 1.0)


def all_reduce_(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, through one flat buffer."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    o = 0
    for t in tensors:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


def sum_sharded_grads_(grads: Dict[str, torch.Tensor], shard, tp_partial=()) -> None:
    """Sum a sharded model's gradients (by name) in place: every leaf over
    ``shard.data_group`` (dp x sp), the leaves named in ``tp_partial``
    (``models.ipa.tp_partial_grads``) over ``shard.tp_group`` as well."""
    all_reduce_(list(grads.values()), shard.data_group)
    all_reduce_([g for k, g in grads.items() if k in tp_partial], shard.tp_group)


def zero1_owners(params: Dict[str, torch.Tensor], n: int) -> Dict[str, int]:
    """Each parameter's owner rank among ``n``: largest first, each onto the
    rank holding the fewest bytes so far (ties to the lower rank)."""
    load = [0] * n
    owners = {}
    for name in sorted(params, key=lambda k: (-params[k].numel(), k)):
        r = min(range(n), key=lambda i: (load[i], i))
        owners[name] = r
        load[r] += params[name].numel() * params[name].element_size()
    return owners


def broadcast_from_owners_(params: Dict[str, torch.Tensor], owners: Dict[str, int],
                           group) -> None:
    """Every rank gets each parameter as its owner holds it: one broadcast
    an owner, of its parameters flattened."""
    n = dist.get_world_size(group)
    for r in range(n):
        mine: List[torch.Tensor] = [params[k] for k in params if owners[k] == r]
        if not mine:
            continue
        flat = torch.cat([p.detach().reshape(-1) for p in mine])
        dist.broadcast(flat, src=dist.get_global_rank(group, r) if group is not None else r,
                       group=group)
        o = 0
        with torch.no_grad():
            for p in mine:
                p.copy_(flat[o:o + p.numel()].view_as(p))
                o += p.numel()
