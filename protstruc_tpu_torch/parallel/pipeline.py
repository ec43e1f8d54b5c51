"""GPipe pipeline parallelism over a ``pp`` process group (port of
``protstruc_tpu/parallel/pipeline.py``).

Rank d of the group holds stage d.  The schedule is the JAX package's, tick
for tick: ``S + M - 1`` ticks over M microbatches; at every tick each rank
passes its activation to rank d + 1 (a differentiable exchange,
``parallel/p2p.py``) and runs its stage on what it received (stage 0 on
microbatch t), and the last stage keeps microbatch ``t - (S - 1)``.  Bubble
ticks compute on stale activations and are discarded, as in JAX; every rank
issues the same operations in the same order, so the exchanges of the
backward pair up too.  The outputs are summed over the group from the last
stage (JAX's ``psum``) and so replicated on every rank.

Gradients: a stage's parameters get theirs on the stage's rank; the input's
gradient lands on rank 0 (stage 0 reads it).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.distributed as dist

from protstruc_tpu_torch.parallel.p2p import finish_rotation, post_rotation, replicate_sum

__all__ = ["pipeline_forward", "stack_stage_params"]


def stack_stage_params(params_list: Sequence[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-stage parameter dicts (the same keys and shapes) -> one dict of
    tensors with a leading stage axis (differentiable: each stage's slice
    leads back to its source)."""
    keys = list(params_list[0])
    for p in params_list[1:]:
        if list(p) != keys:
            raise ValueError("every stage needs the same parameter names")
    return {k: torch.stack([p[k] for p in params_list]) for k in keys}


def _flatten(acts: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.cat([v.reshape(-1) for v in acts.values()])


def _unflatten(flat: torch.Tensor, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out, o = {}, 0
    for k, v in like.items():
        out[k] = flat[o:o + v.numel()].view(v.shape)
        o += v.numel()
    return out


def pipeline_forward(stage_fn: Callable, stage_params: Dict[str, torch.Tensor], x, group=None):
    """Run ``stage_fn`` once per stage, one stage a rank of ``group`` (all
    ranks when None), over M microbatches.

    Args:
      stage_fn: ``(params of one stage, activation dict) -> activation
        dict`` of the same keys, shapes and (floating) dtype on every stage.
      stage_params: tensors with a leading stage axis S = the group's size
        (:func:`stack_stage_params`); rank d runs ``{k: v[d]}``.
      x: the microbatched input, a tensor or ``{name: tensor}`` of ``(M, mb,
        ...)``, the same on every rank (``stage_fn`` then takes and returns
        a tensor or such a dict).

    Returns the outputs in ``x``'s structure, replicated on every rank.
    """
    if isinstance(x, torch.Tensor):
        out = pipeline_forward(lambda p, a: {"x": stage_fn(p, a["x"])}, stage_params,
                               {"x": x}, group)
        return out["x"]
    S = dist.get_world_size(group) if dist.is_initialized() else 1
    d = dist.get_rank(group) if S > 1 else 0
    n_stages = next(iter(stage_params.values())).shape[0]
    if n_stages != S:
        raise ValueError(f"{n_stages} stages for a pipeline group of {S} ranks")
    M = next(iter(x.values())).shape[0]
    p_me = {k: v[d] for k, v in stage_params.items()}
    dev = next(iter(x.values())).device
    first = torch.tensor(d == 0, device=dev)
    last = torch.tensor(d == S - 1, device=dev)
    if S > 1:
        glob = (lambda i: i) if group is None else (lambda i: dist.get_global_rank(group, i))
        to, frm = glob((d + 1) % S), glob((d - 1) % S)

    like = {k: v[0] for k, v in x.items()}
    state = {k: torch.zeros_like(v) for k, v in like.items()}
    outs: List[Dict[str, torch.Tensor]] = [None] * M
    for t in range(S + M - 1):
        if S > 1:  # activations advance one stage a tick
            recv = _unflatten(finish_rotation(post_rotation(_flatten(state), group, to, frm,
                                                            2 * t)), like)
        else:
            recv = state
        feed = {k: v[min(t, M - 1)] for k, v in x.items()}
        inp = {k: torch.where(first, feed[k], recv[k]) for k in like}
        state = stage_fn(p_me, inp)
        if t >= S - 1:  # the last stage emits microbatch t - (S - 1)
            outs[t - (S - 1)] = {k: torch.where(last, state[k], torch.zeros_like(state[k]))
                                 for k in like}
    stacked = {k: torch.stack([o[k] for o in outs]) for k in like}
    if S == 1:
        return stacked
    return {k: replicate_sum(v, group) for k, v in stacked.items()}
