"""Mixture-of-Experts MLP with expert parallelism (port of
``protstruc_tpu/models/moe.py``).

Switch-style top-1 routing in the one-hot formulation: each token goes to
its router's argmax expert, into that expert's next capacity slot (``C =
max(int(1.25 T / E), 1)`` slots an expert, tokens past it dropped); the
dispatch and combine tensors are one-hots ``(T, E, C)``, the experts run as
batched products ``(E, C, D) x (E, D, H)``, and the output is each kept
token's expert output weighted by its router probability.  The auxiliary
load-balancing loss is Switch Transformer's ``E sum_e f_e p_e`` over the
valid tokens.  As in flax (whose Dense and einsums promote to the float32
parameters), the router and the experts compute in float32 and the output is
float32.

Over a ``(dp, sp, tp)`` mesh (``MoEMLP(..., mesh=)``) the layer takes this
rank's tokens, ``B / dp`` structures and ``L / sp`` rows, and computes what
the layer computes over the whole batch, as GSPMD does in the JAX package:

* a token's capacity slot is its place among the whole batch's tokens
  routed to its expert (structure-major, rows in order), from the counts
  of the tokens before it on other ranks (two small all-gathers), and ``C``
  counts the whole batch's tokens;
* ``ep_axis="dp"`` (``moe_param_shardings``): each dp rank holds ``E / dp``
  experts.  A rank places its tokens in every expert's slots (the one-hot
  dispatch), sums them over sp, and an all-to-all over dp sends each
  expert's slots to its owner, which sums what arrives; the owners'
  outputs come back by an all-gather and each rank combines its own
  tokens.  Without ``ep_axis`` every rank holds every expert and the
  dispatched slots are summed over dp x sp;
* the load-balancing loss is taken over all valid tokens (the router's
  sums and counts summed over dp x sp): every rank returns the global aux,
  whose backward counts it once over those ranks (a rank's loss share adds
  ``aux / (dp * sp)``, ``models.trfold.moe_aux_share``).

The ranks of tp compute the same layer.  Without a mesh every collective
is the identity and the slot offsets are 0: one body serves both.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from protstruc_tpu_torch.batch import resolve_device
from protstruc_tpu_torch.models._nn import Dense, gelu, lecun_normal_
from protstruc_tpu_torch.parallel.collectives import all_gather, all_to_all, psum
from protstruc_tpu_torch.parallel.mesh import UNSHARDED

__all__ = ["MoEMLP", "moe_param_shardings"]


class MoEMLP(nn.Module):
    """Top-1 routed expert MLP over the token axis: ``(x (B, L, D), mask (B,
    L) bool) -> (out (B, L, D) float32, aux ())``; flax's tree ``router.{kernel,
    bias}``, ``w1 (E, D, H)``, ``b1 (E, H)``, ``w2 (E, H, D)``, ``b2 (E, D)``.

    ``mesh``: a ``(dp, sp, tp)`` mesh whose data axes shard the tokens
    (module docstring); ``ep_axis``: ``"dp"``, the axis the experts split
    over (this rank then holds ``E / dp`` of them, its chunk of the whole
    draws), or None."""

    def __init__(self, dim: int, n_experts: int = 4, hidden_dim: int = 128,
                 capacity_factor: float = 1.25, device="cuda", mesh=None,
                 ep_axis: Optional[str] = None):
        super().__init__()
        device = resolve_device(device)
        E, D, H = n_experts, dim, hidden_dim
        self.n_experts, self.capacity_factor = E, capacity_factor
        if ep_axis not in (None, "dp"):
            raise ValueError(f"ep_axis must be 'dp' or None, got {ep_axis!r}")
        if ep_axis is not None and mesh is None:
            raise ValueError("ep_axis needs a mesh")
        self.shard = UNSHARDED
        if mesh is not None:
            from protstruc_tpu_torch.parallel.mesh import model_shard

            self.shard = model_shard(mesh)
        # the expert-parallel group and this rank's place in it
        self.ep, (self.ep_index, n_ep) = None, (0, 1)
        if ep_axis is not None:
            self.ep, (self.ep_index, n_ep) = self.shard.dp_group, self.shard.dp
        if E % n_ep:
            raise ValueError(f"{E} experts do not split over {ep_axis}={n_ep}")
        El = E // n_ep
        self.router = Dense(D, E, torch.float32, device)
        self.w1 = nn.Parameter(torch.empty((El, D, H), device=device))
        self.b1 = nn.Parameter(torch.zeros((El, H), device=device))
        self.w2 = nn.Parameter(torch.empty((El, H, D), device=device))
        self.b2 = nn.Parameter(torch.zeros((El, D), device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The experts, then the router, from ``gen`` (a model that walks its
        modules draws the router once more after this)."""
        # flax lecun_normal on (E, in, out): fan_in = in x E (the expert axis
        # counts as receptive field); an expert-parallel rank keeps its chunk
        # of the whole draws
        E, El, (_, D, H) = self.n_experts, self.w1.shape[0], self.w1.shape
        for w, fan_in in ((self.w1, D * E), (self.w2, H * E)):
            whole = torch.empty((E,) + tuple(w.shape[1:]), device=w.device)
            lecun_normal_(whole, gen, fan_in)
            with torch.no_grad():
                w.copy_(whole[self.ep_index * El:(self.ep_index + 1) * El])
        nn.init.zeros_(self.b1)
        nn.init.zeros_(self.b2)
        self.router.reset_parameters(gen)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        sh = self.shard
        B, L, D = x.shape
        E = self.n_experts
        T = B * L
        C = max(int(self.capacity_factor * T * sh.dp[1] * sh.sp[1] / E), 1)
        xt = x.reshape(T, D).float()
        valid = mask.reshape(T).float()

        probs = torch.softmax(self.router(xt), dim=-1)              # (T, E)
        top_prob, top = probs.max(-1)
        onehot = F.one_hot(top, E).float() * valid[:, None]
        pos = self._slots(onehot, B, L)
        keep = (pos >= 0) & (pos < C)
        slot = torch.clamp(pos, 0, C - 1).long()
        dispatch = F.one_hot(slot, C).float() * keep[..., None]     # (T, E, C)
        combine = dispatch * top_prob[:, None, None]

        part = torch.einsum("tec,td->ecd", dispatch, xt)             # this rank's slots
        if self.ep is None:
            expert_in = psum(part, sh.data_group)
        else:  # summed over sp, then every expert's slots to its owner over dp
            part = psum(part, sh.sp_group)
            n = E // self.w1.shape[0]
            expert_in = all_to_all(part.reshape((n, E // n) + tuple(part.shape[1:])), 0, 0,
                                   self.ep).sum(0)
        h = gelu(torch.einsum("ecd,edh->ech", expert_in, self.w1) + self.b1[:, None, :])
        expert_out = torch.einsum("ech,ehd->ecd", h, self.w2) + self.b2[:, None, :]
        expert_out = all_gather(expert_out, 0, self.ep)
        out = torch.einsum("tec,ecd->td", combine, expert_out)

        # load balancing over every VALID token of the batch (Switch
        # Transformer eq. 4)
        with torch.no_grad():
            n_valid = torch.clamp_min(psum(valid.sum(), sh.data_group), 1.0)
            frac_tokens = psum(onehot.sum(0), sh.data_group) / n_valid
        frac_probs = psum((probs * valid[:, None]).sum(0), sh.data_group) / n_valid
        aux = E * (frac_tokens * frac_probs).sum()
        return out.reshape(B, L, D), aux

    def _slots(self, onehot: torch.Tensor, B: int, L: int) -> torch.Tensor:
        """Each local token's 0-based slot within its expert among the whole
        batch's tokens (structure-major, rows in order), -1 where not routed:
        the local running count plus the counts of the tokens before this
        rank's rows (lower sp ranks, same structure) and before its
        structures (every rank of earlier structures)."""
        sh = self.shard
        E = self.n_experts
        cnt = onehot.reshape(B, L, E)
        with torch.no_grad():
            c = cnt.sum(1)                                          # (B, E)
            per_sp = all_gather(c[None], 0, sh.sp_group)             # (sp, B, E)
            before_rows = per_sp[:sh.sp[0]].sum(0)
            per_b = all_gather(per_sp.sum(0), 0, sh.dp_group)        # (dp * B, E)
            before_b = torch.cumsum(per_b, 0) - per_b
            offset = before_b[sh.dp[0] * B:(sh.dp[0] + 1) * B] + before_rows
        pos = (torch.cumsum(cnt, dim=1) + offset[:, None, :]) * cnt - 1.0
        return pos.reshape(B * L, E)


def moe_param_shardings(params, mesh=None, ep_axis: str = "dp") -> Dict[str, tuple]:
    """Each leaf's split by parameter name: the leading expert axis of the
    leaves whose final name is ``w1``, ``w2``, ``b1`` or ``b2`` over
    ``ep_axis``, everything else replicated (JAX
    ``protstruc_tpu/models/moe.py:80-95``, as ``PartitionSpec`` tuples).
    The exact final name: a substring would also hit names that merely
    contain one (``row1``).  ``mesh`` is accepted for the JAX signature."""
    def spec_for(name, x):
        if name.split(".")[-1] in ("w1", "w2", "b1", "b2"):
            return (ep_axis,) + (None,) * (x.ndim - 1)
        return ()

    return {k: spec_for(k, v) for k, v in params.items()}
