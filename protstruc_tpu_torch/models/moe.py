"""Mixture-of-Experts MLP on one device (port of ``protstruc_tpu/models/moe.py``).

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

Expert parallelism (``moe_param_shardings``: the expert axis over a mesh
axis, with all-to-alls) is not ported yet: calling it raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from protstruc_tpu_torch.batch import resolve_device
from protstruc_tpu_torch.models._nn import Dense, gelu, lecun_normal_

__all__ = ["MoEMLP", "moe_param_shardings"]


class MoEMLP(nn.Module):
    """Top-1 routed expert MLP over the token axis: ``(x (B, L, D), mask (B,
    L) bool) -> (out (B, L, D) float32, aux ())``; flax's tree ``router.{kernel,
    bias}``, ``w1 (E, D, H)``, ``b1 (E, H)``, ``w2 (E, H, D)``, ``b2 (E, D)``."""

    def __init__(self, dim: int, n_experts: int = 4, hidden_dim: int = 128,
                 capacity_factor: float = 1.25, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        E, D, H = n_experts, dim, hidden_dim
        self.n_experts, self.capacity_factor = E, capacity_factor
        self.router = Dense(D, E, torch.float32, device)
        self.w1 = nn.Parameter(torch.empty((E, D, H), device=device))
        self.b1 = nn.Parameter(torch.zeros((E, H), device=device))
        self.w2 = nn.Parameter(torch.empty((E, H, D), device=device))
        self.b2 = nn.Parameter(torch.zeros((E, D), device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax lecun_normal on (E, in, out): fan_in = in x E (the expert axis
        # counts as receptive field)
        E, D, H = self.w1.shape
        lecun_normal_(self.w1, gen, D * E)
        lecun_normal_(self.w2, gen, H * E)
        nn.init.zeros_(self.b1)
        nn.init.zeros_(self.b2)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L, D = x.shape
        E = self.n_experts
        T = B * L
        C = max(int(self.capacity_factor * T / E), 1)
        xt = x.reshape(T, D).float()
        valid = mask.reshape(T).float()

        probs = torch.softmax(self.router(xt), dim=-1)              # (T, E)
        top_prob, top = probs.max(-1)
        onehot = F.one_hot(top, E).float() * valid[:, None]
        # each token's slot within its expert; -1 where not routed
        pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
        keep = (pos >= 0) & (pos < C)
        slot = torch.clamp(pos, 0, C - 1).long()
        dispatch = F.one_hot(slot, C).float() * keep[..., None]     # (T, E, C)
        combine = dispatch * top_prob[:, None, None]

        expert_in = torch.einsum("tec,td->ecd", dispatch, xt)
        h = gelu(torch.einsum("ecd,edh->ech", expert_in, self.w1) + self.b1[:, None, :])
        expert_out = torch.einsum("ech,ehd->ecd", h, self.w2) + self.b2[:, None, :]
        out = torch.einsum("tec,ecd->td", combine, expert_out)

        # load balancing over the VALID tokens (Switch Transformer eq. 4)
        n_valid = torch.clamp_min(valid.sum(), 1.0)
        frac_tokens = onehot.sum(0) / n_valid
        frac_probs = (probs * valid[:, None]).sum(0) / n_valid
        aux = E * (frac_tokens * frac_probs).sum()
        return out.reshape(B, L, D), aux


def moe_param_shardings(params, mesh, ep_axis: str = "dp"):
    """Expert parallelism (the expert axis of ``w1``/``b1``/``w2``/``b2``
    over ``ep_axis``) is not ported yet (ROADMAP A.8)."""
    raise NotImplementedError("moe_param_shardings (MoE expert parallelism) is not yet ported "
                              "(ROADMAP A.8)")
