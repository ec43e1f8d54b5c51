"""Backbone idealization: gradient-based geometry regularization, port of
``protstruc_tpu/ops/idealize.py``.

Minimize the deviation of an approximate backbone (e.g. the MDS
initialization of ``ops/reconstruct.py``) from ideal bond lengths and angles
under a restraint to the input.  The JAX package's ``lax.scan`` over optax
Adam steps is a loop of ``torch.optim.Adam`` steps (b1 0.9, b2 0.999, eps
1e-8 outside the square root, ``foreach=False``) on gradients from
``torch.autograd.grad``, as ``ops/relax.py`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.constants import ideal

__all__ = ["ideality_loss", "idealize_backbone"]

# Engh & Huber peptide angles, radians: CA-C-N' 116.2 deg, C-N'-CA' 121.7 deg
_ACN_NEXT = 2.0281
_CNA_NEXT = 2.1242


def _sanitize(coords: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked or NaN residues swapped for a fixed non-degenerate dummy
    backbone (atoms at (0,0,0), (1,0,0), (1,1,0), (1,1,1), residues 10 A
    apart along x): every bond and angle term stays finite and the swapped
    residues carry no dependence on the input, so their gradient is 0."""
    L, A = coords.shape[-3], coords.shape[-2]
    offs = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [1.0, 1.0, 1.0]],
                        dtype=coords.dtype, device=coords.device)[:A]
    ar = torch.arange(L, dtype=coords.dtype, device=coords.device) * 10.0
    zero = torch.zeros(L, dtype=coords.dtype, device=coords.device)
    dummy = offs[None] + torch.stack([ar, zero, zero], dim=-1)[:, None]
    return torch.where(mask[..., None, None], torch.nan_to_num(coords, nan=0.0), dummy)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


def ideality_loss(coords: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  restraint: Optional[torch.Tensor] = None, restraint_weight: float = 0.1,
                  chain_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared deviation from ideal backbone geometry.

    ``coords``: ``(..., L, 4, 3)`` N/CA/C/O (3 atoms skip the carbonyl term).
    Terms: N-CA, CA-C, C-N' bond lengths; N-CA-C, CA-C-N', C-N'-CA' angles;
    C-O; an optional coordinate restraint.  NaN or masked residues are
    excluded gradient-safely (``_sanitize``); ``chain_idx`` drops the
    cross-residue terms at chain boundaries.
    """
    finite = torch.isfinite(coords).all(-1).all(-1)
    mask = finite if mask is None else mask & finite
    cs = _sanitize(coords, mask)
    n, ca, c = cs[..., 0, :], cs[..., 1, :], cs[..., 2, :]
    m = mask.to(coords.dtype)
    pair_m = m[..., :-1] * m[..., 1:]
    if chain_idx is not None:
        pair_m = pair_m * (chain_idx[..., :-1] == chain_idx[..., 1:]).to(coords.dtype)

    loss = (m * (_norm(ca - n) - ideal.NA) ** 2).sum()
    loss = loss + (m * (_norm(c - ca) - ideal.AC) ** 2).sum()
    loss = loss + (pair_m * (_norm(n[..., 1:, :] - c[..., :-1, :]) - ideal.C_N) ** 2).sum()
    loss = loss + (m * (geom.angle(n, ca, c) - ideal.NAC) ** 2).sum()
    loss = loss + (pair_m * (geom.angle(ca[..., :-1, :], c[..., :-1, :], n[..., 1:, :])
                             - _ACN_NEXT) ** 2).sum()
    loss = loss + (pair_m * (geom.angle(c[..., :-1, :], n[..., 1:, :], ca[..., 1:, :])
                             - _CNA_NEXT) ** 2).sum()
    if coords.shape[-2] >= 4:
        loss = loss + (m * (_norm(cs[..., 3, :] - c) - ideal.CO) ** 2).sum()
    if restraint is not None:
        loss = loss + restraint_weight * (
            m[..., None, None] * (cs - torch.nan_to_num(restraint, nan=0.0)) ** 2).sum()
    return loss


def idealize_backbone(coords: torch.Tensor, mask: Optional[torch.Tensor] = None,
                      n_steps: int = 200, lr: float = 1e-2, restraint_weight: float = 0.1,
                      chain_idx: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam-minimize :func:`ideality_loss` with a restraint to the input for
    ``n_steps`` steps.  Returns ``(refined_coords, final_loss)``.  Masked
    and NaN residues get zero gradient and keep their input values (NaN
    stays NaN)."""
    coords = coords.detach().float().contiguous()
    restraint = coords

    def loss_of(x):
        return ideality_loss(x, mask, restraint, restraint_weight, chain_idx=chain_idx)

    x = coords.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    for _ in range(n_steps):
        with torch.enable_grad():
            (g,) = torch.autograd.grad(loss_of(x), x)
        x.grad = g
        opt.step()
    x = x.detach()
    with torch.no_grad():
        return x, loss_of(x)
