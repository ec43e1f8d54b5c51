"""Gradient-based structure relaxation, port of ``protstruc_tpu/ops/relax.py``.

Minimize a differentiable energy over atom positions: harmonic backbone
bonded terms (ideal bond lengths and planar angles, ``constants/ideal.py``)
+ the steric clash wall (``ops/pack.clash_energy``) + a harmonic restraint on
intra-residue covalent geometry + a harmonic tether to the start.  The JAX
package's ``lax.scan`` over optax Adam steps is a loop of ``n_steps`` Adam
steps (b1 0.9, b2 0.999, eps 1e-8 outside the square root) on gradients from
``torch.autograd.grad``.  NaN (missing) atoms are frozen and never
contribute: the energies read them through ``where``/``nan_to_num``, whose
backward gives them zero gradient, and the gradient is masked as well.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from protstruc_tpu_torch.constants import ideal

__all__ = ["backbone_bonded_energy", "intra_residue_restraint_energy", "relax_structure"]

# Engh & Huber (1991) peptide-bond planar angles, radians
_ACN_NEXT = 2.0281  # Ca-C-N(i+1), 116.2 deg
_CNA_NEXT = 2.1242  # C(i)-N-Ca,   121.7 deg


def _cos32(rad: float) -> float:
    """``jnp.cos`` of a Python angle: the float32 cosine of the float32 angle."""
    return float(np.float32(math.cos(float(np.float32(rad)))))


def _angle_cos(a, b, c):
    """cos of the planar angle at b: smooth everywhere (no arccos)."""
    u = a - b
    v = c - b
    denom = torch.sqrt(torch.clamp_min((u * u).sum(-1) * (v * v).sum(-1), 1e-12))
    return (u * v).sum(-1) / denom


def backbone_bonded_energy(xyz: torch.Tensor, atom_mask: torch.Tensor,
                           chain_idx: torch.Tensor) -> torch.Tensor:
    """Harmonic bonded energy of the backbone, ``(B,)``.

    Bond lengths N-CA, CA-C, C-O, CA-CB and the peptide C(i)-N(i+1); planar
    angles N-CA-C, CA-C-O and the Engh-Huber peptide angles CA-C-N(i+1),
    C(i)-N-CA, harmonic in cos(angle).  Cross-residue terms are masked at
    chain breaks via ``chain_idx``.
    """
    ok = atom_mask & torch.isfinite(xyz).all(-1)  # (B, L, A)
    okn, okca, okc, oko, okcb = (ok[:, :, i] for i in range(5))
    n, ca, c, o, cb = (torch.nan_to_num(xyz[:, :, i], nan=0.0) for i in range(5))

    def bond(a, b, m, target):
        d = torch.sqrt(((a - b) ** 2).sum(-1) + 1e-12)
        return torch.where(m, (d - target) ** 2, 0.0).sum(1)

    def angle(a, b, c_, m, target_rad):
        cth = _angle_cos(a, b, c_)
        return torch.where(m, (cth - _cos32(target_rad)) ** 2, 0.0).sum(1)

    e = bond(n, ca, okn & okca, ideal.NA)
    e = e + bond(ca, c, okca & okc, ideal.AC)
    e = e + bond(c, o, okc & oko, ideal.CO)
    e = e + bond(ca, cb, okca & okcb, ideal.AB)
    e = e + angle(n, ca, c, okn & okca & okc, ideal.NAC)
    e = e + angle(ca, c, o, okca & okc & oko, ideal.ACO)

    # cross-residue: same chain, both residues present
    same = chain_idx[:, :-1] == chain_idx[:, 1:]
    n_next, ca_next = n[:, 1:], ca[:, 1:]
    link = same & okc[:, :-1] & okn[:, 1:]
    e = e + bond(c[:, :-1], n_next, link, ideal.C_N)
    e = e + angle(ca[:, :-1], c[:, :-1], n_next, link & okca[:, :-1], _ACN_NEXT)
    e = e + angle(c[:, :-1], n_next, ca_next, link & okca[:, 1:], _CNA_NEXT)
    return e


def intra_residue_restraint_energy(xyz: torch.Tensor, x0: torch.Tensor,
                                   pair_ok: torch.Tensor) -> torch.Tensor:
    """Harmonic restraint holding intra-residue covalent geometry, ``(B,)``.

    Bonds are identified from the INITIAL structure: intra-residue atom
    pairs closer than 2.0 A at start are restrained to their initial
    distance with weight 1 (covalent bonds), pairs in [2.0, 2.8) with weight
    0.25 (1-3 pairs, holds the angles).
    """
    d0 = torch.sqrt(((x0[:, :, :, None] - x0[:, :, None, :]) ** 2).sum(-1) + 1e-12)
    w = torch.where(d0 < 2.0, 1.0, torch.where(d0 < 2.8, 0.25, 0.0))
    A = xyz.shape[2]
    upper = torch.ones((A, A), dtype=torch.bool, device=xyz.device).triu(1)
    w = torch.where(pair_ok & upper[None, None], w, 0.0)
    d = torch.sqrt(((xyz[:, :, :, None] - xyz[:, :, None, :]) ** 2).sum(-1) + 1e-12)
    return (w * (d - d0) ** 2).sum((1, 2, 3))


def relax_structure(xyz: torch.Tensor, atom_mask: torch.Tensor, seq_idx: torch.Tensor,
                    chain_idx: torch.Tensor = None, n_steps: int = 200,
                    learning_rate: float = 2e-3, clash_weight: float = 1.0,
                    bonded_weight: float = 10.0, tether_weight: float = 0.1,
                    intra_weight: float = 10.0) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Minimize bonded + clash + intra-residue + tether energy over atom
    coordinates.

    Returns ``(relaxed_xyz, energies)``: ``energies`` holds the per-structure
    ``(B,)`` initial/final totals and bonded/clash components.  Missing
    (NaN) atoms stay NaN; every finite atom moves.
    """
    from protstruc_tpu_torch.ops.pack import clash_energy

    if chain_idx is None:
        chain_idx = torch.zeros(xyz.shape[:2], dtype=torch.int32, device=xyz.device)
    finite = torch.isfinite(xyz).all(-1, keepdim=True)
    x0 = torch.nan_to_num(xyz.detach(), nan=0.0)
    present = atom_mask & finite[..., 0]
    intra_ok = present[:, :, :, None] & present[:, :, None, :]
    moving = finite & atom_mask[..., None]

    def total(x):
        xb = torch.where(finite, x, torch.nan)  # keep missing-atom semantics
        eb = backbone_bonded_energy(xb, atom_mask, chain_idx)
        ec = clash_energy(xb, atom_mask, seq_idx)
        ei = intra_residue_restraint_energy(x, x0, intra_ok)
        et = torch.where(moving, (x - x0) ** 2, 0.0).sum((1, 2, 3))
        return (bonded_weight * eb + clash_weight * ec + intra_weight * ei
                + tether_weight * et), eb, ec

    with torch.no_grad():
        e0, eb0, ec0 = total(x0)
    x = x0.clone().requires_grad_(True)
    opt = torch.optim.Adam([x], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, foreach=False)
    for _ in range(n_steps):
        with torch.enable_grad():
            (g,) = torch.autograd.grad(total(x)[0].sum(), x)
        x.grad = torch.where(moving, g, 0.0)
        opt.step()
    x = x.detach()
    with torch.no_grad():
        e1, eb1, ec1 = total(x)
    relaxed = torch.where(finite, x, torch.nan)
    return relaxed, {"initial": e0, "final": e1, "bonded_initial": eb0, "bonded_final": eb1,
                     "clash_initial": ec0, "clash_final": ec1}
