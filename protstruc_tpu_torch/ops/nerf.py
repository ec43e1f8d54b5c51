"""NeRF (Natural Extension Reference Frame) backbone folding.

Port of ``protstruc_tpu/ops/nerf.py``: ``StructureBatch.from_dihedrals``
extends the chain one residue at a time, placing residue i+1's N/CA/C from
residue i's with ideal bond geometry and the given (phi, psi, omega)
torsions.  The JAX package runs the extension under ``lax.scan``; here it is
a plain loop over residues, about 30 small tensor ops a step on the
torsions' device.

Placement uses ``geometry.place_fourth_atom``, so the torsion conventions
round-trip with ``StructureBatch.backbone_dihedrals``.
"""

from __future__ import annotations

import math

import torch

from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.constants import ideal

__all__ = ["backbone_from_dihedrals", "extend_backbone_step"]

# Standard peptide bond angles not in the ideal table (Engh & Huber):
ACN = math.radians(116.2)  # CA-C-N' angle at the carbonyl carbon
CNA = math.radians(121.7)  # C-N'-CA' angle at the backbone nitrogen


def extend_backbone_step(carry, torsions):
    """Place residue i+1's (N, CA, C) from residue i's and 3 torsions.

    carry: ``(n_i, ca_i, c_i)`` each ``(..., 3)``.
    torsions: ``(psi_i, omega_i, phi_ip1)`` each ``(..., 1)``.
    Returns ``(new, new)`` like the JAX scan body.
    """
    n_i, ca_i, c_i = carry
    psi, omega, phi = torsions

    n_next = geom.place_fourth_atom(n_i, ca_i, c_i, ideal.C_N, ACN, psi)
    ca_next = geom.place_fourth_atom(ca_i, c_i, n_next, ideal.NA, CNA, omega)
    c_next = geom.place_fourth_atom(c_i, n_next, ca_next, ideal.AC, ideal.NAC, phi)
    new = (n_next, ca_next, c_next)
    return new, new


def backbone_from_dihedrals(dihedrals: torch.Tensor) -> torch.Tensor:
    """Fold ``(B, L, 3)`` (phi, psi, omega) torsions into backbone coordinates.

    Returns ``(B, L, 4, 3)`` float32 N/CA/C/O coordinates on the torsions'
    device.  The first residue sits in the ideal frame (CA at the origin,
    CA->C along +x); phi[0], psi[L-1] and omega[L-1] are unused.  O atoms are
    placed ideally from the next residue's N, the last residue's from an
    ideal psi (``geometry.ideal_carbonyl_oxygen``).  Float64 torsions give a
    float64 chain from the same float32 start: the reference, nearly free of
    rounding, that the float32 chain is checked against.
    """
    if dihedrals.dtype != torch.float64:
        dihedrals = dihedrals.to(torch.float32)
    B, L = dihedrals.shape[:2]

    ideal0 = geom.ideal_backbone_coordinates((B,), device=dihedrals.device).to(dihedrals.dtype)
    carry = (ideal0[:, 0], ideal0[:, 1], ideal0[:, 2])
    phi, psi, omega = (dihedrals[..., k:k + 1] for k in range(3))

    placed = [carry]
    # step i consumes psi_i, omega_i (residue i) and phi_{i+1}
    for i in range(L - 1):
        carry, _ = extend_backbone_step(carry, (psi[:, i], omega[:, i], phi[:, i + 1]))
        placed.append(carry)
    n, ca, c = (torch.stack([p[k] for p in placed], dim=1) for k in range(3))
    o = geom.ideal_carbonyl_oxygen(n, ca, c)
    return torch.stack([n, ca, c, o], dim=2)
