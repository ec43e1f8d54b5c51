"""Pairwise (inter-residue) feature maps in plain PyTorch.

Port of ``protstruc_tpu/ops/pairwise.py``: every pair feature is a fused
``(B, L, L)`` map computed by broadcasting residue-i atom columns
``(B, L, 1, 3)`` against residue-j columns ``(B, 1, L, 3)``; the
``(B, L, L, A, A)`` all-atom tensor is never built.  This is the arccos-form
path behind ``StructureBatch.inter_residue_geometry(use_kernel=False)``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.vocab import ATOM

__all__ = [
    "pairwise_atom_distance",
    "pairwise_dihedral_maps",
    "pairwise_planar_angle_maps",
]


def _atom_slot(name: str) -> int:
    if not ATOM.is_valid(name):
        raise ValueError(f"Atom {name} is not valid.")
    return int(ATOM[name] if name in ATOM.__members__ else ATOM[name.upper()])


def _atom_cols(xyz: torch.Tensor, names: Sequence[str]) -> List[torch.Tensor]:
    """Select atom columns by (case-insensitive) name: ``(B, L, A, 3) -> [(B, L, 3), ...]``."""
    return [xyz[:, :, _atom_slot(a)] for a in names]


def pairwise_atom_distance(
    xyz: torch.Tensor,
    atom_mask: torch.Tensor,
    atom_i: str,
    atom_j: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance map between atom ``atom_i`` of residue i and ``atom_j`` of j.

    Returns ``(dist, mask)`` of shape ``(B, L, L)``.
    """
    (ci,) = _atom_cols(xyz, [atom_i])
    (cj,) = _atom_cols(xyz, [atom_j])
    dist = geom.norm(ci[:, :, None, :] - cj[:, None, :, :]).squeeze(-1)

    mi = atom_mask[:, :, _atom_slot(atom_i)]
    mj = atom_mask[:, :, _atom_slot(atom_j)]
    return dist, mi[:, :, None] & mj[:, None, :]


def pairwise_dihedral_maps(
    xyz: torch.Tensor, atoms_i: Sequence[str], atoms_j: Sequence[str]
) -> torch.Tensor:
    """Pairwise dihedral map over 4 atoms split between residues i and j.

    The four dihedral points are ``atoms_i`` taken from residue i followed by
    ``atoms_j`` from residue j.  Returns ``(B, L, L)``; entry ``[b, i, j]``.
    """
    if len(atoms_i) + len(atoms_j) != 4:
        raise ValueError("pairwise dihedral needs exactly 4 atoms total")
    cols_i = [c[:, :, None, :] for c in _atom_cols(xyz, atoms_i)]
    cols_j = [c[:, None, :, :] for c in _atom_cols(xyz, atoms_j)]
    a, b, c, d = cols_i + cols_j
    out = geom.dihedral(a, b, c, d)

    # Exactly degenerate configurations (a==c & b==d: self-pair; c==d: zero
    # last bond; a==b: zero first bond) are pinned to 0, as in the JAX
    # package.  b==c gives NaN through the exact 0/0 division.  NaN
    # coordinates compare unequal, so missing-atom entries keep their NaN.
    def eq(u, v):
        return (u == v).all(dim=-1)

    degenerate = (eq(a, c) & eq(b, d)) | eq(c, d) | eq(a, b)
    return torch.where(degenerate, torch.zeros_like(out), out)


def pairwise_planar_angle_maps(
    xyz: torch.Tensor, atoms_i: Sequence[str], atoms_j: Sequence[str]
) -> torch.Tensor:
    """Pairwise planar-angle map over 3 atoms split between residues i and j.

    Returns ``(B, L, L)``.
    """
    if len(atoms_i) + len(atoms_j) != 3:
        raise ValueError("pairwise planar angle needs exactly 3 atoms total")
    cols_i = [c[:, :, None, :] for c in _atom_cols(xyz, atoms_i)]
    cols_j = [c[:, None, :, :] for c in _atom_cols(xyz, atoms_j)]
    a, b, c = cols_i + cols_j
    return geom.angle(a, b, c)
