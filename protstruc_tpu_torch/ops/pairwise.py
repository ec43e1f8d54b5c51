"""Pairwise (inter-residue) feature maps in plain PyTorch.

Port of ``protstruc_tpu/ops/pairwise.py``: every pair feature is a fused
``(B, L, L)`` map computed by broadcasting residue-i atom columns
``(B, L, 1, 3)`` against residue-j columns ``(B, 1, L, 3)``; the
``(B, L, L, A, A)`` all-atom tensor is built only by
:func:`full_pairwise_distance_matrix`, the parity escape hatch behind
``StructureBatch.pairwise_distance_matrix``.  This is the arccos-form path
behind ``StructureBatch.inter_residue_geometry(use_kernel=False)``.
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
    "full_pairwise_distance_matrix",
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


def full_pairwise_distance_matrix(
    xyz: torch.Tensor, atom_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full all-atom pair tensor ``(B, L, L, A, A)`` + validity mask.

    Memory is O(B L^2 A^2); prefer ``pairwise_atom_distance`` slices.  The
    output is filled one structure at a time, a coordinate axis at a time,
    so nothing larger than one structure's ``(L, L, A, A)`` planes is built
    beside it.
    """
    B, L, A = xyz.shape[:3]
    elements = B * L * L * A * A
    if elements > 2**33:  # ~8G elements = 32 GB f32
        raise ValueError(
            f"full_pairwise_distance_matrix would materialize {elements:.2e} "
            f"elements (B={B}, L={L}, A={A}). Use pairwise_atom_distance / "
            "inter_residue_geometry (fused (B, L, L) maps) instead."
        )
    dist = torch.empty((B, L, L, A, A), dtype=xyz.dtype, device=xyz.device)
    for b in range(B):
        x = xyz[b]
        d = [x[:, None, :, None, k] - x[None, :, None, :, k] for k in range(3)]
        sq = torch.addcmul(torch.addcmul(d[0] * d[0], d[1], d[1]), d[2], d[2])
        dist[b] = geom._exact_sqrt(sq)
    mask = atom_mask[:, :, None, :, None] & atom_mask[:, None, :, None, :]
    return dist, mask
