"""Sidechain chi torsions: extraction, symmetry and rotation, port of
``protstruc_tpu/ops/chi.py``.

Chi definitions follow the IUPAC/AlphaFold convention (chi1 = N-CA-CB-XG,
up to chi4; ARG's trivial chi5 left out as in AF2).  The slot tables are
derived on the host from the vocab heavy-atom layout (a copy of the JAX
package's derivation, numpy only, cached); the device side is gathers,
``geometry.dihedral`` and Rodrigues rotations.  NaN marks a missing atom and
nothing else: undefined chis read 0 under a False mask.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from protstruc_tpu_torch import geometry as geom

__all__ = ["CHI_ATOM_NAMES", "chi_tables", "chi_angles", "rotate_chi", "chi_symmetry_mask"]

# chi_k = dihedral(a1, a2, a3, a4); rotation axis a2-a3, moved = a3 subtree
CHI_ATOM_NAMES: Dict[str, List[Tuple[str, str, str, str]]] = {
    "ARG": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "NE"), ("CG", "CD", "NE", "CZ")],
    "ASN": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "OD1")],
    "ASP": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "OD1")],
    "CYS": [("N", "CA", "CB", "SG")],
    "GLN": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "OE1")],
    "GLU": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "OE1")],
    "HIS": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "ND1")],
    "ILE": [("N", "CA", "CB", "CG1"), ("CA", "CB", "CG1", "CD1")],
    "LEU": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "LYS": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD"),
            ("CB", "CG", "CD", "CE"), ("CG", "CD", "CE", "NZ")],
    "MET": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "SD"),
            ("CB", "CG", "SD", "CE")],
    "PHE": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "PRO": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD")],
    "SER": [("N", "CA", "CB", "OG")],
    "THR": [("N", "CA", "CB", "OG1")],
    "TRP": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "TYR": [("N", "CA", "CB", "CG"), ("CA", "CB", "CG", "CD1")],
    "VAL": [("N", "CA", "CB", "CG1")],
    # ALA, GLY, UNK: no chi angles
}

# parent of each sidechain atom (CB's is the backbone CA); rings are spanned
# by a tree, enough for chi rotations, which move whole rigid ring groups
_PARENT: Dict[str, Dict[str, str]] = {
    "ARG": {"CG": "CB", "CD": "CG", "NE": "CD", "CZ": "NE", "NH1": "CZ", "NH2": "CZ"},
    "ASN": {"CG": "CB", "OD1": "CG", "ND2": "CG"},
    "ASP": {"CG": "CB", "OD1": "CG", "OD2": "CG"},
    "CYS": {"SG": "CB"},
    "GLN": {"CG": "CB", "CD": "CG", "OE1": "CD", "NE2": "CD"},
    "GLU": {"CG": "CB", "CD": "CG", "OE1": "CD", "OE2": "CD"},
    "HIS": {"CG": "CB", "ND1": "CG", "CD2": "CG", "CE1": "ND1", "NE2": "CD2"},
    "ILE": {"CG1": "CB", "CG2": "CB", "CD1": "CG1"},
    "LEU": {"CG": "CB", "CD1": "CG", "CD2": "CG"},
    "LYS": {"CG": "CB", "CD": "CG", "CE": "CD", "NZ": "CE"},
    "MET": {"CG": "CB", "SD": "CG", "CE": "SD"},
    "PHE": {"CG": "CB", "CD1": "CG", "CD2": "CG", "CE1": "CD1", "CE2": "CD2", "CZ": "CE1"},
    "PRO": {"CG": "CB", "CD": "CG"},
    "SER": {"OG": "CB"},
    "THR": {"OG1": "CB", "CG2": "CB"},
    "TRP": {"CG": "CB", "CD1": "CG", "CD2": "CG", "NE1": "CD1", "CE2": "CD2",
            "CE3": "CD2", "CZ2": "CE2", "CZ3": "CE3", "CH2": "CZ2"},
    "TYR": {"CG": "CB", "CD1": "CG", "CD2": "CG", "CE1": "CD1", "CE2": "CD2", "CZ": "CE1",
            "OH": "CZ"},
    "VAL": {"CG1": "CB", "CG2": "CB"},
}

# chis whose terminal group is 2-fold symmetric (defined modulo pi)
_SYMMETRIC: Dict[str, int] = {"ASP": 2, "GLU": 3, "PHE": 2, "TYR": 2}


@lru_cache(maxsize=1)
def chi_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Slot tables from the vocab heavy-atom layout: ``chi_idx (21, 4, 4)``
    int32 atom slots per chi (-1 pad), ``chi_moved (21, 4, 15)`` bool slots
    each chi rotates, ``chi_mask (21, 4)`` which chis exist."""
    from protstruc_tpu_torch.vocab import AA, RESTYPE_HEAVY_ATOMS

    chi_idx = np.full((21, 4, 4), -1, np.int32)
    chi_moved = np.zeros((21, 4, 15), bool)
    chi_mask = np.zeros((21, 4), bool)
    for res, chis in CHI_ATOM_NAMES.items():
        aa = int(AA.__members__[res])
        slots = {n: i for i, n in enumerate(RESTYPE_HEAVY_ATOMS[AA(aa)]) if n}
        parent = _PARENT[res]

        def descendants(root: str) -> List[str]:
            out, frontier = [], [root]
            while frontier:
                cur = frontier.pop()
                kids = [a for a, p in parent.items() if p == cur]
                out.extend(kids)
                frontier.extend(kids)
            return out

        for k, names in enumerate(chis):
            chi_idx[aa, k] = [slots[n] for n in names]
            chi_mask[aa, k] = True
            for moved in descendants(names[2]):  # a3's subtree: a4 and beyond
                chi_moved[aa, k, slots[moved]] = True
    return chi_idx, chi_moved, chi_mask


@lru_cache(maxsize=1)
def chi_symmetry_mask() -> np.ndarray:
    """``(21, 4)`` bool: chis defined modulo pi (symmetric terminal group)."""
    from protstruc_tpu_torch.vocab import AA

    sym = np.zeros((21, 4), bool)
    for res, k in _SYMMETRIC.items():
        sym[int(AA.__members__[res]), k - 1] = True
    return sym


def _tables(device):
    return tuple(torch.from_numpy(a).to(device) for a in chi_tables())


def chi_angles(xyz: torch.Tensor, seq_idx: torch.Tensor, atom_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sidechain chi torsions ``(B, L, 4)`` radians and their mask from
    ``xyz (B, L, 15, 3)`` (NaN at missing atoms), ``seq_idx (B, L)`` and
    ``atom_mask (B, L, 15)``.  Masked where the chi is undefined for the
    residue type or an atom of it is missing; masked entries are 0.

    Double-where: a masked chi computes its dihedral on a fixed
    non-degenerate quadruple, so no NaN reaches a gradient.
    """
    idx, _, defined = _tables(xyz.device)
    aa = seq_idx.long().clamp(0, 20)
    safe = idx[aa].long().clamp_min(0)  # (B, L, 4, 4)
    B, L = aa.shape
    flat = safe.reshape(B, L, 16)
    gather = torch.gather(xyz, 2, flat[..., None].expand(B, L, 16, 3)).reshape(B, L, 4, 4, 3)
    present = torch.gather(atom_mask, 2, flat).reshape(B, L, 4, 4)
    mask = defined[aa] & present.all(-1) & torch.isfinite(gather).all(-1).all(-1)
    dummy = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [1.0, 1.0, 1.0]],
                         dtype=xyz.dtype, device=xyz.device)
    g = torch.where(mask[..., None, None], torch.nan_to_num(gather, nan=0.0), dummy)
    chi = geom.dihedral(g[..., 0, :], g[..., 1, :], g[..., 2, :], g[..., 3, :])
    return torch.where(mask, chi, 0.0), mask


def rotate_chi(xyz: torch.Tensor, seq_idx: torch.Tensor, delta: torch.Tensor,
               atom_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add ``delta (B, L, 4)`` radians to each chi angle of ``xyz (B, L, 15,
    3)``, chi1 first (later chis ride inside earlier moved groups).

    Each rotation is rigid about the a2-a3 axis through a3 and moves only
    the chi's moved slots; undefined chis, missing axis atoms and missing
    atoms are left as they are (NaN stays NaN).  PRO's chis lie inside its
    ring, whose closing CD-N bond a tree rotation does not keep:
    ``pack.pack_sidechains`` freezes them.  ``atom_mask`` is accepted for
    the JAX signature; finiteness decides.
    """
    from protstruc_tpu_torch.ops.so3 import rotvec_to_rot

    idx, moved, defined = _tables(xyz.device)
    aa = seq_idx.long().clamp(0, 20)
    B, L = aa.shape
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=xyz.dtype, device=xyz.device)
    out = xyz
    for k in range(4):
        slots = idx[aa][:, :, k].long().clamp_min(0)  # (B, L, 4)
        g = torch.gather(out, 2, slots[..., None].expand(B, L, 4, 3))
        a2, a3 = g[:, :, 1], g[:, :, 2]
        raw = torch.nan_to_num(a3 - a2, nan=0.0)
        nsq = (raw * raw).sum(-1, keepdim=True)
        ok = (defined[aa][:, :, k] & (nsq[..., 0] > 1e-12)
              & torch.isfinite(a2).all(-1) & torch.isfinite(a3).all(-1))
        nsq_safe = torch.where(nsq > 1e-12, nsq, 1.0)
        axis = torch.where(ok[..., None], raw, x_axis)
        axis = axis / torch.sqrt(torch.where(ok[..., None], nsq_safe, 1.0))
        ang = torch.where(ok, delta[:, :, k], 0.0)
        rot = rotvec_to_rot(axis * ang[..., None])  # (B, L, 3, 3)
        centered = torch.nan_to_num(out - a3[:, :, None, :], nan=0.0)
        rotated = torch.einsum("blij,blaj->blai", rot, centered) + a3[:, :, None, :]
        # a missing atom inside a moved set stays NaN, not a rotated phantom
        sel = (moved[aa][:, :, k, :, None] & ok[:, :, None, None]
               & torch.isfinite(out).all(-1, keepdim=True))
        out = torch.where(sel, rotated, out)
    return out
