"""Surface and compactness analysis: SASA, radius of gyration, contact order.

Port of ``protstruc_tpu/ops/surface.py``.  Shrake-Rupley solvent-accessible
surface area with test points for every atom at once (golden-spiral sphere)
and occlusion accumulated over fixed-size occluder chunks.  Eager PyTorch
materializes what XLA fuses, so the chunk body accumulates the squared
distance one coordinate at a time (the order of ``jnp.sum(..., axis=-1)``)
into a ``(N, P, C)`` buffer, one structure at a time over its valid atoms
only: the peak is O(N P C), not the ``(B, N, P, C, 3)`` difference tensor,
and padding costs nothing.  Square roots that
decide a threshold are taken correctly rounded (:func:`geometry._exact_sqrt`),
as XLA takes them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from protstruc_tpu_torch.geometry import _exact_sqrt

__all__ = ["atom_radii_table", "sasa", "radius_of_gyration", "contact_order"]

# Van der Waals radii (angstrom) by element, NACCESS/Chothia values.
_VDW = {"C": 1.70, "N": 1.55, "O": 1.52, "S": 1.80}


@lru_cache(maxsize=1)
def atom_radii_table() -> np.ndarray:
    """``(21, 15)`` float32: vdW radius of each heavy-atom slot per residue
    type (0.0 for empty slots), from the vocab heavy-atom layout."""
    from protstruc_tpu_torch.vocab import RESTYPE_HEAVY_ATOMS

    table = np.zeros((21, 15), np.float32)
    for aa, names in RESTYPE_HEAVY_ATOMS.items():
        for slot, name in enumerate(names):
            if name:
                table[int(aa), slot] = _VDW[name[0]]
    return table


@lru_cache(maxsize=8)
def _sphere_points(n: int) -> np.ndarray:
    """``(n, 3)`` roughly uniform unit-sphere points (golden spiral)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)],
        axis=-1,
    ).astype(np.float32)


def atom_radii(seq_idx: torch.Tensor) -> torch.Tensor:
    """``(B, L, 15)`` vdW radius per atom slot of each residue type."""
    tab = torch.from_numpy(atom_radii_table()).to(seq_idx.device)
    return tab[seq_idx.long().clamp(0, 20)]


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_k (a_k - b_k)^2`` over a trailing axis of 3, one coordinate at a
    time (left to right), broadcasting ``a[..., k]`` against ``b[..., k]``."""
    d2 = (a[..., 0] - b[..., 0]) ** 2
    d2 = d2 + (a[..., 1] - b[..., 1]) ** 2
    return d2 + (a[..., 2] - b[..., 2]) ** 2


def sasa(xyz: torch.Tensor, atom_mask: torch.Tensor, seq_idx: torch.Tensor,
         probe: float = 1.4, n_points: int = 92, chunk: int = 128,
         per_atom: bool = False) -> torch.Tensor:
    """Shrake-Rupley SASA in A^2.

    Args:
        xyz: ``(B, L, A, 3)`` heavy-atom coordinates (NaN at missing atoms).
        atom_mask: ``(B, L, A)`` bool.
        seq_idx: ``(B, L)`` residue-type indices (UNK=20 gets zero radius ->
            zero area).
        probe: solvent probe radius (water = 1.4 A).
        n_points: test points per atom (92 ~ 2-3% relative error).
        chunk: occluder chunk size (memory/speed knob).

    Returns per-residue areas ``(B, L)`` (or per-atom ``(B, L, A)``).

    Only each structure's valid atoms (present, finite, nonzero radius) take
    part, as test points and as occluders: the JAX package parks the others
    1e6 A away with zero area, where they bury nothing, so the buried flags
    and areas are the same.
    """
    B, L, A, _ = xyz.shape
    N = L * A
    dev = xyz.device

    r = atom_radii(seq_idx)
    valid = (atom_mask & (r > 0.0) & torch.isfinite(xyz).all(-1)).reshape(B, N)
    x = torch.nan_to_num(xyz, nan=0.0).reshape(B, N, 3)
    r_ext = torch.where(valid, r.reshape(B, N), 0.0) + probe
    sphere = torch.from_numpy(_sphere_points(n_points)).to(dev)

    buried = torch.zeros((B, N, n_points), dtype=torch.bool, device=dev)
    for b in range(B):
        idx = valid[b].nonzero().squeeze(1)
        xv, rv = x[b, idx], r_ext[b, idx]
        n = idx.numel()
        own = torch.arange(n, device=dev)
        pts = xv[:, None, :] + rv[:, None, None] * sphere  # (n, P, 3)
        thr = rv ** 2 - 1e-6
        hit = torch.zeros((n, n_points), dtype=torch.bool, device=dev)
        for c0 in range(0, n, chunk):
            sl = slice(c0, c0 + chunk)
            # (n, P, C) squared distances from every test point to this chunk
            inside = _sq_dist(pts[:, :, None, :], xv[None, None, sl]) < thr[sl]
            # an atom never buries its own test points (they lie ON its surface)
            inside &= (own[sl][None, :] != own[:, None])[:, None, :]
            hit |= inside.any(-1)
        buried[b, idx] = hit

    frac = 1.0 - buried.to(torch.float32).mean(-1)
    area = 4.0 * np.pi * r_ext ** 2 * frac * valid
    area = area.reshape(B, L, A)
    return area if per_atom else area.sum(-1)


def radius_of_gyration(xyz: torch.Tensor,
                       atom_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mass-uniform radius of gyration over valid atoms, ``(B,)``.

    ``xyz``: ``(B, L, A, 3)`` (NaN-safe); ``atom_mask``: ``(B, L, A)``.
    """
    B = xyz.shape[0]
    x = xyz.reshape(B, -1, 3)
    m = torch.isfinite(x).all(-1)
    if atom_mask is not None:
        m = atom_mask.reshape(B, -1) & m
    x = torch.nan_to_num(x, nan=0.0)
    w = m.to(x.dtype)
    denom = torch.clamp_min(w.sum(1), 1.0)
    com = (x * w[..., None]).sum(1) / denom[:, None]
    d2 = ((x - com[:, None]) ** 2).sum(-1)
    return torch.sqrt((d2 * w).sum(1) / denom)


def contact_order(ca: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  cutoff: float = 8.0, relative: bool = True,
                  chain_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Relative) contact order from CA coordinates ``(B, L, 3)``.

    Mean sequence separation of residue pairs in contact (CA-CA < cutoff,
    |i-j| >= 2), divided by the chain length when ``relative``.  With
    ``chain_idx`` only same-chain pairs count, and ``relative`` divides each
    contact by its own chain's length (the Plaxco L).
    """
    B, L, _ = ca.shape
    finite = torch.isfinite(ca).all(-1)
    mask = finite if mask is None else mask & finite
    x = torch.nan_to_num(ca, nan=1e6)

    d = _exact_sqrt(torch.clamp_min(_sq_dist(x[:, :, None], x[:, None, :]), 1e-12))
    pos = torch.arange(L, device=ca.device)
    sep = (pos[:, None] - pos[None, :]).abs()
    contact = (d < cutoff) & (sep[None] >= 2) & mask[:, :, None] & mask[:, None, :]
    same = None
    if chain_idx is not None:
        same = chain_idx[:, :, None] == chain_idx[:, None, :]
        contact = contact & same
    contact = contact.to(ca.dtype)
    sep = sep.to(ca.dtype)

    n_contacts = torch.clamp_min(contact.sum((1, 2)), 1.0)
    if relative and chain_idx is not None:
        # per-chain Plaxco L: length of the chain residue i belongs to
        chain_len = torch.clamp_min((same & mask[:, None, :]).sum(-1).to(ca.dtype), 1.0)
        return (contact * (sep[None] / chain_len[:, :, None])).sum((1, 2)) / n_contacts
    co = (contact * sep[None]).sum((1, 2)) / n_contacts
    if relative:
        co = co / torch.clamp_min(mask.sum(1).to(ca.dtype), 1.0)
    return co
