"""Structure reconstruction from inter-residue geometry (trRosetta decode).

Port of ``protstruc_tpu/ops/reconstruct.py``:

1. ``reconstruct_backbone_distmat_from_interresidue_geometry`` places every
   residue j's N/CA/C/CB in residue i's ideal local frame from the
   (d_cb, omega, theta, phi) maps, assembles a ``(3, 3, L, L)`` backbone
   distance tensor, pins intra-residue and peptide-bond distances to ideal
   values, and fills masked entries by min-plus (tropical) Floyd-Warshall
   relaxation over the ``(3L, 3L)`` matrix: a loop of 3L relaxations.
2. ``initialize_backbone_with_mds`` embeds the distance matrix in 3D:
   classical MDS (double-centered Gram matrix + ``eigh``), SMACOF
   refinement, the chirality fix and ideal O/CB placement.

Everything runs on the input's device in float32; the matrix products are
the exact f32 products the JAX package asks for with
``precision="highest"`` (no TF32: PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.constants import ideal

__all__ = [
    "MASK_DIST",
    "reconstruct_backbone_distmat_from_interresidue_geometry",
    "classical_mds",
    "smacof_refine",
    "initialize_backbone_with_mds",
]

#: Sentinel distance for unknown entries, replaced by shortest-path relaxation.
MASK_DIST = 12345679.0

_N, _CA, _C, _CB = 0, 1, 2, 3


def _floyd_warshall_minplus(d: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths by node relaxation, ``d``: ``(n, n)``."""
    d = d.clone()
    for k in range(d.shape[0]):
        torch.minimum(d, d[:, k:k + 1] + d[k:k + 1, :], out=d)
    return d


def reconstruct_backbone_distmat_from_interresidue_geometry(
    d_cb: torch.Tensor,
    omega: torch.Tensor,
    theta: torch.Tensor,
    phi: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chain_breaks=None,
    chain_break_mask: Optional[torch.Tensor] = None,
    n_relax_sweeps: int = 1,
) -> torch.Tensor:
    """Backbone N/CA/C distance tensor from trRosetta 6D maps.

    Args:
        d_cb, omega, theta, phi: ``(L, L)`` CB-CB distances, CA-CB-CB'-CA'
            and N-CA-CB-CB' dihedrals, CA-CB-CB' planar angles.
        mask: optional ``(L, L)`` bool of reconstructable pairs; the rest is
            filled by shortest-path relaxation.
        chain_breaks: indices i where residues i and i+1 are not bonded, or
        chain_break_mask: the same as an ``(L-1,)`` bool (not both).
        n_relax_sweeps: full Floyd-Warshall sweeps (1 is exact).

    Returns ``(3, 3, L, L)``: ``out[ai, aj, i, j]`` is the distance between
    atom ``ai`` of residue i and atom ``aj`` of residue j (order N, CA, C).
    """
    L = d_cb.shape[-1]
    dev = d_cb.device
    if chain_breaks is not None:
        if chain_break_mask is not None:
            raise ValueError("pass chain_breaks or chain_break_mask, not both")
        cbm = np.zeros(L - 1, dtype=bool)
        cbm[np.asarray(list(chain_breaks), dtype=int)] = True
        chain_break_mask = torch.from_numpy(cbm).to(dev)

    x = geom.ideal_local_frame(dev)[:, None, None, :]  # (4, 1, 1, 3) N/CA/C/CB
    d_cb_ = d_cb[..., None]
    angle_abb = phi[..., None]
    angle_bba = phi.transpose(-1, -2)[..., None]
    dih_nabb = theta[..., None]
    dih_bban = theta.transpose(-1, -2)[..., None]
    dih_abba = omega[..., None]

    # place residue j's atoms in residue i's local frame
    y_cb = geom.place_fourth_atom(x[_N], x[_CA], x[_CB], d_cb_, angle_abb, dih_nabb)
    y_ca = geom.place_fourth_atom(x[_CA], x[_CB], y_cb, ideal.BA, angle_bba, dih_abba)
    y_n = geom.place_fourth_atom(x[_CB], y_cb, y_ca, ideal.AN, ideal.BAN, dih_bban)
    y_c = geom.place_fourth_atom(y_cb, y_ca, y_n, ideal.NC, ideal.ANC, ideal.BANC)

    y = torch.stack([y_n, y_ca, y_c])  # (3, L, L, 3)
    dist = geom.norm(x[:3][:, None] - y[None]).squeeze(-1)  # (3, 3, L, L)

    # mask unknown pairs first, then pin ideal intra-residue and peptide-bond
    # distances, so that residues without CB stay connected in the atom graph
    if mask is not None:
        dist = torch.where(mask[None, None], dist, MASK_DIST)
    dist = torch.nan_to_num(dist, nan=MASK_DIST)

    eye = torch.eye(L, dtype=torch.bool, device=dev)
    atoms = ["N", "A", "C"]
    pinned = {(ai, aj): 0.0 if ai == aj else ideal.as_dict[f"{atoms[ai]}{atoms[aj]}"]
              for ai in range(3) for aj in range(3)}
    pinned.update({(_N, _CA): ideal.NA, (_CA, _N): ideal.NA,
                   (_CA, _C): ideal.AC, (_C, _CA): ideal.AC})
    dist = _pin(dist, eye, pinned)

    # peptide bonds C_i - N_{i+1}
    off = torch.eye(L, dtype=torch.bool, device=dev).roll(1, dims=1)
    off[:, 0] = False
    bond = torch.full((L, L), ideal.C_N, dtype=dist.dtype, device=dev)
    if chain_break_mask is not None:
        brk = torch.zeros((L, L), dtype=torch.bool, device=dev)
        brk[torch.arange(L - 1, device=dev), torch.arange(1, L, device=dev)] = (
            torch.as_tensor(chain_break_mask, device=dev).bool())
        bond = torch.where(brk, MASK_DIST, bond)
    dist = dist.clone()
    dist[_C, _N] = torch.where(off, bond, dist[_C, _N])
    dist[_N, _C] = torch.where(off.T, bond.T, dist[_N, _C])

    # min-plus relaxation over the (3L, 3L) atom graph
    flat = dist.permute(0, 2, 1, 3).reshape(3 * L, 3 * L)
    for _ in range(n_relax_sweeps):
        flat = _floyd_warshall_minplus(flat)
    flat = (flat + flat.T) / 2.0
    dist = flat.reshape(3, L, 3, L).permute(0, 2, 1, 3)

    # re-pin ideal bonds after relaxation (C-N at chain breaks too, as the
    # reference does; the break mattered during the relaxation)
    dist = _pin(dist, eye, {(_N, _CA): ideal.NA, (_CA, _N): ideal.NA,
                            (_CA, _C): ideal.AC, (_C, _CA): ideal.AC})
    dist[_C, _N] = torch.where(off, ideal.C_N, dist[_C, _N])
    dist[_N, _C] = torch.where(off.T, ideal.C_N, dist[_N, _C])
    return dist


def _pin(dist: torch.Tensor, where: torch.Tensor, values) -> torch.Tensor:
    """A copy of ``dist`` with ``dist[ai, aj]`` set to ``v`` where ``where``."""
    dist = dist.clone()
    for (ai, aj), v in values.items():
        dist[ai, aj] = torch.where(where, v, dist[ai, aj])
    return dist


def classical_mds(dist: torch.Tensor, out_dim: int = 3) -> torch.Tensor:
    """Classical (Torgerson) MDS embedding by ``eigh``: ``(n, n)``
    dissimilarities -> ``(n, out_dim)``, largest eigenvalue first."""
    n = dist.shape[0]
    d2 = dist ** 2
    j = (torch.eye(n, dtype=dist.dtype, device=dist.device)
         - torch.full((n, n), 1.0 / n, dtype=dist.dtype, device=dist.device))
    b = -0.5 * ((j @ d2) @ j)
    w, v = torch.linalg.eigh(b)  # ascending
    top = torch.arange(n - out_dim, n, device=dist.device)
    scales = torch.sqrt(torch.clamp(w[top], min=0.0))
    coords = v[:, top] * scales[None, :]
    return coords.flip(-1)


def smacof_refine(dist: torch.Tensor, coords: torch.Tensor, n_iter: int = 50) -> torch.Tensor:
    """SMACOF stress-majorization refinement, ``n_iter`` Guttman updates."""
    n = dist.shape[0]
    x = coords
    for _ in range(n_iter):
        cur = geom.norm(x[:, None, :] - x[None, :, :]).squeeze(-1)
        cur = torch.where(cur < 1e-8, 1e-8, cur)
        b = -(dist / cur)
        b = b + torch.diag(-b.sum(dim=1))
        x = (b @ x) / n
    return x


def initialize_backbone_with_mds(dist_mat: torch.Tensor, max_iter: int = 500) -> torch.Tensor:
    """Embed a ``(3, 3, L, L)`` backbone distance tensor in 3D.

    Classical MDS, ``max_iter`` SMACOF iterations, the chirality fix, then
    ideal O and CB placement.  Returns ``(5, L, 3)`` in atom order N, CA, C,
    O, CB.
    """
    L = dist_mat.shape[-1]
    pdist = dist_mat.permute(0, 2, 1, 3).reshape(3 * L, 3 * L)

    coords = classical_mds(pdist, 3)
    if max_iter > 0:
        coords = smacof_refine(pdist, coords, n_iter=max_iter)
    coords = geom.fix_chirality(coords.reshape(3, L, 3))

    cb = geom.place_fourth_atom(coords[_C], coords[_N], coords[_CA],
                                ideal.AB, ideal.NAB, ideal.BANC)[None]
    o = geom.ideal_carbonyl_oxygen(coords[_N], coords[_CA], coords[_C])[None]
    return torch.cat([coords, o, cb], dim=0)
