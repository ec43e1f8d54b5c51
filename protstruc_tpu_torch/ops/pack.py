"""Steric clash scoring (port of ``clash_energy`` from
``protstruc_tpu/ops/pack.py``).

One dense ``(N, N)`` pairwise computation over a structure's ``N`` valid
atoms, taken one structure at a time so eager PyTorch holds ``(N, N)`` maps,
not the ``(B, L*A, L*A, 3)`` difference tensor; the squared distance is
accumulated one coordinate at a time and its root taken correctly rounded,
as XLA does.  The JAX package parks invalid atoms far away and far apart,
where they add nothing; here they are left out, so only the order of the
final sum differs.
"""

from __future__ import annotations

import torch

from protstruc_tpu_torch.geometry import _exact_sqrt
from protstruc_tpu_torch.ops.surface import _sq_dist, atom_radii

__all__ = ["clash_energy"]


def clash_energy(xyz: torch.Tensor, atom_mask: torch.Tensor, seq_idx: torch.Tensor,
                 tolerance: float = 0.4) -> torch.Tensor:
    """Inter-residue steric clash energy, ``(B,)``.

    ``sum over atom pairs of max(0, r_i + r_j - tolerance - d)^2`` across
    *different* residues, excluding backbone-backbone pairs (N/CA/C/O/CB
    slots) of sequence-adjacent residues.  Intra-residue pairs are excluded.
    ``tolerance`` softens the vdW wall (0.4 A, the usual Rosetta-style
    allowance).  Differentiable in ``xyz`` (invalid atoms get zero
    gradient).
    """
    B, L, A, _ = xyz.shape
    dev = xyz.device

    radii = atom_radii(seq_idx)
    valid = atom_mask & (radii > 0) & torch.isfinite(xyz).all(-1)
    x = torch.nan_to_num(xyz, nan=0.0).reshape(B, L * A, 3)
    r = radii.reshape(B, L * A)
    res_i = torch.arange(L, device=dev).repeat_interleave(A)
    is_bb = (torch.arange(L * A, device=dev) % A) < 5  # N/CA/C/O/CB slots

    out = []
    for b in range(B):
        idx = valid[b].reshape(-1).nonzero().squeeze(1)
        xv, rv, res, bb = x[b, idx], r[b, idx], res_i[idx], is_bb[idx]
        d = _exact_sqrt(torch.clamp_min(_sq_dist(xv[:, None], xv[None, :]), 1e-12))
        excluded = ((res[:, None] == res[None, :])
                    | (((res[:, None] - res[None, :]).abs() == 1) & bb[:, None] & bb[None, :]))
        overlap = torch.clamp_min(rv[:, None] + rv[None, :] - d - tolerance, 0.0)
        overlap = torch.where(excluded, 0.0, overlap)
        # each pair counted twice; halve
        out.append(0.5 * (overlap ** 2).sum())
    return torch.stack(out)
