"""Steric clash scoring and sidechain repacking, port of
``protstruc_tpu/ops/pack.py``.

One dense ``(N, N)`` pairwise computation over a structure's ``N`` valid
atoms, taken one structure at a time so eager PyTorch holds ``(N, N)`` maps,
not the ``(B, L*A, L*A, 3)`` difference tensor; the squared distance is
accumulated one coordinate at a time and its root taken correctly rounded,
as XLA does.  The JAX package parks invalid atoms far away and far apart,
where they add nothing; here they are left out, so only the order of the
final sum differs.

``pack_sidechains`` is the annealed parallel random search over chi angles:
a loop of sweeps (the JAX package's ``lax.scan``), each scoring its
proposals as one ``(K * B)`` batch.  Its Gaussian proposals come from a
``torch.Generator`` and go to the private core ``_pack_sidechains``, which
the tests feed the JAX function's own draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from protstruc_tpu_torch.geometry import _exact_sqrt
from protstruc_tpu_torch.ops.surface import _sq_dist, atom_radii

__all__ = ["clash_energy", "pack_sidechains"]


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


def _pack_sidechains(xyz: torch.Tensor, seq_idx: torch.Tensor, atom_mask: torch.Tensor,
                     noise: torch.Tensor, sigma0: float = 1.5, sigma1: float = 0.1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packer on given draws: ``noise (n_sweeps, K, B, L, 4)`` standard
    normal, one ``(K, B, L, 4)`` block a sweep."""
    from protstruc_tpu_torch.ops.chi import rotate_chi
    from protstruc_tpu_torch.vocab import AA

    n_sweeps, K, B, L = noise.shape[:4]
    lo = torch.log(torch.tensor(sigma0, dtype=torch.float32))
    hi = torch.log(torch.tensor(sigma1, dtype=torch.float32))
    sigmas = torch.exp(torch.linspace(float(lo), float(hi), n_sweeps, dtype=torch.float32))
    # PRO's chis live in its ring: rotating them would tear the CD-N closure,
    # which clash_energy (intra-residue pairs excluded) would never score
    not_pro = (seq_idx != int(AA.PRO))[None, :, :, None]
    seq_k = seq_idx.repeat(K, 1)
    mask_k = atom_mask.repeat(K, 1, 1)
    x, e = xyz, clash_energy(xyz, atom_mask, seq_idx)
    traj = [e]
    for s in range(n_sweeps):
        deltas = noise[s] * sigmas[s].to(noise.device) * not_pro
        cands = rotate_chi(x.repeat(K, 1, 1, 1), seq_k, deltas.reshape(K * B, L, 4), mask_k)
        es = clash_energy(cands, mask_k, seq_k).reshape(K, B)
        all_e = torch.cat([e[None], es], dim=0)                               # (K+1, B)
        all_x = torch.cat([x[None], cands.reshape((K, B) + x.shape[1:])], 0)  # (K+1, B, L, A, 3)
        best = torch.argmin(all_e, dim=0)                                     # first minimum
        x = all_x[best, torch.arange(B, device=x.device)]
        e = all_e[best, torch.arange(B, device=x.device)]
        traj.append(e)
    return x, torch.stack(traj)


def pack_sidechains(xyz: torch.Tensor, seq_idx: torch.Tensor, atom_mask: torch.Tensor,
                    n_sweeps: int = 30, n_proposals: int = 8, sigma0: float = 1.5,
                    sigma1: float = 0.1, generator: Optional[torch.Generator] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repack sidechains by annealed parallel random search in chi space.

    Each of ``n_sweeps`` sweeps draws ``n_proposals`` Gaussian chi
    perturbations for every structure (scale annealed log-linearly from
    ``sigma0`` to ``sigma1``; PRO frozen), applies them with
    ``chi.rotate_chi``, scores them with :func:`clash_energy` and keeps the
    best of the current structure and the candidates: monotone descent.
    Draws from ``generator`` on its device (the structure's for the global
    generator).  Returns ``(packed_xyz, energy_trajectory (n_sweeps+1, B))``.
    """
    dev = generator.device if generator is not None else xyz.device
    B, L = seq_idx.shape
    noise = torch.randn((n_sweeps, n_proposals, B, L, 4), generator=generator, device=dev)
    return _pack_sidechains(xyz, seq_idx, atom_mask, noise, sigma0, sigma1)
