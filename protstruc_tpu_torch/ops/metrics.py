"""Structure comparison metrics (port of ``protstruc_tpu/ops/metrics.py``):
RMSD, superposition, TM-score, GDT-TS, lDDT and the DockQ components.

Batched, masks as weights.  The 3x3 rotations are applied with ``einsum``,
which runs in full float32 on the card as long as
``torch.backends.cuda.matmul.allow_tf32`` stays off (PyTorch's default), as
``precision="highest"`` asks of XLA.  Distances that meet a threshold take a
correctly rounded square root, as XLA's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.geometry import _exact_sqrt
from protstruc_tpu_torch.ops.surface import _sq_dist

__all__ = ["rmsd", "superimpose", "tm_score", "gdt_ts", "lddt", "fnat", "interface_rmsd",
           "dockq", "capri_band"]


def _masked_mean(x, w, dim):
    # where, not x * w: NaN residuals at masked positions would poison the sum
    w = w.to(x.dtype)
    x = torch.where(w > 0, x, 0.0)
    return (x * w).sum(dim) / torch.clamp_min(w.sum(dim), 1.0)


def _ones_mask(a):
    return torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)


def _aligned(a, b, mask):
    """``a`` after the mask-weighted Kabsch superposition onto ``b``."""
    r, t = geom.masked_kabsch(a, b, mask)
    return torch.einsum("...ij,...nj->...ni", r, a) + t[..., None, :]


def rmsd(a, b, mask=None, align: bool = True) -> torch.Tensor:
    """RMSD of point sets ``(..., n, 3)``, after a mask-weighted Kabsch
    superposition of ``a`` onto ``b`` when ``align``.  Returns ``(...,)``."""
    if mask is None:
        mask = _ones_mask(a)
    if align:
        a = _aligned(a, b, mask)
    sq = ((a - b) ** 2).sum(-1)
    return torch.sqrt(_masked_mean(sq, mask, -1))


def superimpose(a, b, mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimally superimpose ``a`` onto ``b``; returns (a_aligned, rmsd)."""
    if mask is None:
        mask = _ones_mask(a)
    aligned = _aligned(a, b, mask)
    return aligned, rmsd(aligned, b, mask, align=False)


def tm_score(a, b, mask=None, align: bool = True,
             l_target: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TM-score of ``a`` vs ``b`` over CA point sets ``(..., n, 3)``:
    ``mean_i 1 / (1 + (d_i / d0)^2)`` with ``d0 = 1.24 (L - 15)^(1/3) - 1.8``
    (Zhang & Skolnick 2004) over valid residues; ``l_target`` overrides the
    normalization length (default: the masked count)."""
    if mask is None:
        mask = _ones_mask(a)
    if align:
        a = _aligned(a, b, mask)
    n = mask.sum(-1).to(a.dtype) if l_target is None else l_target
    # the cube root of an argument >= 1 (jnp.cbrt; torch has none)
    d0 = 1.24 * torch.pow(torch.clamp_min(n - 15.0, 1.0), 1.0 / 3.0) - 1.8
    d0 = torch.clamp_min(d0, 0.5)
    d2 = ((a - b) ** 2).sum(-1)
    return _masked_mean(1.0 / (1.0 + d2 / (d0[..., None] ** 2)), mask, -1)


def gdt_ts(a, b, mask=None, align: bool = True) -> torch.Tensor:
    """GDT-TS: mean fraction of residues within 1/2/4/8 A after superposition."""
    if mask is None:
        mask = _ones_mask(a)
    if align:
        a = _aligned(a, b, mask)
    d = _exact_sqrt(_sq_dist(a, b))
    return sum(_masked_mean((d < c).to(a.dtype), mask, -1) for c in (1.0, 2.0, 4.0, 8.0)) / 4.0


def lddt(pred, ref, mask=None, cutoff: float = 15.0, thresholds=(0.5, 1.0, 2.0, 4.0),
         per_residue: bool = False, rows=None) -> torch.Tensor:
    """Superposition-free lDDT over CA point sets ``(..., n, 3)``: over the
    pairs whose reference distance is below ``cutoff`` (self excluded), the
    mean fraction of distances kept within each threshold.  ``(...,)``, or
    ``(..., n)`` with ``per_residue``.  ``rows=(r0, m)``: only the points
    ``r0 .. r0 + m`` are scored, each against every point (a sequence-
    parallel rank's residues; ``(..., m)`` with ``per_residue``)."""
    if mask is None:
        mask = torch.ones(pred.shape[:-1], dtype=torch.bool, device=pred.device)
    n = pred.shape[-2]
    r0, m = (0, n) if rows is None else rows
    own = slice(r0, r0 + m)

    def cdist(x):
        d2 = ((x[..., own, None, :] - x[..., None, :, :]) ** 2).sum(-1)
        return torch.sqrt(torch.clamp_min(d2, 1e-12))

    d_ref, d_pred = cdist(ref), cdist(pred)
    eye = (torch.arange(r0, r0 + m, device=pred.device)[:, None]
           == torch.arange(n, device=pred.device)[None, :])
    incl = ((d_ref < cutoff) & ~eye & mask[..., own, None] & mask[..., None, :]).to(pred.dtype)
    diff = torch.abs(d_ref - d_pred)
    preserved = sum((diff < t).to(pred.dtype) for t in thresholds) / len(thresholds)
    dims = (-1,) if per_residue else (-2, -1)
    return (preserved * incl).sum(dims) / torch.clamp_min(incl.sum(dims), 1.0)


# ---------------------------------------------------------------------------
# complex (docking) evaluation: DockQ components
# ---------------------------------------------------------------------------


def _min_interchain_dist(xyz, atom_mask, rec_mask, lig_mask, row_block: int = 32):
    """Per residue-pair minimum heavy-atom distance between the two groups.

    ``xyz (B, L, A, 3)`` -> ``(B, L, L)`` with +inf where either residue is
    outside its group or atoms are missing.  Rows go in blocks of
    ``row_block`` with a loop over the i-side atom slot, so the peak is
    O(B * row_block * L * A), never the ``(B, L, L, A, A)`` tensor.
    """
    ok = atom_mask & torch.isfinite(xyz).all(-1)
    x = torch.nan_to_num(xyz, nan=0.0)
    B, L, A = x.shape[:3]
    d2_min = torch.empty((B, L, L), dtype=x.dtype, device=x.device)
    for i0 in range(0, L, row_block):
        xi, oki = x[:, i0:i0 + row_block], ok[:, i0:i0 + row_block]
        acc = torch.full((B, xi.shape[1], L), torch.inf, dtype=x.dtype, device=x.device)
        for a in range(A):
            d2 = _sq_dist(xi[:, :, a, None, None, :], x[:, None])  # (B, blk, L, A)
            # pairs where either atom is missing are no contact (masking the
            # pair, not parking coordinates: two parked atoms sit 0 A apart)
            pair_ok = oki[:, :, a, None, None] & ok[:, None]
            acc = torch.minimum(acc, torch.where(pair_ok, d2, torch.inf).amin(-1))
        d2_min[:, i0:i0 + row_block] = acc
    pair_ok = rec_mask[:, :, None] & lig_mask[:, None, :]
    return torch.where(pair_ok, _exact_sqrt(d2_min), torch.inf)


def fnat(model_xyz, native_xyz, atom_mask, rec_mask, lig_mask, cutoff: float = 5.0,
         d_nat=None, d_mod=None) -> torch.Tensor:
    """Fraction of native inter-chain contacts preserved in the model.

    A contact is a receptor-ligand residue pair with any heavy-atom pair
    within ``cutoff`` A (the DockQ definition).  Returns ``(B,)``.
    ``d_nat``/``d_mod``: optional precomputed min-interchain distance maps.
    """
    if d_nat is None:
        d_nat = _min_interchain_dist(native_xyz, atom_mask, rec_mask, lig_mask)
    if d_mod is None:
        d_mod = _min_interchain_dist(model_xyz, atom_mask, rec_mask, lig_mask)
    native_contacts = d_nat < cutoff
    kept = native_contacts & (d_mod < cutoff)
    n = torch.clamp_min(native_contacts.sum((1, 2)), 1)
    return kept.sum((1, 2)) / n


def _backbone(model_xyz, native_xyz, atom_mask):
    """Model and native N/CA/C/O as ``(B, L*4, 3)`` (NaN at 0) and the
    ``(B, L, 4)`` mask of slots present and finite in both."""
    bb_ok = (atom_mask[:, :, :4] & torch.isfinite(native_xyz[:, :, :4]).all(-1)
             & torch.isfinite(model_xyz[:, :, :4]).all(-1))
    B, L = bb_ok.shape[:2]
    a = torch.nan_to_num(model_xyz[:, :, :4], nan=0.0).reshape(B, L * 4, 3)
    b = torch.nan_to_num(native_xyz[:, :, :4], nan=0.0).reshape(B, L * 4, 3)
    return a, b, bb_ok


def interface_rmsd(model_xyz, native_xyz, atom_mask, rec_mask, lig_mask,
                   cutoff: float = 10.0, d_nat=None) -> torch.Tensor:
    """Backbone RMSD over native-interface residues after superposition.

    Interface = residues of either group with any heavy atom within
    ``cutoff`` A of the other group in the *native* structure (DockQ); RMSD
    over their N/CA/C/O after mask-weighted Kabsch on the same set.
    Returns ``(B,)``.
    """
    if d_nat is None:
        d_nat = _min_interchain_dist(native_xyz, atom_mask, rec_mask, lig_mask)
    contact = d_nat < cutoff
    iface = (contact.any(2) & rec_mask) | (contact.any(1) & lig_mask)  # (B, L)
    a, b, bb_ok = _backbone(model_xyz, native_xyz, atom_mask)
    return rmsd(a, b, mask=(iface[:, :, None] & bb_ok).reshape(a.shape[:2]), align=True)


def dockq(model_xyz, native_xyz, atom_mask, rec_mask, lig_mask) -> torch.Tensor:
    """DockQ score (Basu & Wallner 2016), ``(B,)`` in [0, 1].

    ``DockQ = (fnat + 1/(1+(iRMS/1.5)^2) + 1/(1+(LRMS/8.5)^2)) / 3`` with
    LRMS the ligand backbone RMSD after superposition on the receptor
    backbone.  Bands: >0.23 acceptable, >0.49 medium, >0.80 high.
    """
    # one min-interchain distance map per structure, shared by fnat and the
    # interface definition
    d_nat = _min_interchain_dist(native_xyz, atom_mask, rec_mask, lig_mask)
    d_mod = _min_interchain_dist(model_xyz, atom_mask, rec_mask, lig_mask)
    f = fnat(model_xyz, native_xyz, atom_mask, rec_mask, lig_mask, d_nat=d_nat, d_mod=d_mod)
    irms = interface_rmsd(model_xyz, native_xyz, atom_mask, rec_mask, lig_mask, d_nat=d_nat)

    # LRMS: superpose on the receptor backbone, measure the ligand backbone
    a, b, bb_ok = _backbone(model_xyz, native_xyz, atom_mask)
    w_rec = (rec_mask[:, :, None] & bb_ok).reshape(a.shape[:2])
    w_lig = (lig_mask[:, :, None] & bb_ok).reshape(a.shape[:2])
    sq = ((_aligned(a, b, w_rec) - b) ** 2).sum(-1)
    lrms = torch.sqrt(_masked_mean(sq, w_lig, -1))
    return (f + 1.0 / (1.0 + (irms / 1.5) ** 2) + 1.0 / (1.0 + (lrms / 8.5) ** 2)) / 3.0


def capri_band(q: float) -> str:
    """CAPRI quality band for a DockQ score (Basu & Wallner 2016, Table 1);
    boundary values land in the UPPER band:
    incorrect < 0.23 <= acceptable < 0.49 <= medium < 0.80 <= high."""
    return ("high" if q >= 0.80 else
            "medium" if q >= 0.49 else
            "acceptable" if q >= 0.23 else "incorrect")
