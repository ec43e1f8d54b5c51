"""Structure metrics the FoldModel trainer reads (port of ``lddt`` and
``rmsd`` from ``protstruc_tpu/ops/metrics.py``): batched, masks as weights."""

from __future__ import annotations

import torch

from protstruc_tpu_torch import geometry as geom

__all__ = ["rmsd", "lddt"]


def _masked_mean(x, w, dim):
    # where, not x * w: NaN residuals at masked positions would poison the sum
    w = w.to(x.dtype)
    x = torch.where(w > 0, x, 0.0)
    return (x * w).sum(dim) / torch.clamp_min(w.sum(dim), 1.0)


def rmsd(a, b, mask=None, align: bool = True) -> torch.Tensor:
    """RMSD of point sets ``(..., n, 3)``, after a mask-weighted Kabsch
    superposition of ``a`` onto ``b`` when ``align``.  Returns ``(...,)``."""
    if mask is None:
        mask = torch.ones(a.shape[:-1], dtype=torch.bool, device=a.device)
    if align:
        r, t = geom.masked_kabsch(a, b, mask)
        a = torch.einsum("...ij,...nj->...ni", r, a) + t[..., None, :]
    sq = ((a - b) ** 2).sum(-1)
    return torch.sqrt(_masked_mean(sq, mask, -1))


def lddt(pred, ref, mask=None, cutoff: float = 15.0, thresholds=(0.5, 1.0, 2.0, 4.0),
         per_residue: bool = False) -> torch.Tensor:
    """Superposition-free lDDT over CA point sets ``(..., n, 3)``: over the
    pairs whose reference distance is below ``cutoff`` (self excluded), the
    mean fraction of distances kept within each threshold.  ``(...,)``, or
    ``(..., n)`` with ``per_residue``."""
    if mask is None:
        mask = torch.ones(pred.shape[:-1], dtype=torch.bool, device=pred.device)

    def pdist(x):
        d2 = ((x[..., :, None, :] - x[..., None, :, :]) ** 2).sum(-1)
        return torch.sqrt(torch.clamp_min(d2, 1e-12))

    d_ref, d_pred = pdist(ref), pdist(pred)
    n = pred.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=pred.device)
    incl = ((d_ref < cutoff) & ~eye & mask[..., :, None] & mask[..., None, :]).to(pred.dtype)
    diff = torch.abs(d_ref - d_pred)
    preserved = sum((diff < t).to(pred.dtype) for t in thresholds) / len(thresholds)
    dims = (-1,) if per_residue else (-2, -1)
    return (preserved * incl).sum(dims) / torch.clamp_min(incl.sum(dims), 1.0)
