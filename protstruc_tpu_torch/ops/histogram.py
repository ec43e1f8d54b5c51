"""Distance binning, contact maps and pair-distance histograms (port of
``protstruc_tpu/ops/histogram.py``).

``distance_histogram`` bins every pair once and counts with ``bincount`` over
``b * n_bins + bin``, a chunk of structures at a time, where the JAX package
sweeps one masked reduction per bin; the counts are the same integers.  JAX
computes these outside any Pallas kernel, so plain PyTorch is their port.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["distogram_bins", "contact_map", "distance_histogram"]

#: Pairs binned at once by ``distance_histogram``: its int64 keys take 8 bytes
#: a pair, so a chunk holds 512 MiB of them (BASELINE config 5, B = 1024,
#: L = 1024, runs in 16 chunks of 64 structures).
HISTOGRAM_CHUNK_PAIRS = 1 << 26


def _bin_of(d: torch.Tensor, max_dist: float, n_bins: int) -> torch.Tensor:
    """``d / max_dist * n_bins`` in ``d``'s dtype, JAX's float order.  The
    divisor is a tensor on ``d``'s device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which is not the same rounding."""
    return d / torch.tensor(max_dist, dtype=d.dtype, device=d.device) * n_bins


def distogram_bins(d: torch.Tensor, n_bins: int = 36,
                   max_dist: float = 20.0) -> torch.Tensor:
    """Uniform distance binning ``[0, max_dist) -> {0..n_bins-1}``, int32.

    NaN distances (missing atoms) land in the last bin.  The float order is
    the JAX package's, ``d / max_dist * n_bins`` (another order moves values
    that sit on a bin edge), then truncation toward zero and a clip to the bin
    range.  XLA's float-to-int conversion saturates (+inf and values past the
    int32 range become the largest int32), so the float is clipped to the bin
    range before the cast, which gives the same bins on every input.
    """
    d = torch.nan_to_num(d, nan=max_dist)
    return _bin_of(d, max_dist, n_bins).clamp(0, n_bins - 1).to(torch.int32)


def contact_map(d: torch.Tensor, mask: Optional[torch.Tensor] = None,
                cutoff: float = 8.0) -> torch.Tensor:
    """Boolean contact map ``d < cutoff`` (NaN is no contact), optionally masked."""
    c = torch.nan_to_num(d, nan=float("inf")) < cutoff
    if mask is not None:
        c = c & mask
    return c


def distance_histogram(d: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       n_bins: int = 64, max_dist: float = 32.0) -> torch.Tensor:
    """Per-structure histogram of pair distances, ``(B, L, L) -> (B, n_bins)`` int32.

    Bin b counts pairs with ``d in [b*w, (b+1)*w)``, ``w = max_dist/n_bins``,
    the bin taken as JAX takes it (``d / max_dist * n_bins`` in ``d``'s dtype,
    truncated), so a pair on an edge lands where it lands there.
    Out-of-range, negative and NaN pairs are dropped.  ``mask`` broadcasts
    against ``d``.
    """
    B = d.shape[0]
    out = torch.zeros((B, n_bins), dtype=torch.int32, device=d.device)
    if d.numel() == 0:
        return out
    if mask is not None:
        mask = torch.broadcast_to(mask, d.shape)
    per = max(1, HISTOGRAM_CHUNK_PAIRS // d[0].numel())
    for b0 in range(0, B, per):
        dc = d[b0:b0 + per]
        nb = dc.shape[0]
        valid = torch.isfinite(dc) & (dc >= 0) & (dc < max_dist)
        if mask is not None:
            valid &= mask[b0:b0 + per]
        # d < max_dist gives a correctly rounded d / max_dist below 1, so the
        # bin stays below n_bins
        idx = _bin_of(torch.where(valid, dc, 0), max_dist, n_bins).to(torch.int64)
        row = torch.arange(nb, device=d.device).view((nb,) + (1,) * (dc.dim() - 1))
        # dropped pairs go to one spare bin past the last structure's
        key = torch.where(valid, row * n_bins + idx, nb * n_bins)
        counts = torch.bincount(key.reshape(-1), minlength=nb * n_bins + 1)
        out[b0:b0 + nb] = counts[:nb * n_bins].view(nb, n_bins).to(torch.int32)
    return out
