"""Distance binning (port of ``distogram_bins`` from ``protstruc_tpu/ops/histogram.py``).

Only the binning TrFold needs (distogram targets and the pair embedding) is
ported; ``contact_map`` and ``distance_histogram`` wait for the analysis ops.
"""

from __future__ import annotations

import torch

__all__ = ["distogram_bins"]


def distogram_bins(d: torch.Tensor, n_bins: int = 36,
                   max_dist: float = 20.0) -> torch.Tensor:
    """Uniform distance binning ``[0, max_dist) -> {0..n_bins-1}``, int32.

    NaN distances (missing atoms) land in the last bin.  The float order is
    the JAX package's, ``d / max_dist * n_bins`` (another order moves values
    that sit on a bin edge), then truncation toward zero and a clip to the bin
    range.  XLA's float-to-int conversion saturates (+inf and values past the
    int32 range become the largest int32), so the float is clipped to the bin
    range before the cast, which gives the same bins on every input.  The
    divisor is a tensor on ``d``'s device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which is not the same rounding.
    """
    d = torch.nan_to_num(d, nan=max_dist)
    v = d / torch.tensor(max_dist, dtype=d.dtype, device=d.device) * n_bins
    return v.clamp(0, n_bins - 1).to(torch.int32)
