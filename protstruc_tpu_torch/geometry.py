"""Core 3D geometry on torch tensors (port of ``protstruc_tpu/geometry.py``).

Every function operates on tensors with arbitrary leading batch dimensions
and a trailing coordinate axis of size 3, and follows the JAX package's
numerical conventions exactly, including the explicit pinning of degenerate
values: rounding pushes ``|cos|`` past 1 for collinear points (``angle``)
and ``atan2(+/-0, +/-0)`` depends on the sign of zero (``dihedral``), so both
are decided by explicit comparisons, never by the sign of zero or by FMA
contraction.

The JAX package runs these functions under ``jit``, where XLA contracts the
sum of products into fused multiply-adds and rounds ``sqrt`` correctly.
``dot`` and ``norm`` reproduce that arithmetic (``addcmul`` chain, square
root taken in float64), because ``angle``'s arccos amplifies a one-ulp
difference in the cosine to more than 1e-5 near ``|cos| = 1``.

This slice ports what the featurization path needs: ``dot``, ``norm``,
``unit``, ``angle``, ``dihedral`` and ``gram_schmidt``.
"""

from __future__ import annotations

import math

import torch

__all__ = ["dot", "norm", "unit", "angle", "dihedral", "gram_schmidt"]


def dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner product over the last axis, keepdims. Shape ``(..., 3) -> (..., 1)``.

    Evaluated as ``fma(x2, y2, fma(x1, y1, x0 * y0))``.
    """
    t = x[..., 0] * y[..., 0]
    t = torch.addcmul(t, x[..., 1], y[..., 1])
    return torch.addcmul(t, x[..., 2], y[..., 2]).unsqueeze(-1)


def _exact_sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root (PyTorch's CPU float32 sqrt is not)."""
    return torch.sqrt(x.double()).to(x.dtype)


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, keepdims. Shape ``(..., 3) -> (..., 1)``."""
    return _exact_sqrt(dot(x, x))


def unit(x: torch.Tensor) -> torch.Tensor:
    """Unit vector along the last axis."""
    return x / norm(x)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def angle(a, b, c, to_degree: bool = False) -> torch.Tensor:
    """Planar angle at ``b`` between points ``a``-``b``-``c``.

    Returns values in ``[0, pi]`` radians (``[0, 180]`` if ``to_degree``),
    with the trailing singleton axis squeezed: ``(..., 3) -> (...,)``.
    (Anti)parallel configurations are pinned to the exact boundary angle;
    a NaN cosine (coincident points, 0/0) stays NaN, the missing/degenerate
    convention of the JAX package.
    """
    ba = a - b
    bc = c - b
    cos = dot(ba, bc) / (norm(ba) * norm(bc))
    was_nan = torch.isnan(cos)
    cos = torch.clamp(cos, -1.0, 1.0)
    near = torch.abs(cos) < 1.0 - 1e-7
    zero = torch.zeros_like(cos)
    theta = torch.where(
        near,
        torch.arccos(torch.where(near, cos, zero)),
        torch.where(cos > 0.0, zero, torch.full_like(cos, math.pi)),
    )
    theta = torch.where(was_nan, torch.full_like(theta, math.nan), theta)
    if to_degree:
        theta = torch.rad2deg(theta)
    return theta.squeeze(-1)


def dihedral(a, b, c, d, to_degree: bool = False) -> torch.Tensor:
    """Signed dihedral angle of ``a``-``b``-``c``-``d`` in ``(-pi, pi]``.

    Sign convention: ``dihedral((1,0,0), (0,0,0), (0,1,0), (0,1,1)) == -pi/2``.
    Shape ``(..., 3) -> (...,)`` with broadcasting over leading dims.
    Degenerate (zero-vector) configurations, where both atan2 arguments are
    exactly 0, are pinned to 0 explicitly.
    """
    b0 = a - b
    b1 = c - b
    b2 = d - c

    n0 = _cross(b0, b1)
    n1 = _cross(b2, b1)
    m = _cross(n0, n1)

    x = dot(n0, n1)
    y = dot(m, b1) / norm(b1)

    deg = (x == 0.0) & (y == 0.0)
    one = torch.ones_like(x)
    theta = torch.where(
        deg, torch.zeros_like(x),
        torch.atan2(torch.where(deg, one, y), torch.where(deg, one, x)),
    )
    if to_degree:
        theta = torch.rad2deg(theta)
    return theta.squeeze(-1)


def gram_schmidt(a, b, c) -> torch.Tensor:
    """Orthonormal frame from three points, basis vectors stacked as columns.

    ``e1 = unit(c - b)``, ``e2`` = unit component of ``a - b`` orthogonal to
    ``e1``, ``e3 = e1 x e2``.  Returns ``(..., 3, 3)`` with ``[..., :, i]``
    the i-th basis vector.
    """
    v1 = c - b
    e1 = v1 / norm(v1)

    v2 = a - b
    u2 = v2 - dot(e1, v2) * e1
    e2 = u2 / norm(u2)

    e3 = _cross(e1, e2)
    return torch.stack([e1, e2, e3], dim=-1)
