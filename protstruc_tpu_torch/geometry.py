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

Ported so far: what the featurization path needs (``dot``, ``norm``,
``unit``, ``angle``, ``dihedral``, ``gram_schmidt``) and what the FoldModel
trainer needs (``place_fourth_atom``, ``ideal_backbone_coordinates``,
``ideal_carbonyl_oxygen``, ``kabsch``, ``masked_kabsch``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from protstruc_tpu_torch.constants import ideal

__all__ = ["dot", "norm", "unit", "angle", "dihedral", "gram_schmidt", "place_fourth_atom",
           "ideal_backbone_coordinates", "ideal_carbonyl_oxygen", "kabsch", "masked_kabsch"]


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


def place_fourth_atom(a, b, c, length, planar, dihedral_angle) -> torch.Tensor:
    """NeRF placement of X from A, B, C: bond ``|CX| = length``, angle
    X-C-B ``planar`` and dihedral X-C-B-A ``dihedral_angle`` (Python floats)."""
    bc = unit(b - c)
    n = unit(_cross(b - a, bc))
    d1, d2, d3 = bc, _cross(n, bc), n
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=a.device)  # noqa: E731
    cos_p, sin_p = torch.cos(f32(planar)), torch.sin(f32(planar))
    cos_d, sin_d = torch.cos(f32(dihedral_angle)), torch.sin(f32(dihedral_angle))
    m1 = length * cos_p
    m2 = length * sin_p * cos_d
    m3 = -length * sin_p * sin_d
    return c + m1 * d1 + m2 * d2 + m3 * d3


def ideal_backbone_coordinates(size, include_cb: bool = False, device="cuda") -> torch.Tensor:
    """Ideal N, CA, C (and CB) with CA at the origin, C on +x and N in the
    xy-plane, so that ``gram_schmidt(N, CA, C)`` is the identity frame.
    Shape ``(*size, 3|4, 3)``, float32, on ``device``."""
    from protstruc_tpu_torch.batch import resolve_device

    f32 = dict(dtype=torch.float32, device=resolve_device(device))
    ca = torch.zeros(3, **f32)
    c = torch.tensor([ideal.AC, 0.0, 0.0], **f32)
    n = torch.tensor([ideal.NA * math.cos(ideal.NAC), ideal.NA * math.sin(ideal.NAC), 0.0], **f32)
    if include_cb:
        _b, _c = ca - n, c - ca
        _a = torch.linalg.cross(_b, _c)
        # AlphaFold's CB-from-backbone combination
        cb = -0.58273431 * _a + 0.56802827 * _b - 0.54067466 * _c + ca
        xyz = torch.stack([n, ca, c, cb])
    else:
        xyz = torch.stack([n, ca, c])
    return xyz.expand(tuple(size) + xyz.shape)


def ideal_carbonyl_oxygen(n, ca, c, chain_idx=None) -> torch.Tensor:
    """Backbone O placed ideally from (N_{i+1}, CA_i, C_i); residues without
    a next N in their chain (the array's last one, and with ``chain_idx
    (..., L)`` each chain's last one) take the extended ideal-psi placement,
    dih(N, CA, C, O) = 135 deg - pi.  Residue axis second to last."""
    n_next = torch.roll(n, shifts=-1, dims=-2)
    L = n.shape[-2]
    is_last = torch.arange(L, device=n.device) == L - 1
    if chain_idx is not None:
        is_last = is_last | (chain_idx != torch.roll(chain_idx, shifts=-1, dims=-1))
    o_mid = place_fourth_atom(n_next, ca, c, ideal.CO, ideal.ACO, ideal.NACO)
    o_term = place_fourth_atom(n, ca, c, ideal.CO, ideal.ACO, math.radians(135.0) - math.pi)
    return torch.where(is_last[..., None], o_term, o_mid)


def masked_kabsch(a, b, weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Kabsch superposition ``R a + t ~ b`` of ``(..., n, 3)`` point
    sets; zero-weight points (NaN allowed there) take no part.  Returns
    ``R (..., 3, 3)``, ``t (..., 3)``."""
    w = weights.to(a.dtype)[..., None]
    a = torch.where(w > 0, a, 0.0)
    b = torch.where(w > 0, b, 0.0)
    wsum = w.sum(-2, keepdim=True)
    centroid_a = (a * w).sum(-2, keepdim=True) / wsum
    centroid_b = (b * w).sum(-2, keepdim=True) / wsum
    a_c = (a - centroid_a) * w
    b_c = b - centroid_b
    h = torch.einsum("...ki,...kj->...ij", a_c, b_c)
    u, _, vt = torch.linalg.svd(h, full_matrices=False)
    v = vt.transpose(-2, -1)
    d = torch.sign(torch.linalg.det(v @ u.transpose(-2, -1)))
    diag = torch.ones(h.shape[:-2] + (3,), dtype=a.dtype, device=a.device)
    diag = torch.cat([diag[..., :2], d[..., None]], dim=-1)
    r = torch.einsum("...ij,...j,...kj->...ik", v, diag, u)
    t = centroid_b.squeeze(-2) - torch.einsum("...ij,...j->...i", r, centroid_a.squeeze(-2))
    return r, t


def kabsch(a, b) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unweighted :func:`masked_kabsch`."""
    return masked_kabsch(a, b, torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device))
