"""Rigid transforms: quaternions, rotations and frame algebra (port of
``protstruc_tpu/ops/rigid.py``).

Rotations are ``(..., 3, 3)`` column-basis matrices consistent with
``geometry.gram_schmidt``; a frame ``(r, t)`` acts as ``x -> r x + t``.  The
JAX package pins these products to full float32 precision
(``precision="highest"``); here they are float32 ``einsum``s, which run in
full float32 on the CPU and on the card unless TF32 is switched on.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["quat_to_rot", "rot_to_quat", "random_rotations", "frame_compose", "frame_invert",
           "frame_apply", "rotation_angle"]


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) ``(..., 4)``, normalised here, -> rotation ``(..., 3, 3)``."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def rot_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Rotation ``(..., 3, 3)`` -> unit quaternion (w, x, y, z) with w >= 0.

    Branch-free Shepperd extraction: the four candidate quaternions are all
    computed and the one with the largest denominator is taken.
    """
    m = r
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    t = m00 + m11 + m22
    q0 = (1 + t, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1])
    q1 = (m[..., 2, 1] - m[..., 1, 2], 1 + m00 - m11 - m22, m[..., 0, 1] + m[..., 1, 0],
          m[..., 0, 2] + m[..., 2, 0])
    q2 = (m[..., 0, 2] - m[..., 2, 0], m[..., 0, 1] + m[..., 1, 0], 1 - m00 + m11 - m22,
          m[..., 1, 2] + m[..., 2, 1])
    q3 = (m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1],
          1 - m00 - m11 + m22)
    qs = torch.stack([torch.stack(q, dim=-1) for q in (q0, q1, q2, q3)], dim=-2)  # (..., 4, 4)
    norms = torch.stack([1 + t, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(norms, dim=-1)
    q = torch.gather(qs, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def random_rotations(shape: Tuple[int, ...] = (), generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """Uniform (Haar) random rotations ``(*shape, 3, 3)``: normalised Gaussian
    quaternions drawn from ``generator`` on its device, or from the global
    generator on ``device`` (default the card)."""
    from protstruc_tpu_torch.batch import resolve_device

    dev = generator.device if generator is not None else resolve_device(device or "cuda")
    q = torch.randn(tuple(shape) + (4,), generator=generator, device=dev)
    return quat_to_rot(q)


def frame_compose(r1, t1, r2, t2):
    """``(r1, t1)`` after ``(r2, t2)``: ``x -> r1 (r2 x + t2) + t1``."""
    r = torch.einsum("...ij,...jk->...ik", r1, r2)
    t = torch.einsum("...ij,...j->...i", r1, t2) + t1
    return r, t


def frame_invert(r, t):
    """Inverse transform ``x -> r^T (x - t)``."""
    r_inv = r.transpose(-2, -1)
    return r_inv, -torch.einsum("...ij,...j->...i", r_inv, t)


def frame_apply(r, t, x):
    """Apply frames to points ``(..., n, 3)`` (frames broadcast over n)."""
    return torch.einsum("...ij,...nj->...ni", r, x) + t[..., None, :]


def rotation_angle(r: torch.Tensor) -> torch.Tensor:
    """Rotation angle in [0, pi] of ``(..., 3, 3)`` rotations.

    Gradient-safe at the arccos saturation points (identity and antipodal
    rotations): the cosine reaches arccos only strictly inside
    ``(-1 + 1e-6, 1 - 1e-6)``; beyond it the exact boundary angle (0 or pi)
    comes back as a constant with zero gradient.
    """
    t = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    c = torch.clamp((t - 1.0) / 2.0, -1.0, 1.0)
    near = c.abs() < 1.0 - 1e-6
    safe = torch.where(near, c, 0.0)
    boundary = torch.where(c > 0.0, 0.0, math.pi)
    return torch.where(near, torch.arccos(safe), boundary)
