"""Rigid transforms: quaternions and frame algebra (port of the part of
``protstruc_tpu/ops/rigid.py`` the structure module uses).

Rotations are ``(..., 3, 3)`` column-basis matrices consistent with
``geometry.gram_schmidt``; a frame ``(r, t)`` acts as ``x -> r x + t``.  The
JAX package pins these products to full float32 precision
(``precision="highest"``); here they are float32 ``einsum``s, which run in
full float32 on the CPU and on the card unless TF32 is switched on.
"""

from __future__ import annotations

import torch

__all__ = ["quat_to_rot", "frame_compose", "frame_invert", "frame_apply"]


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
