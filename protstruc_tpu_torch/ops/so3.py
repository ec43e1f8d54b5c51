"""SO(3) maps and isotropic-Gaussian rotation diffusion (IGSO3), port of
``protstruc_tpu/ops/so3.py``.

Axis-angle <-> matrix maps with double-where guards at the 0 and pi
singularities, IGSO(3) sampling by inverse-CDF lookup in a table that the
host computes once in float64 numpy (``igso3_table``, a copy of the JAX
package's series, cached), the rotation score's scalar part and geodesic
interpolation.  The tables go to each device once.

Randomness: ``sample_igso3`` draws its inverse-CDF uniforms, then its axis
normals, from a ``torch.Generator`` on the generator's device and hands them
to the private core ``_sample_igso3``; the JAX function draws the same two
things from ``split(key)``, so the same draws give the same rotations.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from protstruc_tpu_torch.ops.rigid import rot_to_quat

__all__ = [
    "rotvec_to_rot",
    "rot_to_rotvec",
    "igso3_table",
    "sample_igso3",
    "igso3_score_norm",
    "geodesic_interp",
]

_EPS = 1e-8


def _default_device(device) -> torch.device:
    """``device``, or the card when it is None (raising without one)."""
    from protstruc_tpu_torch.batch import resolve_device

    return resolve_device(device if device is not None else "cuda")


def rotvec_to_rot(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle vector ``(..., 3)`` -> rotation matrix (Rodrigues), with the
    Taylor limits of ``sin(w)/w`` and ``(1 - cos w)/w^2`` below ``w^2 = 1e-8``."""
    w2 = (v * v).sum(-1)
    small = w2 < 1e-8
    w2_safe = torch.where(small, 1.0, w2)
    w = torch.sqrt(w2_safe)
    a = torch.where(small, 1.0 - w2 / 6.0, torch.sin(w) / w)
    b = torch.where(small, 0.5 - w2 / 24.0, (1.0 - torch.cos(w)) / w2_safe)
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(v.shape[:-1] + (3, 3))
    K2 = K @ K
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def rot_to_rotvec(r: torch.Tensor) -> torch.Tensor:
    """Rotation ``(..., 3, 3)`` -> axis-angle vector, angle in [0, pi], through
    the quaternion (well conditioned at 0 and at pi)."""
    q = rot_to_quat(r)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    n2 = (xyz * xyz).sum(-1)
    small = n2 < 1e-12
    n = torch.sqrt(torch.where(small, 1.0, n2))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0, angle / n)
    return xyz * scale[..., None]


@lru_cache(maxsize=4)
def igso3_table(n_sigma: int = 256, n_omega: int = 1024, sigma_min: float = 0.01,
                sigma_max: float = 3.0, l_max: int = 1000
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """IGSO(3) inverse-CDF and score tables, float64 numpy on the host, cached.

    The angle density at concentration ``sigma`` is ``f(w) (1 - cos w) / pi``
    with the heat-kernel series ``f(w) = sum_l (2l+1) exp(-l(l+1) sigma^2/2)
    sin((l+1/2) w) / sin(w/2)``.  Returns ``(sigmas (S,), omegas (W,), cdf
    (S, W), score_norm (S, W))`` as float32 arrays; ``score_norm = d/dw log f``,
    with the wrapped-Gaussian tail ``-w / sigma^2`` where the series
    underflows (``f <= 1e-8``).
    """
    sigmas = np.exp(np.linspace(np.log(sigma_min), np.log(sigma_max), n_sigma)).astype(np.float64)
    omegas = np.linspace(1e-5, np.pi - 1e-5, n_omega).astype(np.float64)
    ls = np.arange(l_max + 1, dtype=np.float64)[:, None]  # (L, 1)
    w = omegas[None, :]
    f = np.empty((n_sigma, n_omega), dtype=np.float64)
    dlogf = np.empty_like(f)
    sin_half = np.sin(w / 2.0)
    sin_l = np.sin((ls + 0.5) * w)
    cos_l = np.cos((ls + 0.5) * w)
    for i, s in enumerate(sigmas):
        coef = (2.0 * ls[:, 0] + 1.0) * np.exp(-ls[:, 0] * (ls[:, 0] + 1.0) * s * s / 2.0)
        fi = (coef[:, None] * sin_l / sin_half).sum(0)
        dfi = (coef[:, None] * ((ls + 0.5) * cos_l / sin_half
                                - 0.5 * sin_l * np.cos(w / 2.0) / sin_half ** 2)).sum(0)
        f[i] = np.maximum(fi, 1e-30)
        safe = fi > 1e-8
        dlogf[i] = np.where(safe, dfi / np.maximum(fi, 1e-30), -omegas / (s * s))
    pdf = f * (1.0 - np.cos(omegas)[None, :]) / np.pi
    cdf = np.cumsum(pdf, axis=1)
    cdf /= cdf[:, -1:]
    return (sigmas.astype(np.float32), omegas.astype(np.float32), cdf.astype(np.float32),
            dlogf.astype(np.float32))


def _tables(device: torch.device):
    """``igso3_table()`` as float32 tensors on ``device`` (copied once)."""
    return _device_tables(str(device))


@lru_cache(maxsize=8)
def _device_tables(device: str):
    return tuple(torch.from_numpy(a).to(device) for a in igso3_table())


def _interp_sigma_row(table: torch.Tensor, sigmas: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Table rows linearly interpolated at ``sigma (N,)`` (clamped to the grid)."""
    sigma = torch.clamp(sigma, sigmas[0], sigmas[-1])
    idx = torch.searchsorted(sigmas, sigma, right=True) - 1
    idx = torch.clamp(idx, 0, sigmas.shape[0] - 2)
    w = (sigma - sigmas[idx]) / (sigmas[idx + 1] - sigmas[idx])
    return (1.0 - w)[..., None] * table[idx] + w[..., None] * table[idx + 1]


def _sample_igso3(sigma, shape: Tuple[int, ...], u: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """IGSO3 rotations ``(*shape, 3, 3)`` from the draws: ``u (N,)`` uniform in
    [0, 1) (N = prod(shape)) and ``axis (*shape, 3)`` standard normal."""
    sigmas, omegas, cdf, _ = _tables(u.device)
    shape = tuple(shape)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=u.device).broadcast_to(shape)
    rows = _interp_sigma_row(cdf, sigmas, sigma.reshape(-1))  # (N, W)
    pos = torch.searchsorted(rows, u[:, None].contiguous())[:, 0]  # side "left", as jnp
    pos = torch.clamp(pos, 1, omegas.shape[0] - 1)
    c1 = torch.gather(rows, 1, pos[:, None])[:, 0]
    c0 = torch.gather(rows, 1, pos[:, None] - 1)[:, 0]
    t = (u - c0) / torch.clamp_min(c1 - c0, 1e-12)
    omega = (omegas[pos - 1] + t * (omegas[pos] - omegas[pos - 1])).reshape(shape)
    axis = axis / torch.clamp_min(torch.linalg.vector_norm(axis, dim=-1, keepdim=True), _EPS)
    return rotvec_to_rot(axis * omega[..., None])


def igso3_draws(shape: Tuple[int, ...], generator: Optional[torch.Generator] = None,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws of one :func:`sample_igso3` call: ``(u (N,), axis (*shape,
    3))`` from ``generator`` on its device, or from the global generator on
    ``device`` (default the card)."""
    dev = generator.device if generator is not None else _default_device(device)
    n = int(np.prod(shape, dtype=np.int64))
    u = torch.rand((n,), generator=generator, device=dev)
    axis = torch.randn(tuple(shape) + (3,), generator=generator, device=dev)
    return u, axis


def sample_igso3(sigma, shape: Tuple[int, ...] = (), generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Rotations ``(*shape, 3, 3)`` from IGSO3(sigma): an inverse-CDF draw of
    the angle about a uniform axis.  ``sigma``: scalar or broadcastable to
    ``shape``.  The draws come from ``generator`` on its device, or from the
    global generator on ``device`` (default the card)."""
    return _sample_igso3(sigma, shape, *igso3_draws(shape, generator, device))


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` row by row: ``x (N,)``, one grid ``xp (W,)``, rows ``fp (N, W)``."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    f0 = torch.gather(fp, 1, (i - 1)[:, None])[:, 0]
    f1 = torch.gather(fp, 1, i[:, None])[:, 0]
    dx = xp[i] - xp[i - 1]
    dx0 = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(dx0, f0, f0 + ((x - xp[i - 1]) / torch.where(dx0, 1.0, dx)) * (f1 - f0))
    f = torch.where(x < xp[0], fp[:, 0], f)
    return torch.where(x > xp[-1], fp[:, -1], f)


def igso3_score_norm(sigma, omega, device=None) -> torch.Tensor:
    """``d/dw log f(w; sigma)``, the scalar part of the IGSO3 score (the full
    score at ``R = exp(w axis)`` is this times ``axis``).  On ``omega``'s
    device when it is a tensor, else ``sigma``'s, else ``device`` (default
    the card)."""
    dev = next((x.device for x in (omega, sigma) if isinstance(x, torch.Tensor)), None)
    dev = dev if dev is not None else _default_device(device)
    sigmas, omegas, _, dlogf = _tables(dev)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=dev)
    omega = torch.as_tensor(omega, dtype=torch.float32, device=dev)
    shape = torch.broadcast_shapes(sigma.shape, omega.shape)
    rows = _interp_sigma_row(dlogf, sigmas, sigma.broadcast_to(shape).reshape(-1))
    return _interp(omega.broadcast_to(shape).reshape(-1).contiguous(), omegas, rows).reshape(shape)


def geodesic_interp(r0: torch.Tensor, r1: torch.Tensor, alpha) -> torch.Tensor:
    """``r0 @ exp(alpha * log(r0^T r1))``: ``alpha = 0`` gives ``r0``, 1 gives ``r1``."""
    rel = r0.transpose(-2, -1) @ r1
    v = rot_to_rotvec(rel)
    alpha = torch.as_tensor(alpha, dtype=v.dtype, device=v.device)[..., None]
    return r0 @ rotvec_to_rot(v * alpha)
