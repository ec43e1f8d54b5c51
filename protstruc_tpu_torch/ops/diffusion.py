"""Euclidean diffusion over atom coordinates.

Port of ``protstruc_tpu/ops/diffusion.py``: the cosine variance schedule,
the DDPM forward step, the T-step forward trajectory, the closed-form
marginal, and ancestral reverse sampling.  The JAX package runs the loops
under ``lax.scan`` with explicit PRNG keys; here they are plain loops and
the noise comes from a ``torch.Generator`` (on the coordinates' device, or
None for the global one).  Each public function draws its noise and hands
it to a private core (``_diffuse_step``, ``_diffusion_trajectory``,
``_ddpm_reverse_step``, ``_ddpm_sample``, ``_forward_marginal``) that does
the arithmetic, so the same noise gives the same result in both packages.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = [
    "cosine_variance_schedule",
    "diffuse_step",
    "diffusion_trajectory",
    "forward_marginal",
    "ddpm_reverse_step",
    "ddpm_sample",
]


def _normal(shape, like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def cosine_variance_schedule(T: int, s: float = 8e-3, beta_max: float = 0.999,
                             device="cuda") -> torch.Tensor:
    """Nichol & Dhariwal cosine beta schedule, ``(T,)`` float32 on ``device``."""
    from protstruc_tpu_torch.batch import resolve_device

    t = torch.arange(T + 1, dtype=torch.float32, device=resolve_device(device))
    f = torch.cos((t / T + s) / (1.0 + s) * math.pi / 2.0) ** 2
    alpha_bar = f / f[0]
    betas = 1.0 - alpha_bar[1:] / alpha_bar[:-1]
    return torch.clamp(betas, 0.0, beta_max)


def _diffuse_step(xyz: torch.Tensor, eps: torch.Tensor, beta) -> torch.Tensor:
    beta = torch.as_tensor(beta, dtype=xyz.dtype, device=xyz.device)
    b = beta.reshape(beta.shape + (1,) * (xyz.dim() - beta.dim()))
    return torch.sqrt(1.0 - b) * xyz + torch.sqrt(b) * eps


def diffuse_step(xyz: torch.Tensor, beta,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One DDPM forward step: ``sqrt(1-b) x + sqrt(b) eps``, eps standard
    normal from ``generator``.  ``beta``: scalar or ``(B,)`` broadcast over
    per-structure coordinates."""
    return _diffuse_step(xyz, _normal(xyz.shape, xyz, generator), beta)


def _diffusion_trajectory(xyz: torch.Tensor, noise: Sequence[torch.Tensor],
                          betas: torch.Tensor, keep_trajectory: bool = False):
    x, traj = xyz, []
    for eps, b in zip(noise, betas):
        x = _diffuse_step(x, eps, b)
        if keep_trajectory:
            traj.append(x)
    if keep_trajectory:
        return x, torch.stack(traj)
    return x


def diffusion_trajectory(xyz: torch.Tensor, betas: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         keep_trajectory: bool = False):
    """The full T-step forward process.

    ``xyz``: ``(B, ...)`` coordinates; ``betas``: ``(T,)`` or ``(T, B)``;
    each step draws its noise from ``generator``.  Returns ``xyz_T``, or
    ``(xyz_T, trajectory (T, B, ...))`` with ``keep_trajectory``.
    """
    noise = (_normal(xyz.shape, xyz, generator) for _ in range(betas.shape[0]))
    return _diffusion_trajectory(xyz, noise, betas, keep_trajectory)


def _ddpm_reverse_step(x_t: torch.Tensor, eps_hat: torch.Tensor, z: torch.Tensor,
                       betas: torch.Tensor, t: int, clip_x0: Optional[float] = None,
                       alpha_bar: Optional[torch.Tensor] = None) -> torch.Tensor:
    t = int(t)
    alphas = 1.0 - betas
    if alpha_bar is None:
        alpha_bar = torch.cumprod(alphas, dim=0)
    ab_t = alpha_bar[t]
    ab_prev = alpha_bar[t - 1] if t > 0 else torch.ones_like(ab_t)
    a_t = alphas[t]
    b_t = betas[t]

    x0_hat = (x_t - torch.sqrt(1.0 - ab_t) * eps_hat) / torch.sqrt(ab_t)
    if clip_x0 is not None:
        x0_hat = torch.clamp(x0_hat, -clip_x0, clip_x0)

    mean = (torch.sqrt(ab_prev) * b_t * x0_hat
            + torch.sqrt(a_t) * (1.0 - ab_prev) * x_t) / (1.0 - ab_t)
    if t == 0:
        return mean
    var = b_t * (1.0 - ab_prev) / (1.0 - ab_t)
    return mean + torch.sqrt(var) * z


def ddpm_reverse_step(x_t: torch.Tensor, eps_hat: torch.Tensor, betas: torch.Tensor, t: int,
                      clip_x0: Optional[float] = None,
                      alpha_bar: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One ancestral DDPM reverse step ``x_t -> x_{t-1}``.

    The implied ``x0_hat = (x_t - sqrt(1-abar_t) eps_hat) / sqrt(abar_t)``
    (clipped to ``[-clip_x0, clip_x0]`` when given) feeds the posterior mean
    of ``q(x_{t-1} | x_t, x0_hat)``; no noise is added at t = 0.  ``t`` is
    the step index; ``alpha_bar``: optional precomputed ``cumprod(1 - betas)``.
    """
    z = _normal(x_t.shape, x_t, generator)
    return _ddpm_reverse_step(x_t, eps_hat, z, betas, t, clip_x0, alpha_bar)


def _ddpm_sample(denoise_fn: Callable, x_T: torch.Tensor, noise: Sequence[torch.Tensor],
                 betas: torch.Tensor, keep_trajectory: bool = False,
                 clip_x0: Optional[float] = None):
    T = betas.shape[0]
    alpha_bar = torch.cumprod(1.0 - betas, dim=0)
    x, traj = x_T, []
    for z, t in zip(noise, range(T - 1, -1, -1)):
        x = _ddpm_reverse_step(x, denoise_fn(x, t), z, betas, t, clip_x0, alpha_bar)
        if keep_trajectory:
            traj.append(x)
    if keep_trajectory:
        return x, torch.stack(traj)
    return x


def ddpm_sample(denoise_fn: Callable, shape: Tuple[int, ...], betas: torch.Tensor,
                keep_trajectory: bool = False, clip_x0: Optional[float] = None,
                generator: Optional[torch.Generator] = None):
    """Full reverse diffusion: noise -> sample, in ``betas``' dtype and on its
    device.

    ``denoise_fn(x_t, t) -> eps_hat`` with ``t`` a Python int step index;
    ``shape`` the sample shape; ``betas`` the forward schedule; ``clip_x0``
    bounds the implied x0 (recommended for imperfect denoisers).  ``x_T``
    and each step's noise come from ``generator``.  Returns ``x_0`` (or
    ``(x_0, trajectory (T, ...))``).
    """
    x_T = _normal(shape, betas, generator)
    noise = (_normal(shape, betas, generator) for _ in range(betas.shape[0]))
    return _ddpm_sample(denoise_fn, x_T, noise, betas, keep_trajectory, clip_x0)


def _forward_marginal(xyz: torch.Tensor, eps: torch.Tensor, betas: torch.Tensor,
                      t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    alpha_bar = torch.cumprod(1.0 - betas, dim=0)
    t = torch.as_tensor(t, device=betas.device).long()
    ab_t = alpha_bar[t].reshape((-1,) + (1,) * (xyz.dim() - 1))
    return torch.sqrt(ab_t) * xyz + torch.sqrt(1.0 - ab_t) * eps, eps


def forward_marginal(xyz: torch.Tensor, betas: torch.Tensor, t: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form q(x_t | x_0) sample: ``sqrt(abar_t) x_0 + sqrt(1 - abar_t)
    eps``.  Returns ``(x_t, eps)``; ``t``: ``(B,)`` step indices into
    ``betas``."""
    return _forward_marginal(xyz, _normal(xyz.shape, xyz, generator), betas, t)
