"""SE(3) diffusion over backbone rigid frames (FrameDiff-style), port of
``protstruc_tpu/models/framediff.py``.

Translations follow the Euclidean VP process of ``ops/diffusion.py`` and
rotations a variance-exploding IGSO(3) process (``ops/so3.py``).  The
denoiser is the IPA :class:`~protstruc_tpu_torch.models.ipa.StructureModule`
refining from the noisy frames, conditioned on the timestep; it predicts the
clean frames (x0-parameterization).  The JAX package's ``lax.scan`` samplers
are plain loops here.

The modules keep the flax parameter tree (``t_in``, ``summ_in``, ``pos_in``,
``dist_embed``, ``relpos_embed``, ``structure.ipa...``), so
``convert.framediff_params_from_flax`` carries JAX weights across.

Randomness: each public function draws from a ``torch.Generator`` (on the
generator's device) and calls a private core that takes the draws
(``_corrupt_frames``, ``_framediff_loss``, ``_frameflow_loss``,
``_frameflow_sample``, ``_framediff_sample``), so the JAX function's own
draws, replayed, give its result.  An IGSO3 draw is the pair ``(u, axis)``
of ``ops/so3.igso3_draws``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional, Tuple

import torch
from torch import nn

from protstruc_tpu_torch.batch import resolve_device
from protstruc_tpu_torch.models._nn import Dense, Embed
from protstruc_tpu_torch.models.ipa import IPAConfig, StructureModule
from protstruc_tpu_torch.models.trfold import _check_params
from protstruc_tpu_torch.ops.diffusion import _ddpm_reverse_step, cosine_variance_schedule
from protstruc_tpu_torch.ops.rigid import rotation_angle
from protstruc_tpu_torch.ops.so3 import _sample_igso3, geodesic_interp, igso3_draws

__all__ = [
    "FrameDiffConfig",
    "FrameDenoiser",
    "corrupt_frames",
    "framediff_loss",
    "framediff_sample",
    "frameflow_loss",
    "frameflow_sample",
    "sigma_schedule",
]

IGSO3Draws = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class FrameDiffConfig:
    """The JAX package's ``FrameDiffConfig`` with a torch ``dtype``."""

    node_dim: int = 64
    pair_dim: int = 32
    n_heads: int = 4
    n_iter: int = 2
    T: int = 100
    sigma_min: float = 0.02     # IGSO3 concentration at t=0
    sigma_max: float = 1.5      # ... at t=T (near-uniform on SO(3))
    trans_scale: float = 10.0   # angstroms per unit of normalized translation
    n_dist_bins: int = 22
    dtype: torch.dtype = torch.float32

    def betas(self, device="cuda") -> torch.Tensor:
        return cosine_variance_schedule(self.T, device=device)

    def sigmas(self, device="cuda") -> torch.Tensor:
        return sigma_schedule(self.T, self.sigma_min, self.sigma_max, device=device)


def sigma_schedule(T: int, sigma_min: float, sigma_max: float, device="cuda") -> torch.Tensor:
    """Log-linear VE noise schedule of the rotation process, ``(T,)`` float32."""
    dev = resolve_device(device)
    lo = torch.log(torch.tensor(sigma_min, dtype=torch.float32))
    hi = torch.log(torch.tensor(sigma_max, dtype=torch.float32))
    return torch.exp(torch.linspace(float(lo), float(hi), T, dtype=torch.float32)).to(dev)


def _timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10_000.0) -> torch.Tensor:
    """Sinusoidal embedding ``(..., dim)`` of ``t`` in [0, 1]."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    ang = t.float()[..., None] * freqs * 1000.0
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class FrameDenoiser(nn.Module):
    """Noisy frames ``(r_t, x_t)`` + timestep ``t (B,)`` -> predicted clean
    frames.

    Node features: the timestep embedding, per-residue |x_t| and rotation
    angle, and the sequence position; pair features: the noisy CA-CA
    distance binned on edges ``linspace(0, 2, n_dist_bins - 1)`` in
    normalized units (``searchsorted``, left side, as ``jnp.searchsorted``)
    and the relative offset clipped to [-32, 32].  The structure module
    refines from the noisy frames, ``position_scale = 1``.
    """

    def __init__(self, cfg: FrameDiffConfig = FrameDiffConfig(), device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        D, P, dt = cfg.node_dim, cfg.pair_dim, cfg.dtype
        self.t_in = Dense(D, D, dt, device)
        self.summ_in = Dense(2, D, dt, device)
        self.pos_in = Dense(1, D, dt, device)
        self.dist_embed = Embed(cfg.n_dist_bins, P, dt, device)
        self.relpos_embed = Embed(65, P, dt, device)
        self.structure = StructureModule(
            IPAConfig(node_dim=D, pair_dim=P, n_heads=cfg.n_heads, n_iter=cfg.n_iter,
                      position_scale=1.0, dtype=dt), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initializers, drawn from ``generator`` in module order."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, r_t, x_t, t, mask):
        cfg = self.cfg
        B, L = x_t.shape[:2]
        dev = x_t.device
        node = self.t_in(_timestep_embedding(t, cfg.node_dim))[:, None, :].expand(B, L, cfg.node_dim)
        summ = torch.stack([torch.linalg.vector_norm(x_t, dim=-1), rotation_angle(r_t)], dim=-1)
        node = node + self.summ_in(summ)
        pos = torch.linspace(-1.0, 1.0, L, device=dev)[None, :, None].expand(B, L, 1)
        node = node + self.pos_in(pos)

        d = torch.linalg.vector_norm(x_t[:, :, None, :] - x_t[:, None, :, :] + 1e-8, dim=-1)
        # edges in normalized units: 0-2 spans 0-20 A at trans_scale = 10
        edges = torch.linspace(0.0, 2.0, cfg.n_dist_bins - 1, device=dev)
        pair = self.dist_embed(torch.searchsorted(edges, d.contiguous()))
        ar = torch.arange(L, device=dev)
        off = torch.clamp(ar[None, :, None] - ar[None, None, :], -32, 32) + 32
        pair = pair + self.relpos_embed(off)
        out = self.structure(node, pair, mask, initial_frames=(r_t, x_t))
        return out["frames"]


def _dev(generator, like):
    return generator.device if generator is not None else like.device


def _corrupt_frames(r0, x0, t, cfg: FrameDiffConfig, eps: torch.Tensor, rot: IGSO3Draws):
    B, L = x0.shape[:2]
    dev = x0.device
    alpha_bar = torch.cumprod(1.0 - cfg.betas(dev), dim=0)
    ab = alpha_bar[t][:, None, None]
    x_t = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    sigma_t = cfg.sigmas(dev)[t][:, None].expand(B, L)
    return r0 @ _sample_igso3(sigma_t, (B, L), *rot), x_t


def corrupt_frames(r0, x0, t, cfg: FrameDiffConfig, generator: Optional[torch.Generator] = None):
    """Forward process q(frame_t | frame_0) at per-structure steps ``t (B,)``:
    the closed-form VP marginal on translations, rotations right-multiplied
    by an IGSO3 sample at sigma_t.  Returns ``(r_t, x_t)``."""
    B, L = x0.shape[:2]
    eps = torch.randn(x0.shape, generator=generator, device=_dev(generator, x0))
    return _corrupt_frames(r0, x0, t, cfg, eps, igso3_draws((B, L), generator, x0.device))


def _frame_losses(r_hat, x_hat, r0, x0, mask):
    """Masked translation MSE + squared geodesic angle of ``r_hat^T r0``."""
    w = mask.float()
    denom = torch.clamp_min(w.sum(), 1.0)
    trans = (w[..., None] * (x_hat - x0) ** 2).sum() / denom
    ang = rotation_angle(r_hat.transpose(-2, -1) @ r0)
    return trans + (w * ang ** 2).sum() / denom


def _framediff_loss(params, model: FrameDenoiser, r0, x0, mask, cfg: FrameDiffConfig,
                    t: torch.Tensor, eps: torch.Tensor, rot: IGSO3Draws) -> torch.Tensor:
    _check_params(params, model)
    r_t, x_t = _corrupt_frames(r0, x0, t, cfg, eps, rot)
    r_hat, x_hat = model(r_t, x_t, t.float() / cfg.T, mask)
    return _frame_losses(r_hat, x_hat, r0, x0, mask)


def framediff_loss(params, model: FrameDenoiser, r0, x0, mask, cfg: FrameDiffConfig,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x0-parameterized denoising loss: translation MSE + squared rotation
    geodesic, at per-structure steps drawn uniformly from [0, T).
    Coordinates in normalized units (angstroms / ``cfg.trans_scale``)."""
    B, L = x0.shape[:2]
    dev = _dev(generator, x0)
    t = torch.randint(0, cfg.T, (B,), generator=generator, device=dev)
    eps = torch.randn(x0.shape, generator=generator, device=dev)
    return _framediff_loss(params, model, r0, x0, mask, cfg, t, eps,
                           igso3_draws((B, L), generator, x0.device))


def _frameflow_loss(params, model: FrameDenoiser, r0, x0, mask, cfg: FrameDiffConfig,
                    t: torch.Tensor, x_noise: torch.Tensor, rot: IGSO3Draws) -> torch.Tensor:
    _check_params(params, model)
    B, L = x0.shape[:2]
    r_noise = _sample_igso3(torch.full((B, L), cfg.sigma_max, device=x0.device), (B, L), *rot)
    tb = t[:, None, None]
    x_t = (1.0 - tb) * x0 + tb * x_noise
    r_t = geodesic_interp(r0, r_noise, t[:, None])
    r_hat, x_hat = model(r_t, x_t, t, mask)
    return _frame_losses(r_hat, x_hat, r0, x0, mask)


def frameflow_loss(params, model: FrameDenoiser, r0, x0, mask, cfg: FrameDiffConfig,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flow matching on SE(3) (FrameFlow-style, x1-prediction): clean frames
    and pure noise joined by straight interpolants (linear in R^3, geodesic
    on SO(3)) at a uniform time; the same denoiser recovers the clean end."""
    B, L = x0.shape[:2]
    dev = _dev(generator, x0)
    t = torch.rand((B,), generator=generator, device=dev)
    x_noise = torch.randn(x0.shape, generator=generator, device=dev)
    return _frameflow_loss(params, model, r0, x0, mask, cfg, t, x_noise,
                           igso3_draws((B, L), generator, x0.device))


@torch.no_grad()
def _frameflow_sample(params, model: FrameDenoiser, cfg: FrameDiffConfig, x: torch.Tensor,
                      rot: IGSO3Draws, n_steps: int = 10):
    _check_params(params, model)
    B, L = x.shape[:2]
    r = _sample_igso3(torch.full((B, L), cfg.sigma_max, device=x.device), (B, L), *rot)
    mask = torch.ones((B, L), dtype=torch.bool, device=x.device)
    ts = torch.linspace(1.0, 0.0, n_steps + 1, dtype=torch.float32, device=x.device)
    for i in range(n_steps):
        t, t_next = ts[i], ts[i + 1]
        r_hat, x_hat = model(r, x, t.expand(B), mask)
        frac = torch.where(t > 1e-6, (t - t_next) / t, 1.0)
        x = x + frac * (x_hat - x)
        r = geodesic_interp(r, r_hat, frac)
    return r, x


def frameflow_sample(params, model: FrameDenoiser, shape: Tuple[int, int], cfg: FrameDiffConfig,
                     n_steps: int = 10, generator: Optional[torch.Generator] = None, device=None):
    """Euler ODE sampling of the frame flow in ``n_steps``: each step moves a
    fraction ``dt / t`` toward the predicted clean frames (linearly in R^3,
    geodesically on SO(3)).  Draws on ``generator``'s device (or ``device``,
    default the model's)."""
    dev = _sample_device(generator, device, model)
    x = torch.randn(tuple(shape) + (3,), generator=generator, device=dev)
    return _frameflow_sample(params, model, cfg, x, igso3_draws(tuple(shape), generator, dev),
                             n_steps)


def _sample_device(generator, device, model):
    if generator is not None:
        return generator.device
    return resolve_device(device) if device is not None else next(model.parameters()).device


@torch.no_grad()
def _framediff_sample(params, model: FrameDenoiser, cfg: FrameDiffConfig, x: torch.Tensor,
                      rot: IGSO3Draws, step_draws: Iterable[Tuple[torch.Tensor, IGSO3Draws]],
                      keep_trajectory: bool = False):
    _check_params(params, model)
    B, L = x.shape[:2]
    dev = x.device
    betas, sigmas = cfg.betas(dev), cfg.sigmas(dev)
    alpha_bar = torch.cumprod(1.0 - betas, dim=0)
    r = _sample_igso3(torch.full((B, L), cfg.sigma_max, device=dev), (B, L), *rot)
    mask = torch.ones((B, L), dtype=torch.bool, device=dev)
    traj_r, traj_x = [], []
    for t, (z, noise_draws) in zip(range(cfg.T - 1, -1, -1), step_draws):
        t_b = torch.full((B,), t, dtype=torch.float32, device=dev) / cfg.T
        r_hat, x_hat = model(r, x, t_b, mask)
        # translations: x0_hat -> the implied epsilon -> the DDPM posterior step
        ab_t = alpha_bar[t]
        eps_hat = (x - torch.sqrt(ab_t) * x_hat) / torch.sqrt(1.0 - ab_t)
        x = _ddpm_reverse_step(x, eps_hat, z, betas, t, clip_x0=4.0, alpha_bar=alpha_bar)
        # rotations: VE ancestral, a geodesic step toward r_hat sized by the
        # variance ratio, then IGSO3 noise at the posterior scale
        s_t = sigmas[t]
        s_prev = sigmas[t - 1] if t > 0 else torch.zeros_like(s_t)
        gamma = 1.0 - s_prev ** 2 / s_t ** 2
        r = geodesic_interp(r, r_hat, gamma)
        if t > 0:
            s_add = torch.sqrt(torch.clamp_min(s_prev ** 2 * gamma, 1e-12))
            r = r @ _sample_igso3(s_add.expand(B, L), (B, L), *noise_draws)
        if keep_trajectory:
            traj_r.append(r)
            traj_x.append(x)
    if keep_trajectory:
        return (r, x), (torch.stack(traj_r), torch.stack(traj_x))
    return r, x


def framediff_sample(params, model: FrameDenoiser, shape: Tuple[int, int], cfg: FrameDiffConfig,
                     keep_trajectory: bool = False, generator: Optional[torch.Generator] = None,
                     device=None):
    """Ancestral reverse sampling, noise frames -> backbone frames: the DDPM
    posterior on translations through the implied epsilon (``clip_x0 = 4``),
    a geodesic step toward the predicted rotation plus IGSO3 noise on
    rotations.  Returns ``(r (B, L, 3, 3), x (B, L, 3))`` in normalized
    units, or ``((r, x), (r_traj, x_traj))`` with ``keep_trajectory``.
    Draws on ``generator``'s device (or ``device``, default the model's)."""
    dev = _sample_device(generator, device, model)
    shape = tuple(shape)
    x = torch.randn(shape + (3,), generator=generator, device=dev)
    rot = igso3_draws(shape, generator, dev)

    def steps():
        for _ in range(cfg.T):
            z = torch.randn(shape + (3,), generator=generator, device=dev)
            yield z, igso3_draws(shape, generator, dev)

    return _framediff_sample(params, model, cfg, x, rot, steps(), keep_trajectory)
