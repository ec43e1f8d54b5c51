"""The port's ops/diffusion.py and StructureBatch.diffuse_xyz vs the JAX package.

A ``torch.Generator`` cannot reproduce ``jax.random``, so the parity tests
draw JAX's own noise the way the JAX function draws it
(``jax.random.normal(key, shape)``; ``jax.random.split(key, T)`` then one
normal per step for the trajectory; the ``k0``/``kloop`` split of
``ddpm_sample``) and feed it to the port's private cores (``_diffuse_step``,
``_diffusion_trajectory``, ``_ddpm_reverse_step``, ``_ddpm_sample``,
``_forward_marginal``, ``StructureBatch._diffused``), which the public
functions call with their own draw.  Results within 1e-5 absolute of the
jitted JAX functions (T <= 20 steps, B <= 4); the schedule within 1e-5.
The reverse step and sampler within 1e-5 max(1, max|ref|): at the last
step without ``clip_x0`` the implied x0 is divided by sqrt(abar_T) ~ 0.01
and the outputs reach |x| ~ 100, where one float32 ulp is 7.6e-6 (measured
5.3e-5 apart, 6.4e-7 relative).
The public functions' own noise is tested for its statistics, as
tests/test_reconstruct.py tests JAX's, and for reproducibility from a seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.ops import diffusion as jd
from protstruc_tpu_torch.ops import diffusion as td
from tests.conftest import pdb_path
from tests.test_torch_batch_api import port_of
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _scaled(ref):
    return ATOL * max(1.0, float(np.abs(np.asarray(ref)).max()))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("T", [20, 300])
def test_cosine_schedule_matches_jax(T):
    got = td.cosine_variance_schedule(T, device=DEVICE)
    assert got.dtype == torch.float32 and got.shape == (T,)
    assert_parity(jd.cosine_variance_schedule(T), got, ATOL, "betas")


@pytest.mark.parametrize("beta", [0.02, [0.01, 0.3, 0.05]])
def test_diffuse_step_matches_jax(beta):
    x = _x((3, 7, 15, 3), 0)
    key = jax.random.PRNGKey(4)
    ref = jax.jit(jd.diffuse_step)(x, key, jnp.asarray(beta, jnp.float32))
    eps = jax.random.normal(key, x.shape, dtype=jnp.float32)
    assert_parity(ref, td._diffuse_step(_t(x), _t(eps), torch.tensor(beta)), ATOL, "step")


@pytest.mark.parametrize("per_structure,keep", [(False, False), (True, True)])
def test_diffusion_trajectory_matches_jax(per_structure, keep):
    T, B = 12, 3
    x = _x((B, 9, 15, 3), 1)
    betas = np.asarray(jd.cosine_variance_schedule(T))
    if per_structure:
        betas = np.stack([betas, betas * 0.5, betas[::-1].copy()], axis=1)
    key = jax.random.PRNGKey(2)
    ref = jd.diffusion_trajectory(x, key, jnp.asarray(betas), keep_trajectory=keep)
    noise = [_t(jax.random.normal(k, x.shape, dtype=jnp.float32))
             for k in jax.random.split(key, T)]
    got = td._diffusion_trajectory(_t(x), noise, _t(betas), keep_trajectory=keep)
    if keep:
        assert_parity(ref[1], got[1], ATOL, "trajectory")
        ref, got = ref[0], got[0]
    assert_parity(ref, got, ATOL, "x_T")


@pytest.mark.parametrize("t,clip", [(0, None), (5, None), (15, 4.0), (15, None)])
def test_ddpm_reverse_step_matches_jax(t, clip):
    T = 16
    betas = jd.cosine_variance_schedule(T)
    x, eps_hat = _x((2, 10, 3), 2), _x((2, 10, 3), 3)
    key = jax.random.PRNGKey(9)
    fn = jax.jit(jd.ddpm_reverse_step, static_argnames=("clip_x0",))
    ref = fn(x, eps_hat, key, betas, jnp.int32(t), clip_x0=clip)
    z = jax.random.normal(key, x.shape, dtype=jnp.float32)
    got = td._ddpm_reverse_step(_t(x), _t(eps_hat), _t(z), _t(betas), t, clip_x0=clip)
    assert_parity(ref, got, _scaled(ref), "x_{t-1}")


def _denoisers(x0):
    """The same denoiser in both packages: a pull toward x0 that depends on t."""
    def jax_fn(x, t):
        return 0.3 * (x - x0) + 0.01 * t

    x0_t = _t(x0)

    def torch_fn(x, t):
        return 0.3 * (x - x0_t) + 0.01 * t

    return jax_fn, torch_fn


@pytest.mark.parametrize("keep,clip", [(False, None), (True, 4.0)])
def test_ddpm_sample_matches_jax(keep, clip):
    T, shape = 10, (2, 8, 3)
    betas = jd.cosine_variance_schedule(T)
    jax_fn, torch_fn = _denoisers(_x(shape, 4))
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda k: jd.ddpm_sample(jax_fn, k, shape, betas, keep_trajectory=keep,
                                           clip_x0=clip))(key)
    k0, kloop = jax.random.split(key)
    x_T = _t(jax.random.normal(k0, shape, dtype=jnp.float32))
    noise = [_t(jax.random.normal(k, shape, dtype=jnp.float32))
             for k in jax.random.split(kloop, T)]
    got = td._ddpm_sample(torch_fn, x_T, noise, _t(betas), keep_trajectory=keep, clip_x0=clip)
    if keep:
        assert_parity(ref[1], got[1], _scaled(ref[1]), "trajectory")
        ref, got = ref[0], got[0]
    assert_parity(ref, got, _scaled(ref), "x_0")


def test_forward_marginal_matches_jax():
    x = _x((4, 6, 15, 3), 5)
    betas = jd.cosine_variance_schedule(20)
    t = np.array([0, 7, 19, 12], np.int32)
    key = jax.random.PRNGKey(3)
    ref_x, ref_eps = jax.jit(jd.forward_marginal)(x, key, betas, t)
    eps = _t(jax.random.normal(key, x.shape, dtype=jnp.float32))
    got_x, got_eps = td._forward_marginal(_t(x), eps, _t(betas), torch.from_numpy(t))
    assert_parity(ref_eps, got_eps, 0.0, "eps")
    assert_parity(ref_x, got_x, ATOL, "x_t")


def test_batch_diffuse_xyz_matches_jax():
    jb = JaxBatch.from_pdb([pdb_path("1REX.pdb"), pdb_path("4EOT.pdb")])
    key = jax.random.PRNGKey(5)
    beta = np.array([0.02, 0.1], np.float32)
    ref = jb.diffuse_xyz(key, beta)
    eps = _t(jax.random.normal(key, jb.xyz.shape, dtype=jnp.float32))
    got = port_of(jb)._diffused(eps, torch.from_numpy(beta))
    assert_parity(ref.xyz, got.xyz, ATOL, "xyz")
    np.testing.assert_array_equal(np.asarray(ref.atom_mask), as_numpy(got.atom_mask))


# ---------------------------------------------------------------------------
# the public functions' own noise (torch.Generator)
# ---------------------------------------------------------------------------


def _gen(seed):
    return torch.Generator(device=DEVICE).manual_seed(seed)


def test_trajectory_statistics_and_reproducibility():
    """As tests/test_reconstruct.py holds JAX's: after the full schedule the
    signal is gone (mean ~0, std ~1); the trajectory's last state is the
    result; the same seed gives the same bits."""
    x = _t(_x((4, 20, 15, 3), 2))
    betas = td.cosine_variance_schedule(100, device=DEVICE)
    out = td.diffusion_trajectory(x, betas, generator=_gen(0))
    assert abs(float(out.std()) - 1.0) < 0.1 and abs(float(out.mean())) < 0.05
    final, traj = td.diffusion_trajectory(x, betas, generator=_gen(0), keep_trajectory=True)
    assert traj.shape == (100,) + x.shape
    assert torch.equal(traj[-1], final) and torch.equal(final, out)


def test_forward_marginal_statistics():
    x = _t(_x((8, 10, 15, 3), 3))
    betas = td.cosine_variance_schedule(50, device=DEVICE)
    t = torch.full((8,), 49, dtype=torch.int64)
    x_t, eps = td.forward_marginal(x, betas, t, generator=_gen(1))
    ab = torch.cumprod(1 - betas, 0)[-1]
    assert_parity(as_numpy(torch.sqrt(ab) * x + torch.sqrt(1 - ab) * eps), x_t, ATOL, "x_t")
    assert abs(float(eps.mean())) < 0.05 and abs(float(eps.std()) - 1.0) < 0.05


def test_ddpm_sample_with_oracle_denoiser():
    """With the exact-eps oracle the reverse chain walks back to x0."""
    x0 = _t(_x((4, 16, 3), 0))
    betas = td.cosine_variance_schedule(64, device=DEVICE)
    alpha_bar = torch.cumprod(1.0 - betas, 0)

    def oracle(x_t, t):
        ab = alpha_bar[t]
        return (x_t - torch.sqrt(ab) * x0) / torch.sqrt(1.0 - ab)

    out = td.ddpm_sample(oracle, tuple(x0.shape), betas, generator=_gen(1))
    corr = np.corrcoef(as_numpy(out).ravel(), as_numpy(x0).ravel())[0, 1]
    assert corr > 0.9, corr
    x_prev = td.ddpm_reverse_step(x0, torch.zeros_like(x0), betas, 0, generator=_gen(2))
    assert math.isfinite(float(x_prev.sum()))


def test_diffuse_xyz_statistics():
    sb = port_of(JaxBatch.from_pdb(pdb_path("1REX.pdb"))).standardize()
    a = sb.diffuse_xyz(torch.tensor([0.5]), generator=_gen(3))
    b = sb.diffuse_xyz(torch.tensor([0.5]), generator=_gen(3))
    assert torch.equal(torch.nan_to_num(a.xyz), torch.nan_to_num(b.xyz))  # same seed, same bits
    eps = (a.xyz - math.sqrt(0.5) * sb.xyz) / math.sqrt(0.5)
    ok = torch.isfinite(eps)
    assert abs(float(eps[ok].mean())) < 0.05 and abs(float(eps[ok].std()) - 1.0) < 0.05
