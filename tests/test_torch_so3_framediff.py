"""ops/rigid.py (the rest), ops/so3.py and models/framediff.py: the port vs the JAX package.

A ``torch.Generator`` cannot replay ``jax.random``, so the parity tests draw
JAX's own randomness the way each JAX function draws it and hand it to the
port's private cores: ``sample_igso3`` splits its key into the inverse-CDF
uniforms and the axis normals; ``corrupt_frames`` splits into (rotations,
translations); ``framediff_loss`` into (steps, corruption);
``frameflow_loss`` into (time, translation noise, rotations); the samplers
into (x_T, r_T[, the loop's per-step (ddpm noise, rotation noise)]).

Tolerances: the rigid and SO(3) maps 1e-5 (CLAUDE.md); ``igso3_table``
bitwise (the same float64 numpy series); the denoiser's frames, the losses
and one sampling step 1e-4; each gradient leaf within 1e-3 of its largest
entry (the FoldModel precedent, PERF.md §2); the 4-step samplers 1e-4 A in
normalized units times max(1, max|ref|).  Tiny widths (node 32, pair 16, 2
heads, one IPA iteration, T = 4) on B=2, 16-residue fragments of 1REX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import framediff as jfd
from protstruc_tpu.models import ipa as jipa
from protstruc_tpu.ops import rigid as jrigid
from protstruc_tpu.ops import so3 as jso3
from protstruc_tpu_torch.convert import framediff_params_from_flax, framediff_params_to_flax
from protstruc_tpu_torch.models import framediff as fd
from protstruc_tpu_torch.ops import rigid, so3
from tests.conftest import pdb_path
from tests.test_torch_ipa import flat_shapes
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

ATOL = 1e-5
WIDTH = dict(node_dim=32, pair_dim=16, n_heads=2, n_iter=1, T=4)
B, L = 2, 16


def _t(x):
    return torch.from_numpy(np.array(x))


def _rots(seed, *lead):
    q = np.random.RandomState(seed).randn(*lead, 4).astype(np.float32)
    return np.asarray(jrigid.quat_to_rot(jnp.asarray(q)))


def _special_rots():
    """Identity, tiny, near-pi and exactly-pi rotations (each Shepperd branch)."""
    vs = np.array([[0, 0, 0], [1e-5, -2e-5, 3e-6], [np.pi - 1e-4, 0, 0], [0, np.pi, 0],
                   [0, 0, np.pi], [2.0, -1.0, 0.5], [-0.3, 0.2, -2.9]], np.float32)
    return np.asarray(jso3.rotvec_to_rot(jnp.asarray(vs))), vs


# ---------------------------------------------------------------------------
# rigid and SO(3) maps
# ---------------------------------------------------------------------------


def test_rot_to_quat_and_rotation_angle_match_jax():
    special, _ = _special_rots()
    r = np.concatenate([_rots(0, 40), special], 0)
    assert_parity(jax.jit(jrigid.rot_to_quat)(r), rigid.rot_to_quat(_t(r)), ATOL, "rot_to_quat")
    assert_parity(jax.jit(jrigid.rotation_angle)(r), rigid.rotation_angle(_t(r)), ATOL, "angle")
    # gradients stay finite at the arccos saturation points, as in JAX
    x = _t(special).requires_grad_()
    rigid.rotation_angle(x).sum().backward()
    assert bool(torch.isfinite(x.grad).all())


def test_random_rotations_are_seeded_rotations():
    g = torch.Generator(device=DEVICE).manual_seed(3)
    r = rigid.random_rotations((5, 7), generator=g)
    assert r.shape == (5, 7, 3, 3)
    eye = torch.eye(3).expand(5, 7, 3, 3)
    assert float((r @ r.transpose(-2, -1) - eye).abs().max()) < 1e-5
    assert float((torch.linalg.det(r) - 1).abs().max()) < 1e-5
    again = rigid.random_rotations((5, 7), generator=torch.Generator(device=DEVICE).manual_seed(3))
    assert torch.equal(r, again)


def test_rotvec_maps_match_jax():
    special, vs = _special_rots()
    v = np.concatenate([np.random.RandomState(1).randn(30, 3).astype(np.float32), vs], 0)
    assert_parity(jax.jit(jso3.rotvec_to_rot)(v), so3.rotvec_to_rot(_t(v)), ATOL, "rotvec_to_rot")
    r = np.concatenate([_rots(2, 30), special], 0)
    assert_parity(jax.jit(jso3.rot_to_rotvec)(r), so3.rot_to_rotvec(_t(r)), ATOL, "rot_to_rotvec")
    r1 = _rots(4, 30)
    alpha = np.random.RandomState(5).rand(30).astype(np.float32)
    assert_parity(jax.jit(jso3.geodesic_interp)(r[:30], r1, alpha),
                  so3.geodesic_interp(_t(r[:30]), _t(r1), _t(alpha)), ATOL, "geodesic_interp")


def test_igso3_table_is_the_jax_table():
    for a, b in zip(jso3.igso3_table(), so3.igso3_table()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _igso3_draws(key, shape):
    """sample_igso3's draws: ``ku, ka = split(key)``, uniforms then normals."""
    ku, ka = jax.random.split(key)
    n = int(np.prod(shape))
    return (_t(jax.random.uniform(ku, (n,))), _t(jax.random.normal(ka, tuple(shape) + (3,))))


_jax_sample_igso3 = jax.jit(jso3.sample_igso3, static_argnums=2)


@pytest.mark.parametrize("sigma", [0.003, 0.02, 0.4, 1.5, 5.0, "per-entry"])
def test_sample_igso3_matches_jax(sigma):
    shape = (3, 11)
    rng = np.random.RandomState(6)
    if sigma == "per-entry":
        sigma = np.exp(rng.uniform(-5, 1.5, shape)).astype(np.float32)
    else:  # one compile for every case: sigma as an array of the shape
        sigma = np.full(shape, sigma, np.float32)
    key = jax.random.PRNGKey(9)
    ref = _jax_sample_igso3(key, sigma, shape)
    got = so3._sample_igso3(_t(sigma), shape, *_igso3_draws(key, shape))
    assert_parity(ref, got, ATOL, "sample_igso3")


def test_igso3_score_norm_matches_jax():
    rng = np.random.RandomState(7)
    sigma = np.exp(rng.uniform(-5, 1.5, 64)).astype(np.float32)
    omega = rng.uniform(-0.1, np.pi + 0.1, 64).astype(np.float32)
    ref = jax.jit(jso3.igso3_score_norm)(sigma, omega)
    assert_parity(ref, so3.igso3_score_norm(_t(sigma), _t(omega)), 1e-5 * float(np.abs(ref).max()),
                  "score_norm")


def test_sample_igso3_public_draws_on_the_generator():
    g = torch.Generator(device=DEVICE).manual_seed(0)
    r = so3.sample_igso3(0.5, (4, 6), generator=g)
    assert r.shape == (4, 6, 3, 3) and r.device.type == DEVICE
    r2 = so3.sample_igso3(0.5, (4, 6), generator=torch.Generator(device=DEVICE).manual_seed(0))
    assert torch.equal(r, r2)


DEFAULT_CALLS = {
    "random_rotations": lambda **kw: rigid.random_rotations((2,), **kw),
    "igso3_draws": lambda **kw: so3.igso3_draws((2,), **kw)[1],
    "sample_igso3": lambda **kw: so3.sample_igso3(0.5, (2,), **kw),
    "igso3_score_norm": lambda **kw: so3.igso3_score_norm(0.5, 1.0, **kw),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_CALLS))
def test_draws_without_a_generator_default_to_the_card(name, monkeypatch):
    """With neither a generator nor a device these land on the card, and
    raise without one as an explicit ``cuda`` does; ``device="cpu"`` asks for
    the CPU."""
    assert DEFAULT_CALLS[name](device=DEVICE).device.type == DEVICE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"device 'cuda.*' requested but torch.cuda.is_available"):
        DEFAULT_CALLS[name]()


# ---------------------------------------------------------------------------
# FrameDiff
# ---------------------------------------------------------------------------


def test_schedules_and_timestep_embedding_match_jax():
    jcfg, tcfg = jfd.FrameDiffConfig(**WIDTH), fd.FrameDiffConfig(**WIDTH)
    assert_parity(jcfg.sigmas(), tcfg.sigmas(DEVICE), ATOL, "sigmas")
    assert_parity(jcfg.betas(), tcfg.betas(DEVICE), ATOL, "betas")
    t = np.linspace(0, 1, 7).astype(np.float32)
    assert_parity(jax.jit(jfd._timestep_embedding, static_argnums=1)(t, 32),
                  fd._timestep_embedding(_t(t), 32), 1e-4, "t_emb")


@pytest.fixture(scope="module")
def frames():
    """B=2 16-residue fragments of 1REX: normalized frames, as numpy."""
    xyz = np.asarray(JaxBatch.from_pdb(pdb_path("1REX.pdb")).xyz)[0, :, :4]
    frags = np.stack([xyz[10:10 + L], xyz[40:40 + L]])
    ca = frags[:, :, 1]
    center = ca.mean(1, keepdims=True)
    r0, _ = jipa.frames_from_backbone(jnp.asarray(frags - center[:, :, None]))
    x0 = (ca - center) / 10.0
    mask = np.ones((B, L), bool)
    mask[1, -3:] = False
    return np.asarray(r0), x0.astype(np.float32), mask


@pytest.fixture(scope="module")
def models(frames):
    """The JAX and port denoisers on the same weights: the port's init with
    the backbone update and point weights set to small random values (zero at
    init, which would leave the frames unchanged)."""
    r0, x0, mask = frames
    jmodel = jfd.FrameDenoiser(jfd.FrameDiffConfig(**WIDTH))
    port = fd.FrameDenoiser(fd.FrameDiffConfig(**WIDTH), device=DEVICE)
    port.reset_parameters(torch.Generator().manual_seed(0))
    tree = framediff_params_to_flax(port.state_dict())
    rng = np.random.RandomState(3)
    st = tree["structure"]
    st["backbone_update"] = {k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
                             for k, v in st["backbone_update"]["update"].items()}
    st["backbone_update"] = {"update": st["backbone_update"]}
    st["ipa"]["point_weight"] = rng.randn(*st["ipa"]["point_weight"].shape).astype(np.float32)
    port.load_state_dict(framediff_params_from_flax(tree))
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    shapes = flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), r0, x0,
                                        np.zeros(B, np.float32), mask)["params"])
    return jmodel, params, port, shapes


def test_param_tree_matches_flax(models):
    _, params, port, shapes = models
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == shapes
    back = framediff_params_to_flax(framediff_params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))


def test_frame_denoiser_matches_jax(models, frames):
    jmodel, params, port, _ = models
    r0, x0, mask = frames
    # noisy inputs: rotations composed with random ones, distances over the bin edges
    r_t = np.einsum("blij,bljk->blik", r0, _rots(8, B, L)).astype(np.float32)
    x_t = (x0 + np.random.RandomState(9).randn(B, L, 3) * 0.5).astype(np.float32)
    t = np.array([0.25, 0.9], np.float32)
    ref = jax.jit(jmodel.apply)({"params": params}, r_t, x_t, t, mask)
    with torch.no_grad():
        got = port(_t(r_t), _t(x_t), _t(t), _t(mask))
    for name, a, b in zip(("r", "x"), ref, got):
        assert_parity(np.asarray(a), b, 1e-4, name)


def test_corrupt_frames_matches_jax(frames):
    r0, x0, _ = frames
    cfg_j, cfg_t = jfd.FrameDiffConfig(**WIDTH), fd.FrameDiffConfig(**WIDTH)
    key, t = jax.random.PRNGKey(2), np.array([0, 3], np.int32)
    ref = jax.jit(lambda k: jfd.corrupt_frames(k, r0, x0, jnp.asarray(t), cfg_j))(key)
    kr, kx = jax.random.split(key)
    eps = _t(jax.random.normal(kx, x0.shape))
    got = fd._corrupt_frames(_t(r0), _t(x0), _t(t).long(), cfg_t, eps, _igso3_draws(kr, (B, L)))
    for name, a, b in zip(("r_t", "x_t"), ref, got):
        assert_parity(np.asarray(a), b, ATOL, name)


def _zero_grad_entries(key, shape):
    """Entries whose exact gradient is 0: the IPA's pair-bias bias and
    ``k_scalar`` bias (per-head constants on every logit of a softmax row)."""
    return np.full(shape, key.endswith(("ipa.pair_bias.bias", "ipa.k_scalar.bias")))


def _assert_grads(ref_tree, model, rel=1e-3):
    ref = framediff_params_from_flax(jax.tree_util.tree_map(np.asarray, ref_tree))
    top = max(float(np.abs(as_numpy(r)).max()) for r in ref.values())
    for k, p in model.named_parameters():
        r = as_numpy(ref[k])
        g = as_numpy(p.grad) if p.grad is not None else np.zeros_like(r)
        zero = _zero_grad_entries(k, r.shape)
        assert max(np.abs(g[zero]).max(initial=0), np.abs(r[zero]).max(initial=0)) <= 1e-5 * top, k
        if not zero.all():
            scale = float(np.abs(r[~zero]).max())
            assert float(np.abs(g - r)[~zero].max(initial=0)) <= rel * max(scale, 1e-30), k


@pytest.mark.parametrize("objective", ["diffusion", "flow"])
def test_losses_and_gradients_match_jax(models, frames, objective):
    jmodel, params, port, _ = models
    r0, x0, mask = frames
    cfg_j, cfg_t = jfd.FrameDiffConfig(**WIDTH), fd.FrameDiffConfig(**WIDTH)
    key = jax.random.PRNGKey(11)
    jfn = jfd.framediff_loss if objective == "diffusion" else jfd.frameflow_loss
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jfn(p, jmodel, key, r0, x0, mask, cfg_j)))(params)
    tparams = dict(port.named_parameters())
    args = (tparams, port, _t(r0), _t(x0), _t(mask), cfg_t)
    if objective == "diffusion":
        kt, kc = jax.random.split(key)
        t = _t(jax.random.randint(kt, (B,), 0, cfg_j.T)).long()
        kr, kx = jax.random.split(kc)
        got = fd._framediff_loss(*args, t, _t(jax.random.normal(kx, x0.shape)),
                                 _igso3_draws(kr, (B, L)))
    else:
        kt, kx, kr = jax.random.split(key, 3)
        got = fd._frameflow_loss(*args, _t(jax.random.uniform(kt, (B,))),
                                 _t(jax.random.normal(kx, x0.shape)), _igso3_draws(kr, (B, L)))
    port.zero_grad(set_to_none=True)
    got.backward()
    assert abs(float(got) - float(loss)) <= 1e-4 * max(1.0, abs(float(loss))), (float(got), float(loss))
    _assert_grads(grads, port)
    port.zero_grad(set_to_none=True)


def test_framediff_sample_matches_jax(models):
    jmodel, params, port, _ = models
    cfg_j, cfg_t = jfd.FrameDiffConfig(**WIDTH), fd.FrameDiffConfig(**WIDTH)
    key = jax.random.PRNGKey(5)
    (r, x), traj = jax.jit(lambda k: jfd.framediff_sample(
        params, jmodel, k, (B, L), cfg_j, keep_trajectory=True))(key)
    k0, k1, kloop = jax.random.split(key, 3)
    steps = []
    for k in jax.random.split(kloop, cfg_j.T):
        kx, kr = jax.random.split(k)
        steps.append((_t(jax.random.normal(kx, (B, L, 3))), _igso3_draws(kr, (B, L))))
    (tr, tx), (traj_r, traj_x) = fd._framediff_sample(
        dict(port.named_parameters()), port, cfg_t, _t(jax.random.normal(k0, (B, L, 3))),
        _igso3_draws(k1, (B, L)), steps, keep_trajectory=True)
    # one reverse step at 1e-4, the whole chain at 1e-4 times max(1, max|ref|)
    assert_parity(np.asarray(traj[0])[0], traj_r[0], 1e-4, "step 1 r")
    assert_parity(np.asarray(traj[1])[0], traj_x[0], 1e-4, "step 1 x")
    assert_parity(np.asarray(r), tr, 1e-4, "r")
    assert_parity(np.asarray(x), tx, 1e-4 * max(1.0, float(np.abs(np.asarray(x)).max())), "x")


def test_frameflow_sample_matches_jax(models):
    jmodel, params, port, _ = models
    cfg_j, cfg_t = jfd.FrameDiffConfig(**WIDTH), fd.FrameDiffConfig(**WIDTH)
    key = jax.random.PRNGKey(6)
    r, x = jax.jit(lambda k: jfd.frameflow_sample(params, jmodel, k, (B, L), cfg_j, n_steps=4))(key)
    k0, k1 = jax.random.split(key)
    tr, tx = fd._frameflow_sample(dict(port.named_parameters()), port, cfg_t,
                                  _t(jax.random.normal(k0, (B, L, 3))), _igso3_draws(k1, (B, L)),
                                  n_steps=4)
    assert_parity(np.asarray(r), tr, 1e-4, "r")
    assert_parity(np.asarray(x), tx, 1e-4 * max(1.0, float(np.abs(np.asarray(x)).max())), "x")


def test_public_samplers_and_losses_run_from_a_generator(models, frames):
    _, _, port, _ = models
    r0, x0, mask = frames
    cfg = fd.FrameDiffConfig(**WIDTH)
    params = dict(port.named_parameters())
    outs = []
    for _ in range(2):
        g = torch.Generator(device=DEVICE).manual_seed(1)
        loss = fd.framediff_loss(params, port, _t(r0), _t(x0), _t(mask), cfg, generator=g)
        flow = fd.frameflow_loss(params, port, _t(r0), _t(x0), _t(mask), cfg, generator=g)
        r, x = fd.framediff_sample(params, port, (1, 8), cfg, generator=g)
        r2, x2 = fd.frameflow_sample(params, port, (1, 8), cfg, n_steps=2, generator=g)
        outs.append([loss.detach(), flow.detach(), r, x, r2, x2])
    for a, b in zip(*outs):
        assert bool(torch.isfinite(a).all()) and torch.equal(a, b)
    port.zero_grad(set_to_none=True)
