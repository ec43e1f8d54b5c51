"""ops/idealize.py, TrFold's predict_structure and DiffusionDenoiser: the port vs the JAX package.

Tolerances: ``ideality_loss`` and its gradient 1e-5 relative (CLAUDE.md);
``idealize_backbone`` at relax's (tests/test_torch_relax.py): one Adam step
within 1e-5 A, twenty within 1e-3 A, the final loss within 1e-4 relative;
missing residues stay NaN.  ``predict_structure``, on a random-init TrFold
(node 32, pair 16, one block) over a 32-residue window of 1REX: the
predicted 6D maps 1e-4; its idealize stage (150 Adam steps) run from
JAX's own MDS coordinates, and the whole after a proper Kabsch fit, within
2e-3 A of JAX's output, the whole's distance matrix within twice that.  Adam divides each
coordinate's step by its own gradient scale, so an entry whose gradient is
near 0 takes a +-lr step on the sign of rounding noise: from the same
coordinates the 150 steps end 1.2e-3 A apart here with one thread and
9.5e-6 A with the default thread count (the loss's reduction order alone).
MDS's orientation is arbitrary (eigenvector signs; its coordinates agree
within 2e-4 A after a fit, tests/test_torch_reconstruct.py), and that
per-axis step makes ``idealize_backbone`` not rotation-equivariant: from
MDS outputs a rotation apart the two ends are 1.7e-3 A apart after a fit.  DiffusionDenoiser: eps predictions 1e-4, the epsilon-MSE and its
gradient leaves 1e-4 and 1e-3 of their largest entry, the noise replayed
from ``forward_marginal``'s key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops import diffusion as jdiff
from protstruc_tpu.ops import idealize as jideal
from protstruc_tpu.ops import reconstruct as jrec
from protstruc_tpu_torch import geometry as tgeom
from protstruc_tpu_torch.convert import (diffusion_denoiser_params_from_flax,
                                         diffusion_denoiser_params_to_flax, trfold_params_from_flax,
                                         trfold_params_to_flax)
from protstruc_tpu_torch.models import trfold
from protstruc_tpu_torch.ops import diffusion as tdiff
from protstruc_tpu_torch.ops import idealize
from tests.conftest import pdb_path
from tests.test_torch_batch_api import port_of
from tests.test_torch_ipa import flat_shapes
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

L = 32


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def backbone():
    """A 32-residue N/CA/C/O window of 1REX with noise (an imperfect
    backbone), one residue NaN, and a chain index with a break."""
    xyz = np.asarray(JaxBatch.from_pdb(pdb_path("1REX.pdb")).xyz)[0, 10:10 + L, :4]
    bb = (xyz - np.nanmean(xyz[:, 1], 0)).astype(np.float32)
    bb = bb + np.random.RandomState(0).randn(*bb.shape).astype(np.float32) * 0.3
    bb[9] = np.nan
    chain = np.repeat([0, 1], [20, L - 20]).astype(np.int32)
    return bb, chain


@pytest.mark.parametrize("variant", ["plain", "mask+chain", "three-atom"])
def test_ideality_loss_and_gradient_match_jax(backbone, variant):
    bb, chain = backbone
    mask = ci = None
    if variant == "mask+chain":
        mask = np.ones(L, bool)
        mask[3] = False
        ci = chain
    x = bb[:, :3] if variant == "three-atom" else bb
    restraint = x + 0.1

    def jloss(c):
        return jideal.ideality_loss(c, None if mask is None else jnp.asarray(mask), jnp.asarray(restraint),
                                    0.1, chain_idx=None if ci is None else jnp.asarray(ci))

    ref, gref = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    got = idealize.ideality_loss(xt, None if mask is None else _t(mask), _t(restraint), 0.1,
                                 chain_idx=None if ci is None else _t(ci))
    got.backward()
    assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref))
    gref = np.asarray(gref)
    assert_parity(gref, xt.grad, 1e-5 * float(np.abs(gref).max()), "gradient")


@pytest.mark.parametrize("n_steps,atol", [(1, 1e-5), (20, 1e-3)])
def test_idealize_backbone_matches_jax(backbone, n_steps, atol):
    bb, chain = backbone
    ref, ref_loss = jideal.idealize_backbone(jnp.asarray(bb), n_steps=n_steps, chain_idx=jnp.asarray(chain))
    got, got_loss = idealize.idealize_backbone(_t(bb), n_steps=n_steps, chain_idx=_t(chain))
    assert_parity(np.asarray(ref), got, atol, "coords")  # the NaN residue stays NaN
    assert abs(float(got_loss) - float(ref_loss)) <= 1e-4 * abs(float(ref_loss))
    assert float(got_loss) < float(idealize.ideality_loss(_t(bb), None, _t(bb), chain_idx=_t(chain)))


# ---------------------------------------------------------------------------
# predict_structure
# ---------------------------------------------------------------------------

TRUNK = dict(node_dim=32, pair_dim=16, n_heads=2, n_blocks=1)


def _dm(x):
    return np.linalg.norm(x[:, None] - x[None], axis=-1)


class _Jitted:
    """A flax model whose ``apply`` is jitted (eager flax compiles every op
    anew): what ``predict_structure`` reads of its model."""

    def __init__(self, model):
        self.cfg, self.apply = model.cfg, jax.jit(model.apply)


def test_predict_structure_matches_jax():
    jb = JaxBatch.from_pdb(pdb_path("1REX.pdb"))
    sl = slice(10, 10 + L)
    jb = jb.replace(xyz=jb.xyz[:, sl], atom_mask=jb.atom_mask[:, sl], chain_idx=jb.chain_idx[:, sl],
                    residue_idx=jb.residue_idx[:, sl])
    jf = jtrfold.featurize_for_model(jb)
    feats = trfold.featurize_for_model(port_of(jb))
    port = trfold.TrFold(trfold.TrFoldConfig(**TRUNK), device=DEVICE)
    port.reset_parameters(torch.Generator().manual_seed(0))
    tree = trfold_params_to_flax(port.state_dict())
    jmodel = _Jitted(jtrfold.TrFold(jtrfold.TrFoldConfig(**TRUNK)))
    ref, ref_pred = jtrfold.predict_structure(jax.tree_util.tree_map(jnp.asarray, tree), jmodel, jf)
    loaded = trfold.TrFold(trfold.TrFoldConfig(**TRUNK), device=DEVICE)
    loaded.load_state_dict(trfold_params_from_flax(tree))
    got, pred = trfold.predict_structure(dict(loaded.named_parameters()), loaded, feats)
    for k, v in ref_pred.items():
        assert_parity(np.asarray(v), pred[k], 1e-4, k)
    # the idealize stage from JAX's own MDS coordinates: 150 Adam steps
    dist = jrec.reconstruct_backbone_distmat_from_interresidue_geometry(
        ref_pred["d_cb"][0], ref_pred["omega"][0], ref_pred["theta"][0], ref_pred["phi"][0],
        mask=jf["pair_mask"][0])
    mds = np.asarray(jrec.initialize_backbone_with_mds(dist, max_iter=200))
    refined, _ = idealize.idealize_backbone(_t(mds[:4]).transpose(0, 1), n_steps=150)
    ref = np.asarray(ref)
    assert_parity(ref[:4], refined.transpose(0, 1), 2e-3, "idealize stage")
    # end to end, after a proper Kabsch fit (see the module docstring)
    got = as_numpy(got)
    assert got.shape == ref.shape == (5, L, 3) and np.isfinite(got).all()
    a, b = got.reshape(-1, 3), ref.reshape(-1, 3)
    r, t = tgeom.kabsch(_t(a).double(), _t(b).double())
    assert float(torch.linalg.det(r)) > 0  # the same hand
    np.testing.assert_allclose(a @ r.numpy().T + t.numpy(), b, rtol=0, atol=2e-3)
    np.testing.assert_allclose(_dm(a), _dm(b), rtol=0, atol=4e-3)  # two points' error


# ---------------------------------------------------------------------------
# DiffusionDenoiser
# ---------------------------------------------------------------------------


def _t_embed(t):
    f = np.exp(np.linspace(0.0, 4.0, 4)).astype(np.float32)
    return np.concatenate([np.sin(t[:, None] * f), np.cos(t[:, None] * f)], -1).astype(np.float32)


@pytest.mark.parametrize("flash", [False, True])
def test_diffusion_denoiser_matches_jax(flash):
    jb = JaxBatch.from_pdb([pdb_path("1REX.pdb"), pdb_path("4EOT.pdb")]).standardize()
    ca = np.nan_to_num(np.asarray(jb.xyz)[:, :L, 1])
    seq = np.asarray(jb.get_seq_idx())[:, :L]
    mask = np.asarray(jb.residue_mask)[:, :L].copy()
    mask[1, -4:] = False
    cfg_kw = dict(node_dim=32, pair_dim=16, n_heads=2)
    jmodel = jtrfold.DiffusionDenoiser(jtrfold.TrFoldConfig(**cfg_kw))
    port = trfold.DiffusionDenoiser(trfold.TrFoldConfig(**cfg_kw, use_flash_attn=flash), device=DEVICE)
    port.reset_parameters(torch.Generator().manual_seed(1))
    tree = diffusion_denoiser_params_to_flax(port.state_dict())
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    te = _t_embed(np.array([0.3, 0.8], np.float32))
    shapes = flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), ca, te, seq, mask)["params"])
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == shapes
    betas = jdiff.cosine_variance_schedule(16)
    key, t = jax.random.PRNGKey(4), jnp.asarray([3, 12])

    def loss(p):
        x_t, eps = jdiff.forward_marginal(ca, key, betas, t)
        pred = jmodel.apply({"params": p}, x_t, te, seq, mask)
        return jnp.mean(jnp.where(mask[..., None], (pred - eps) ** 2, 0.0)), pred

    (ref, ref_pred), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port.load_state_dict(diffusion_denoiser_params_from_flax(tree))
    x_t, eps = tdiff._forward_marginal(_t(ca), _t(jax.random.normal(key, ca.shape)),
                                       tdiff.cosine_variance_schedule(16, device=DEVICE), _t(t))
    pred = port(x_t, _t(te), _t(seq), _t(mask))
    got = torch.where(_t(mask)[..., None], (pred - eps) ** 2, 0.0).mean()
    got.backward()
    assert_parity(np.asarray(ref_pred), pred, 1e-4, "eps_hat")
    assert abs(float(got.detach()) - float(ref)) <= 1e-4 * abs(float(ref))
    ref_g = diffusion_denoiser_params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    top = max(float(np.abs(as_numpy(r)).max()) for r in ref_g.values())
    for k, p in port.named_parameters():
        r, g = as_numpy(ref_g[k]), as_numpy(p.grad)
        zero = np.zeros(r.shape, bool)
        if k.endswith(("pair_bias.bias", "dist_in.bias")):
            zero[...] = True  # per-head constants on every logit of a row: exactly 0
        elif k.endswith("qkv.bias"):
            zero[1] = True
        assert float(np.abs(g[zero]).max(initial=0)) <= 1e-5 * top, k
        if not zero.all():
            assert float(np.abs(g - r)[~zero].max()) <= 1e-3 * float(np.abs(r[~zero]).max()), k
