"""ops/chi.py, ops/graft.py, pack_sidechains and the chi features: the port vs the JAX package.

``pack_sidechains`` draws one ``normal(k, (K, B, L, 4))`` block per
``split(key, n_sweeps)`` key; the tests replay those draws into the port's
core ``_pack_sidechains``.  Tolerances: the chi tables and masks bitwise;
chi angles, rotated and grafted coordinates 1e-5 (CLAUDE.md; coordinates of
centred windows, |x| < 32 A); the packer's energy trajectory 1e-4 relative
and its coordinates 1e-4 A (the same proposals accepted: each sweep's
argmin is held only where the best two energies are further apart than
that tolerance, which the test checks); ``featurize_for_model(include_chi
=True)`` 1e-5 and TrFold's logits on it 1e-4.  Windows of 24 residues of
1REX and 4EOT, with missing atoms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops import chi as jchi
from protstruc_tpu.ops import graft as jgraft
from protstruc_tpu.ops import pack as jpack
from protstruc_tpu_torch.convert import trfold_params_from_flax, trfold_params_to_flax
from protstruc_tpu_torch.models import trfold
from protstruc_tpu_torch.ops import chi, graft, pack
from tests.conftest import pdb_path
from tests.test_torch_batch_api import port_of
from tests.test_torch_ipa import flat_shapes
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

ATOL = 1e-5
L = 24


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def batches():
    """B=2 centred windows; one atom of the first structure's fifth residue
    removed (NaN, mask False) so a chi and a moved set meet a missing atom."""
    jb = JaxBatch.from_pdb([pdb_path("1REX.pdb"), pdb_path("4EOT.pdb")])
    sl = slice(20, 20 + L)
    xyz = np.array(jb.xyz[:, sl])
    xyz -= np.nanmean(xyz[:, :, 1], axis=1)[:, None, None]
    am = np.array(jb.atom_mask[:, sl])
    xyz[0, 4, 6] = np.nan
    am[0, 4, 6] = False
    jb = jb.replace(xyz=jnp.asarray(xyz), atom_mask=jnp.asarray(am), chain_idx=jb.chain_idx[:, sl],
                    residue_idx=jb.residue_idx[:, sl])
    return jb, port_of(jb)


def test_chi_tables_are_the_jax_tables():
    for a, b in zip(jchi.chi_tables(), chi.chi_tables()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jchi.chi_symmetry_mask(), chi.chi_symmetry_mask())


def test_chi_angles_match_jax(batches):
    jb, tb = batches
    ref, ref_m = jb.chi_angles()
    got, got_m = tb.chi_angles()
    assert_parity(np.asarray(ref_m), got_m, 0, "chi_mask")
    assert_parity(np.asarray(ref), got, ATOL, "chi")
    assert int(got_m.sum()) > 20 and not bool(got_m.all())


def test_rotate_chi_matches_jax(batches):
    jb, tb = batches
    delta = np.random.RandomState(0).uniform(-np.pi, np.pi, (2, L, 4)).astype(np.float32)
    ref = jax.jit(jchi.rotate_chi)(jb.xyz, jb.get_seq_idx(), jnp.asarray(delta), jb.atom_mask)
    got = tb.rotate_chi(_t(delta)).xyz
    assert_parity(np.asarray(ref), got, ATOL, "rotated xyz")
    # the rotation reaches the chis: chi + delta (mod 2 pi) where defined
    new, m = chi.chi_angles(got, tb.get_seq_idx(), tb.atom_mask)
    old, _ = tb.chi_angles()
    wrapped = torch.remainder(new - old - _t(delta) + np.pi, 2 * np.pi) - np.pi
    assert float(wrapped[m].abs().max()) < 1e-3


def test_rotate_chi_gradients_are_finite(batches):
    _, tb = batches
    delta = _t(np.random.RandomState(1).randn(2, L, 4).astype(np.float32)).requires_grad_()
    out = chi.rotate_chi(tb.xyz, tb.get_seq_idx(), delta, tb.atom_mask)
    torch.nan_to_num(out, nan=0.0).sum().backward()
    assert bool(torch.isfinite(delta.grad).all())


@pytest.fixture(scope="module")
def library():
    lib_batch = JaxBatch.from_pdb(pdb_path("4EOT.pdb"))
    return jgraft.sidechain_library(lib_batch), graft.sidechain_library(port_of(lib_batch))


def test_sidechain_library_matches_jax(library):
    (ref, ref_m), (got, got_m) = library
    np.testing.assert_array_equal(ref_m, got_m)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert got_m[:20].any(-1).sum() >= 15  # most residue types have a template


@pytest.mark.parametrize("n_given", [3, 5])
def test_build_sidechains_matches_jax(batches, library, n_given):
    jb, tb = batches
    bb = np.array(jb.xyz[:, :, :n_given])
    bb[1, 7, 0] = np.nan   # an incomplete frame: its placed atoms drop out
    seq = np.random.RandomState(2).randint(0, 21, (2, L)).astype(np.int32)
    rmask = np.array(jb.residue_mask)
    rmask[0, -2:] = False
    ref = jgraft.build_sidechains(jnp.asarray(bb), jnp.asarray(seq), library[0], jnp.asarray(rmask))
    got = graft.build_sidechains(_t(bb), _t(seq), library[1], _t(rmask))
    assert_parity(np.asarray(ref[1]), got[1], 0, "atom_mask")
    assert_parity(np.asarray(ref[0]), got[0], ATOL, "xyz")


def test_pack_sidechains_matches_jax(batches):
    """From clashing sidechains: the native chis turned by random angles."""
    jb, tb = batches
    n_sweeps, K = 4, 3
    key = jax.random.PRNGKey(3)
    seq = jb.get_seq_idx()
    delta = np.random.RandomState(4).uniform(-np.pi, np.pi, (2, L, 4)).astype(np.float32)
    start = np.asarray(jax.jit(jchi.rotate_chi)(jb.xyz, seq, jnp.asarray(delta), jb.atom_mask))
    ref_x, ref_e = jax.jit(lambda x, k: jpack.pack_sidechains(
        x, seq, jb.atom_mask, k, n_sweeps=n_sweeps, n_proposals=K))(jnp.asarray(start), key)
    noise = torch.stack([_t(jax.random.normal(k, (K, 2, L, 4)))
                         for k in jax.random.split(key, n_sweeps)])
    got_x, got_e = pack._pack_sidechains(_t(start), tb.get_seq_idx(), tb.atom_mask, noise)
    ref_e = np.asarray(ref_e)
    assert_parity(ref_e, got_e, 1e-4 * float(np.abs(ref_e).max()), "energies")
    assert (np.diff(ref_e, axis=0) <= 0).all() and (ref_e[-1] < ref_e[0]).all()  # descent
    assert_parity(np.asarray(ref_x), got_x, 1e-4, "packed xyz")
    # each sweep's choice was decided: replay the proposals and check the
    # best two of {current, candidates} are further apart than the tolerance
    # (or both exactly 0, where both packages keep the first)
    x = _t(start)
    seq_t = tb.get_seq_idx()
    sigmas = np.exp(np.linspace(np.log(1.5), np.log(0.1), n_sweeps)).astype(np.float32)
    not_pro = (seq_t != 12)[None, :, :, None]
    for s in range(n_sweeps):
        cands = chi.rotate_chi(x.repeat(K, 1, 1, 1), seq_t.repeat(K, 1),
                               (noise[s] * float(sigmas[s]) * not_pro).reshape(K * 2, L, 4),
                               tb.atom_mask.repeat(K, 1, 1))
        es = pack.clash_energy(cands, tb.atom_mask.repeat(K, 1, 1), seq_t.repeat(K, 1)).reshape(K, 2)
        all_e = torch.cat([_t(ref_e[s])[None], es])
        top2 = -torch.topk(-all_e, 2, dim=0).values
        decided = ((top2[1] - top2[0]) > 1e-4 * float(np.abs(ref_e).max())) | (top2[1] == 0)
        assert bool(decided.all()), (s, top2)
        best = torch.argmin(all_e, 0)
        all_x = torch.cat([x[None], cands.reshape(K, 2, L, 15, 3)])
        x = all_x[best, torch.arange(2)]


def test_pack_public_and_batch_method_draw_on_the_generator(batches):
    _, tb = batches
    g = torch.Generator(device=DEVICE).manual_seed(5)
    x1, e1 = pack.pack_sidechains(tb.xyz, tb.get_seq_idx(), tb.atom_mask, n_sweeps=2, n_proposals=2,
                                  generator=g)
    packed = tb.pack_sidechains(torch.Generator(device=DEVICE).manual_seed(5), n_sweeps=2,
                                n_proposals=2)
    assert torch.equal(packed.xyz.nan_to_num(), x1.nan_to_num())
    assert e1.shape == (3, 2) and bool((e1[1:] <= e1[:-1]).all())
    np.testing.assert_array_equal(torch.isnan(x1).numpy(), torch.isnan(tb.xyz).numpy())


# ---------------------------------------------------------------------------
# chi features through TrFold
# ---------------------------------------------------------------------------

TRUNK = dict(node_dim=32, pair_dim=16, n_heads=2, n_blocks=1)


def test_featurize_for_model_with_chi_matches_jax(batches):
    jb, tb = batches
    ref = jtrfold.featurize_for_model(jb, include_chi=True)
    got = trfold.featurize_for_model(tb, include_chi=True)
    assert set(ref) == set(got)
    for k in ("chi", "chi_mask", "torsions", "torsion_mask"):
        assert_parity(np.asarray(ref[k]), got[k], ATOL, k)


def test_trfold_with_chi_matches_jax(batches):
    jb, tb = batches
    jf = jtrfold.featurize_for_model(jb, include_chi=True)
    feats = trfold.featurize_for_model(tb, include_chi=True)
    jmodel = jtrfold.TrFold(jtrfold.TrFoldConfig(**TRUNK))
    with pytest.raises(ValueError, match="chi=True"):  # one way to build chi_embed
        trfold.make_train_state(trfold.TrFold(trfold.TrFoldConfig(**TRUNK), device=DEVICE), feats,
                                torch.Generator().manual_seed(0), device=DEVICE)
    port = trfold.TrFold(trfold.TrFoldConfig(**TRUNK), device=DEVICE, chi=True)
    trfold.make_train_state(port, feats, torch.Generator().manual_seed(0), device=DEVICE)
    shapes = flat_shapes(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jf)["params"])
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == shapes
    tree = trfold_params_to_flax(port.state_dict())
    ref = jax.jit(lambda p, f: jmodel.apply({"params": p}, f))(
        jax.tree_util.tree_map(jnp.asarray, tree), jf)
    loaded = trfold.TrFold(trfold.TrFoldConfig(**TRUNK), device=DEVICE, chi=True)
    loaded.load_state_dict(trfold_params_from_flax(tree))
    with torch.no_grad():
        out = loaded(feats)
    for k in ("distogram_logits", "torsion_sincos"):
        assert_parity(np.asarray(ref[k]), out[k], 1e-4, k)
    with pytest.raises(ValueError, match="chi=True"):
        trfold.TrFold(trfold.TrFoldConfig(**TRUNK), device=DEVICE)(feats)
    assert as_numpy(out["distogram_logits"]).shape == (2, L, L, 36)
