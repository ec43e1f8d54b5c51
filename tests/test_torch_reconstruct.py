"""The port's NeRF folding and trRosetta decode vs the JAX package on the CPU.

Tolerances, each measured here on float32 (the JAX functions jitted):

* NeRF (``ops/nerf.py``): each extension step from the JAX chain's own
  residue i (teacher forcing) within 1e-5 of the JAX chain's residue i+1,
  and the ideal carbonyl O likewise, at L = 64.  The free-running chain
  compounds rounding: XLA's float32 sin/cos differ from PyTorch's in 1-5% of
  arguments (neither is correctly rounded), and at L = 64 the JAX chain is
  1.3e-4 A from a float64 chain, the port's 1.6e-4, the two 2.4e-4 apart.
  So the chain is held within 1e-3 of JAX's, and no further from the float64
  chain than JAX's is (times 2, plus 1e-5).
* ``ideal_local_frame`` within 1e-6; Floyd-Warshall min-plus bitwise (it
  only adds and takes minima); ``reconstruct_backbone_distmat_...`` from
  the same maps within 1e-5, both chain-break forms.
* MDS: ``eigh``'s eigenvector signs are arbitrary, so ``classical_mds`` is
  held column by column up to sign (measured 1.9e-5 at n = 120, gate 1e-4)
  and by its distance matrix (2.5e-5, gate 1e-4); ``smacof_refine`` from
  the same start (200 iterations) within 1e-4 (2.3e-5);
  ``initialize_backbone_with_mds`` after a proper Kabsch fit of the port's
  (5, L, 3) onto JAX's within 2e-4 (4.3e-5) and by distance matrix
  (6.1e-5, gate 2e-4), on a 40-residue fragment (n = 3L = 120).
* ``fix_chirality``: the same decision (bitwise output) on the same
  backbones, native and mirrored, for every bundled PDB.
* The quality gate of tests/test_reconstruct.py on 1REX, through the
  port alone: native -> ``inter_residue_geometry(use_kernel=True)`` (K1's
  plain version on the CPU) -> distmat -> MDS; the CA distance-matrix RMS
  against the native below 1.5 A.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu import geometry as jgeom
from protstruc_tpu.ops import nerf as jnerf
from protstruc_tpu.ops import reconstruct as jrec
from protstruc_tpu_torch import StructureBatch
from protstruc_tpu_torch import geometry as tgeom
from protstruc_tpu_torch.ops import nerf as tnerf
from protstruc_tpu_torch.ops import reconstruct as trec
from tests.conftest import pdb_path
from tests.test_torch_batch_api import port_of
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

BUNDLED = ("1REX.pdb", "15c8_HL.pdb", "1ad0_DC.pdb", "4EOT.pdb", "6dc4.pdb", "1a3r_HL.pdb",
           "5cjx_HL.pdb", "8dtk.pdb")


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# NeRF
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chain():
    rng = np.random.RandomState(0)
    tor = rng.uniform(-3.1, 3.1, (2, 64, 3)).astype(np.float32)
    return tor, np.asarray(jax.jit(jnerf.backbone_from_dihedrals)(tor))


def test_nerf_steps_match_jax(chain):
    tor, ref = chain
    n, ca, c = (_t(ref[:, :, k]) for k in range(3))
    t = _t(tor)
    for i in range(tor.shape[1] - 1):
        (n1, ca1, c1), _ = tnerf.extend_backbone_step(
            (n[:, i], ca[:, i], c[:, i]), (t[:, i, 1:2], t[:, i, 2:3], t[:, i + 1, 0:1]))
        for k, got in enumerate((n1, ca1, c1)):
            assert_parity(ref[:, i + 1, k], got, 1e-5, f"residue {i + 1} atom {k}")
    assert_parity(ref[:, :, 3], tgeom.ideal_carbonyl_oxygen(n, ca, c), 1e-5, "O")


def _chain64(tor):
    """The port's NeRF chain in float64 (the rounding-free reference)."""
    return tnerf.backbone_from_dihedrals(_t(tor).double())[:, :, :3].numpy()


def test_nerf_chain_matches_jax(chain):
    tor, ref = chain
    got = as_numpy(tnerf.backbone_from_dihedrals(_t(tor)))
    assert got.shape == (2, 64, 4, 3) and got.dtype == np.float32
    assert_parity(ref, got, 1e-3, "chain")
    exact = _chain64(tor)
    err_ref = np.abs(ref[:, :, :3] - exact).max()
    assert np.abs(got[:, :, :3] - exact).max() <= 2 * err_ref + 1e-5


def test_from_dihedrals_round_trip():
    """Torsions -> backbone -> torsions is the identity (up to float32), as
    tests/test_reconstruct.py holds the JAX package's; bond lengths ideal."""
    rng = np.random.RandomState(0)
    tor = np.zeros((2, 24, 3), np.float32)
    tor[:, :, 0] = rng.uniform(-2.8, -0.7, (2, 24))
    tor[:, :, 1] = rng.uniform(-1.0, 2.8, (2, 24))
    tor[:, :, 2] = np.pi - 0.05
    sb = StructureBatch.from_dihedrals(tor, device=DEVICE)
    back = as_numpy(sb.backbone_dihedrals()[0])
    np.testing.assert_allclose(back[:, 1:, 0], tor[:, 1:, 0], atol=1e-3)
    np.testing.assert_allclose(back[:, :-1, 1:], tor[:, :-1, 1:], atol=1e-3)
    xyz = as_numpy(sb.xyz)[0]
    np.testing.assert_allclose(np.linalg.norm(xyz[:, 1] - xyz[:, 0], axis=-1), 1.458, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(xyz[1:, 0] - xyz[:-1, 2], axis=-1), 1.329,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# trRosetta decode
# ---------------------------------------------------------------------------


def test_ideal_local_frame_matches_jax():
    assert_parity(jgeom.ideal_local_frame(), tgeom.ideal_local_frame(DEVICE), 1e-6, "frame")


@pytest.mark.parametrize("seed", [0, 1])
def test_floyd_warshall_bitwise(seed):
    rng = np.random.RandomState(seed)
    d = (rng.rand(60, 60) * 20).astype(np.float32)
    d[rng.rand(60, 60) < 0.6] = jrec.MASK_DIST
    np.fill_diagonal(d, 0.0)
    ref = np.asarray(jax.jit(jrec._floyd_warshall_minplus)(d))
    got = as_numpy(trec._floyd_warshall_minplus(_t(d)))
    np.testing.assert_array_equal(ref, got)


@pytest.fixture(scope="module")
def fragment():
    """40 residues of 1ad0_DC, its maps (JAX's jnp path) and JAX's distmat."""
    jb = JaxBatch.from_pdb(pdb_path("1ad0_DC.pdb"))
    jb = jb.residue_masked_select(np.arange(jb.n_residues)[None] < 40)
    g = {k: np.asarray(v[0]) for k, v in jb.inter_residue_geometry().items()}
    dist = np.asarray(jrec.reconstruct_backbone_distmat_from_interresidue_geometry(
        g["d_cb"], g["omega"], g["theta"], g["phi"], mask=g["d_cb_mask"]))
    return jb, g, dist


def _maps(g):
    return [_t(g[k]) for k in ("d_cb", "omega", "theta", "phi")]


@pytest.mark.parametrize("breaks", [None, "list", "mask"])
def test_distmat_matches_jax(fragment, breaks):
    jb, g, dist = fragment
    kw = {}
    if breaks is not None:
        cbm = np.zeros(39, bool)
        cbm[[9, 25]] = True
        kw = ({"chain_breaks": [9, 25]} if breaks == "list"
              else {"chain_break_mask": cbm})
        dist = np.asarray(jrec.reconstruct_backbone_distmat_from_interresidue_geometry(
            g["d_cb"], g["omega"], g["theta"], g["phi"], mask=g["d_cb_mask"],
            **({"chain_break_mask": jnp.asarray(cbm)})))
        kw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    got = trec.reconstruct_backbone_distmat_from_interresidue_geometry(
        *_maps(g), mask=_t(g["d_cb_mask"]), **kw)
    assert got.shape == (3, 3, 40, 40)
    assert_parity(dist, got, 1e-5, "distmat")
    assert (as_numpy(got) < 1e6).all()
    with pytest.raises(ValueError, match="not both"):
        trec.reconstruct_backbone_distmat_from_interresidue_geometry(
            *_maps(g), chain_breaks=[1], chain_break_mask=torch.zeros(39, dtype=torch.bool))


def _dm(x):
    x = np.asarray(x, np.float64)
    return np.linalg.norm(x[:, None] - x[None], axis=-1)


def _pdist(dist):
    n = dist.shape[-1] * 3
    return np.ascontiguousarray(dist.transpose(0, 2, 1, 3).reshape(n, n))


def test_classical_mds_matches_jax_up_to_sign(fragment):
    _, _, dist = fragment
    pd = _pdist(dist)
    ref = np.asarray(jax.jit(jrec.classical_mds)(pd))
    got = as_numpy(trec.classical_mds(_t(pd)))
    sign = np.sign((ref * got).sum(0))
    np.testing.assert_allclose(got * sign, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(_dm(got), _dm(ref), rtol=0, atol=1e-4)


def test_smacof_matches_jax_from_the_same_start(fragment):
    _, _, dist = fragment
    pd = _pdist(dist)
    start = np.asarray(jax.jit(jrec.classical_mds)(pd))
    ref = np.asarray(jax.jit(jrec.smacof_refine, static_argnames="n_iter")(pd, start, n_iter=200))
    got = as_numpy(trec.smacof_refine(_t(pd), _t(start), n_iter=200))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_initialize_backbone_with_mds_matches_jax(fragment):
    _, _, dist = fragment
    ref = np.asarray(jrec.initialize_backbone_with_mds(jnp.asarray(dist), max_iter=200))
    got = as_numpy(trec.initialize_backbone_with_mds(_t(dist), max_iter=200))
    assert got.shape == ref.shape == (5, 40, 3)
    a, b = got.reshape(-1, 3), ref.reshape(-1, 3)
    r, t = tgeom.kabsch(_t(a).double(), _t(b).double())
    assert float(torch.linalg.det(r)) > 0  # a rotation: both have the same hand
    fitted = a @ r.numpy().T + t.numpy()
    np.testing.assert_allclose(fitted, b, rtol=0, atol=2e-4)
    np.testing.assert_allclose(_dm(a), _dm(b), rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", BUNDLED)
def test_fix_chirality_decides_as_jax(name):
    """Native backbones (right-handed: kept) and their mirror images
    (flipped back), missing atoms NaN: the same output bits."""
    jb = JaxBatch.from_pdb(pdb_path(name))
    bb = np.asarray(jb.xyz[0, :, :3]).transpose(1, 0, 2)  # (3, L, 3) N/CA/C
    fix = jax.jit(jgeom.fix_chirality)
    for coords in (bb, bb * np.array([1.0, 1.0, -1.0], np.float32)):
        ref = np.asarray(fix(coords))
        got = as_numpy(tgeom.fix_chirality(_t(coords)))
        np.testing.assert_array_equal(ref, got)
    assert np.array_equal(np.asarray(fix(bb)), bb, equal_nan=True)


def test_reconstruction_quality_gate_1rex():
    sb = port_of(JaxBatch.from_pdb(pdb_path("1REX.pdb")))
    g = sb.inter_residue_geometry(use_kernel=True)
    ci = as_numpy(sb.chain_idx[0])
    dist = trec.reconstruct_backbone_distmat_from_interresidue_geometry(
        g["d_cb"][0], g["omega"][0], g["theta"][0], g["phi"][0], mask=g["d_cb_mask"][0],
        chain_break_mask=torch.from_numpy(ci[1:] != ci[:-1]))
    coords = as_numpy(trec.initialize_backbone_with_mds(dist, max_iter=200))
    m = as_numpy(sb.get_residue_mask()[0])
    pair = m[:, None] & m[None]
    rms = np.sqrt(((_dm(coords[1]) - _dm(as_numpy(sb.xyz[0, :, 1])))[pair] ** 2).mean())
    assert rms < 1.5, rms
