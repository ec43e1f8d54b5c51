"""The rest of the port's StructureBatch API vs the JAX package on the CPU.

Both packages get the same batch (parsed from tests/data, or built from the
same numpy arrays seeded here).  Tolerances:

* float32 outputs within 1e-5 absolute of the JAX package's, with the same
  NaN pattern: ``from_backbone_orientations_translations``, ``from_sequence``
  and ``from_dihedrals`` at L <= 8 (longer NeRF chains: see
  tests/test_torch_reconstruct.py), ``translate``, ``rotate``,
  ``standardize``/``unstandardize`` (and ``mu``/``std``),
  ``center_of_mass``, ``center_at``, ``get_local_xyz``,
  ``pairwise_distance_matrix``, ``pairwise_atom_distance``,
  ``pairwise_dihedrals``, ``pairwise_planar_angles`` (against the jitted
  JAX maps), and ``align``'s R; ``align``'s t and coordinates within 1e-4
  (the float32 SVDs differ; see the test);
* masks and index fields bitwise: every constructor's, ``get_chain_mask``,
  ``split_chains``, ``interface_residues``, ``get_topk_nearest_residue_mask``
  (with tied distances and the excluded band), ``residue_masked_select``,
  ``residue_compact`` and the selections' metadata equal;
* the same errors for the same bad arguments;
* ``utils/buckets`` and ``convert`` carry ``mu``/``std``/``standardized``
  as the JAX ``utils/buckets.py`` does (bitwise).
"""

import jax
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.ops import pairwise as jax_pairwise
from protstruc_tpu.utils import buckets as jax_buckets
from protstruc_tpu_torch import StructureBatch, geometry
from protstruc_tpu_torch.convert import structure_batch_from_numpy, to_numpy
from protstruc_tpu_torch.utils import buckets
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

ATOL = 1e-5
FIELDS = ("xyz", "atom_mask", "chain_idx", "residue_idx")


def port_of(jb):
    """The port's batch holding the JAX batch's arrays and state."""
    arrays = {k: np.asarray(getattr(jb, k)) for k in FIELDS}
    mu = None if jb.mu is None else np.asarray(jb.mu)
    std = None if jb.std is None else np.asarray(jb.std)
    return structure_batch_from_numpy(**arrays, chain_ids=jb.chain_ids, seq=jb.seq, mu=mu,
                                      std=std, standardized=jb.standardized, device=DEVICE)


def assert_batches(jb, tb, atol=ATOL):
    assert_parity(jb.xyz, tb.xyz, atol, "xyz")
    for k in FIELDS[1:]:
        np.testing.assert_array_equal(as_numpy(getattr(jb, k)), as_numpy(getattr(tb, k)),
                                      err_msg=k)
    assert as_numpy(tb.chain_idx).dtype == np.int32
    for k in ("mu", "std"):
        if getattr(jb, k) is None:
            assert getattr(tb, k) is None, k
        else:
            assert_parity(getattr(jb, k), getattr(tb, k), atol, k)
    assert (tb.chain_ids, tb.seq, tb.standardized) == (jb.chain_ids, jb.seq, jb.standardized)


@pytest.fixture(scope="module")
def pair():
    """1REX and 1ad0_DC (two chains) padded into one batch."""
    jb = JaxBatch.from_pdb([pdb_path("1REX.pdb"), pdb_path("1ad0_DC.pdb")])
    return jb, port_of(jb)


@pytest.fixture(scope="module")
def small():
    """The first 24 residues of 1ad0_DC (one chain), for the (L, L, A, A) tensor."""
    jb = JaxBatch.from_pdb(pdb_path("1ad0_DC.pdb"))
    jb = jb.residue_masked_select(np.arange(jb.n_residues)[None] < 24)
    return jb, port_of(jb)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("include_cb", [False, True])
def test_from_backbone_orientations_translations_matches_jax(pair, include_cb):
    jb, _ = pair
    rot = np.nan_to_num(np.asarray(jb.backbone_orientations()))
    trans = np.nan_to_num(np.asarray(jb.backbone_translations()))
    kw = dict(chain_idx=np.asarray(jb.chain_idx), chain_ids=jb.get_chain_ids(),
              seq=jb.get_seq(), residue_idx=np.asarray(jb.residue_idx), include_cb=include_cb)
    ref = JaxBatch.from_backbone_orientations_translations(rot, trans, **kw)
    got = StructureBatch.from_backbone_orientations_translations(
        torch.from_numpy(rot), trans, device=DEVICE, **kw)
    assert_batches(ref, got)
    # round trip: the frames and CA positions come back
    assert_parity(as_numpy(got.backbone_translations()), trans, ATOL, "translations")


@pytest.mark.parametrize("seqs", [["MKVGAST", "MKV"], "GAVLIKE", ["A", "WY"]])
def test_from_sequence_matches_jax(seqs):
    ref = JaxBatch.from_sequence(seqs)
    got = StructureBatch.from_sequence(seqs, device=DEVICE)
    assert_batches(ref, got)
    for getter in ("get_c_terminal_mask", "get_seq_idx", "get_total_lengths"):
        np.testing.assert_array_equal(as_numpy(getattr(ref, getter)()),
                                      as_numpy(getattr(got, getter)()), err_msg=getter)
    np.testing.assert_array_equal(as_numpy(ref.get_chain_mask("A")),
                                  as_numpy(got.get_chain_mask("A")))


def test_from_dihedrals_matches_jax():
    rng = np.random.RandomState(3)
    tor = rng.uniform(-3.1, 3.1, (2, 8, 3)).astype(np.float32)
    ci = np.array([[0] * 5 + [1] * 3, [0] * 8])
    kw = dict(chain_idx=ci, chain_ids=[["A", "B"], ["A"]])
    ref = JaxBatch.from_dihedrals(tor, **kw)
    got = StructureBatch.from_dihedrals(torch.from_numpy(tor), device=DEVICE, **kw)
    assert_batches(ref, got)
    with pytest.raises(ValueError, match="should be provided"):
        StructureBatch.from_dihedrals(tor, chain_idx=ci, device=DEVICE)


# ---------------------------------------------------------------------------
# rigid moves and standardization
# ---------------------------------------------------------------------------


def _rotations(n, seed):
    rng = np.random.RandomState(seed)
    q = np.linalg.qr(rng.randn(n, 3, 3))[0]
    return (q * np.sign(np.linalg.det(q))[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("case", ["residue", "atomwise", "shared_rot", "per_structure_rot"])
def test_translate_rotate_match_jax(pair, case):
    jb, tb = pair
    rng = np.random.RandomState(7)
    if case == "residue":
        t = rng.randn(2, jb.n_residues, 3).astype(np.float32)
        ref, got = jb.translate(t), tb.translate(torch.from_numpy(t))
    elif case == "atomwise":
        t = rng.randn(*jb.xyz.shape).astype(np.float32)
        ref, got = jb.translate(t, atomwise=True), tb.translate(t, atomwise=True)
    elif case == "shared_rot":
        r = _rotations(1, 1)[0]
        ref, got = jb.rotate(r), tb.rotate(torch.from_numpy(r))
    else:
        r = _rotations(2, 2)
        ref, got = jb.rotate(r), tb.rotate(r)
    assert_batches(ref, got)


@pytest.mark.parametrize("masking", ["none", "atom_mask", "residue_mask"])
def test_standardize_round_trip_matches_jax(pair, masking):
    jb, tb = pair
    kw = {}
    if masking == "atom_mask":
        am = np.asarray(jb.atom_mask).copy()
        am[:, :, 4:] = False  # backbone atoms only
        kw = {"atom_mask": am}
    elif masking == "residue_mask":
        kw = {"residue_mask": np.arange(jb.n_residues)[None].repeat(2, 0) < 60}
    ref, got = jb.standardize(**kw), tb.standardize(**kw)
    assert got.standardized and got.mu.shape == (2, 3)
    assert_batches(ref, got)
    back_ref, back = ref.unstandardize(), got.unstandardize()
    assert_batches(back_ref, back)
    assert_parity(as_numpy(tb.xyz), back.xyz, 1e-4, "round trip")  # |xyz| <= 100 A

    with pytest.raises(ValueError, match="already standardized"):
        got.standardize()
    with pytest.raises(ValueError, match="not standardized"):
        tb.unstandardize()
    with pytest.raises(ValueError, match="Only one of"):
        tb.standardize(atom_mask=np.asarray(jb.atom_mask),
                       residue_mask=np.ones((2, jb.n_residues), bool))


@pytest.mark.parametrize("center", [None, [1.0, -2.0, 3.5], [[0.5, 0.5, 0.5]],
                                    [[1.0, 2.0, 3.0], [-4.0, 5.0, 6.0]]])
def test_center_at_matches_jax(pair, center):
    jb, tb = pair
    assert_parity(jb.center_of_mass(), tb.center_of_mass(), ATOL, "center_of_mass")
    assert_batches(jb.center_at(center), tb.center_at(center))


@pytest.mark.parametrize("bad", [np.zeros((3, 3)), np.zeros(4), np.zeros((1, 1, 3))])
def test_center_at_shape_errors_match_jax(pair, bad):
    jb, tb = pair
    with pytest.raises(ValueError) as ref:
        jb.center_at(bad)
    with pytest.raises(ValueError) as got:
        tb.center_at(bad)
    assert str(got.value) == str(ref.value)


def test_get_local_xyz_matches_jax(pair):
    jb, tb = pair
    assert_parity(jb.get_local_xyz(), tb.get_local_xyz(), ATOL, "local xyz")


def test_to_carries_standardization(pair):
    _, tb = pair
    moved = tb.standardize().to("cpu")
    assert moved.standardized and moved.mu is not None and moved.std is not None
    with pytest.raises(ValueError, match="span devices"):
        tb.replace(mu=torch.zeros(2, 3, device="meta"))


# ---------------------------------------------------------------------------
# selection
# ---------------------------------------------------------------------------


def test_get_chain_mask_and_split_chains_match_jax():
    jb = JaxBatch.from_pdb(pdb_path("1ad0_DC.pdb"))
    tb = port_of(jb)
    for cid in ("D", "C", "Z"):
        np.testing.assert_array_equal(as_numpy(jb.get_chain_mask(cid)),
                                      as_numpy(tb.get_chain_mask(cid)), err_msg=cid)
    refs, gots = jb.split_chains(), tb.split_chains()
    assert len(gots) == len(refs) == 2
    for ref, got in zip(refs, gots):
        assert_batches(ref, got, atol=0.0)
    with pytest.raises(ValueError, match="batch size 1"):
        port_of(JaxBatch.from_pdb([pdb_path("1REX.pdb")] * 2)).split_chains()


@pytest.mark.parametrize("cutoff,atom", [(8.0, "CB"), (6.0, "CA"), (10.0, "CB")])
def test_interface_residues_match_jax(pair, cutoff, atom):
    jb, tb = pair
    got = as_numpy(tb.interface_residues(cutoff, atom))
    np.testing.assert_array_equal(np.asarray(jb.interface_residues(cutoff, atom)), got)
    assert got[1].any() and not got[0].any()  # 1REX has one chain


def _topk_batch():
    """CA atoms on a line at integer spacing around query points at 0 and 10:
    many exactly tied distances; residue 3 has atoms but no CA (NaN), residue
    9 none at all; structure 1 is one residue shorter (padding)."""
    L = 12
    xyz = np.zeros((2, L, 15, 3), np.float32)
    xyz[:, :, :, 0] = np.arange(L, dtype=np.float32)[None, :, None] * 1.0 - 2.0
    am = np.ones((2, L, 15), bool)
    xyz[:, 3, 1] = np.nan
    am[:, 3, 1] = False
    am[:, 9] = False
    am[1, L - 1] = False
    ci = np.zeros((2, L), np.int32)
    ci[1, L - 1] = -1
    jb = JaxBatch.from_xyz(xyz, am, chain_idx=ci, chain_ids=[["A"], ["A"]])
    return jb, port_of(jb)


@pytest.mark.parametrize("k,query,with_mask", [
    (3, [[0.0, 0.0, 0.0]], False),
    (4, [[0.0, 0.0, 0.0], [10.0, 0.0, 0.0]], False),
    (5, [[1.5, 0.0, 0.0]], True),
    (50, [[0.0, 3.0, 4.0]], False),        # k past L: every valid residue
    (7, [[[0.0, 0.0, 0.0]], [[4.0, 0.0, 0.0]]], True),  # a query per structure
])
def test_topk_nearest_residue_mask_matches_jax(k, query, with_mask):
    jb, tb = _topk_batch()
    mask = None
    if with_mask:
        mask = np.ones((2, jb.n_residues), bool)
        mask[:, 1] = False
    ref = np.asarray(jb.get_topk_nearest_residue_mask(np.asarray(query, np.float32), k, mask))
    got = as_numpy(tb.get_topk_nearest_residue_mask(torch.tensor(query), k, mask))
    np.testing.assert_array_equal(ref, got)
    assert not got[:, 3].any() and not got[:, 9].any()


def test_residue_masked_select_matches_jax(pair):
    jb, _ = pair
    one = JaxBatch.from_pdb(pdb_path("1ad0_DC.pdb")).standardize()
    tone = port_of(one)
    sel = np.zeros((1, one.n_residues), bool)
    sel[0, 5:40] = True
    sel[0, 300:310] = True
    ref, got = one.residue_masked_select(sel), tone.residue_masked_select(torch.from_numpy(sel))
    assert_batches(ref, got, atol=0.0)
    assert got.standardized and got.mu is tone.mu
    for bad, msg in ((sel.astype(np.int32), "boolean"), (sel[:, :10], "does not match")):
        with pytest.raises(ValueError, match=msg):
            tone.residue_masked_select(bad)
    with pytest.raises(ValueError, match="batch size > 1"):
        port_of(jb).residue_masked_select(np.ones((2, jb.n_residues), bool))


@pytest.mark.parametrize("seed", [0, 1])
def test_residue_compact_matches_jax(pair, seed):
    jb, tb = pair
    mask = np.random.RandomState(seed).rand(2, jb.n_residues) < 0.4
    assert_batches(jb.residue_compact(mask), tb.residue_compact(torch.from_numpy(mask)), atol=0.0)


# ---------------------------------------------------------------------------
# pair features and alignment
# ---------------------------------------------------------------------------


def test_pairwise_distance_matrix_matches_jax(small):
    jb, tb = small
    d_ref, m_ref = jb.pairwise_distance_matrix()
    d, m = tb.pairwise_distance_matrix()
    assert d.shape == (1, 24, 24, 15, 15)
    assert_parity(d_ref, d, ATOL, "distances")
    assert_parity(m_ref, m, 0, "mask")


@pytest.mark.parametrize("atoms", [("CA", "CA"), ("CB", "CB"), ("N", "O"), ("C", "N")])
def test_pairwise_atom_distance_matches_jax(pair, atoms):
    jb, tb = pair
    d_ref, m_ref = jb.pairwise_atom_distance(*atoms)
    d, m = tb.pairwise_atom_distance(*atoms)
    assert_parity(d_ref, d, ATOL, "distance")
    assert_parity(m_ref, m, 0, "mask")


@pytest.mark.parametrize("kind,atoms_i,atoms_j", [
    ("dihedral", ("CA", "CB"), ("CA", "CB")),
    ("dihedral", ("N", "CA", "CB"), ("CB",)),
    ("dihedral", ("C",), ("N", "CA", "C")),
    ("planar", ("CA", "CB"), ("CB",)),
    ("planar", ("N",), ("CA", "C")),
])
def test_pairwise_angle_maps_match_jax(pair, kind, atoms_i, atoms_j):
    """Against the jitted JAX maps (as ``inter_residue_geometry`` runs them):
    the port's arithmetic is XLA's under jit (FMA dot products), and eager
    JAX differs from its own jitted maps by up to 2.9e-5 through arccos."""
    jb, tb = pair
    name = "pairwise_dihedrals" if kind == "dihedral" else "pairwise_planar_angles"
    fn = (jax_pairwise.pairwise_dihedral_maps if kind == "dihedral"
          else jax_pairwise.pairwise_planar_angle_maps)
    ref = jax.jit(fn, static_argnums=(1, 2))(jb.xyz, atoms_i, atoms_j)
    assert_parity(ref, getattr(tb, name)(list(atoms_i), list(atoms_j)), ATOL, name)


@pytest.mark.parametrize("case", ["same_batch", "broadcast_target", "explicit_mask"])
def test_align_matches_jax(pair, case):
    """R within 1e-5.  t and the aligned coordinates carry each package's
    float32 SVD error times the coordinates' size (up to 70 A here): the port
    applied to JAX's R and t gives JAX's coordinates within 1e-5, its own
    R and t give them within 1e-4 (2.3e-5 in t and 3.4e-5 in xyz measured),
    and its t is no further than JAX's from a float64 Kabsch (JAX's R is
    8.3e-7 from it, the port's 2.6e-7)."""
    jb, _ = pair
    r = _rotations(2, 5)
    t = np.random.RandomState(6).randn(2, 1, 3).astype(np.float32) * 10
    moved = jb.rotate(r).translate(np.broadcast_to(t, (2, jb.n_residues, 3)))
    target, mask = jb, None
    if case == "broadcast_target":
        target = JaxBatch.from_pdb([pdb_path("1REX.pdb")])
        moved = JaxBatch.from_pdb([pdb_path("1REX.pdb")] * 2).rotate(r)
    elif case == "explicit_mask":
        mask = np.asarray(jb.atom_mask).copy()
        mask[:, :, 3:] = False  # align on N, CA, C
    (ref, (r_ref, t_ref)) = moved.align(target, atom_mask=mask)
    tm = port_of(moved)
    (got, (r_got, t_got)) = tm.align(port_of(target), atom_mask=mask)
    assert_parity(r_ref, r_got, ATOL, "R")
    applied = tm.rotate(np.asarray(r_ref)).translate(np.asarray(t_ref)[:, None, :])
    assert_batches(ref, applied)
    assert_parity(t_ref, t_got, 1e-4, "t")
    assert_batches(ref, got, atol=1e-4)

    w = (np.asarray(moved.atom_mask) & np.asarray(target.atom_mask) if mask is None else mask)
    w = np.broadcast_to(w, moved.atom_mask.shape).reshape(2, -1)
    src = np.asarray(moved.xyz, np.float64).reshape(2, -1, 3)
    tgt = np.broadcast_to(np.asarray(target.xyz, np.float64), moved.xyz.shape).reshape(2, -1, 3)
    _, t64 = geometry.masked_kabsch(*(torch.from_numpy(np.where(w[..., None], a, 0.0))
                                      for a in (src, tgt)), torch.from_numpy(w))
    err_ref = np.abs(np.asarray(t_ref) - t64.numpy()).max()
    assert np.abs(as_numpy(t_got) - t64.numpy()).max() <= err_ref + ATOL
    with pytest.raises(ValueError, match="must be the same"):
        port_of(moved).align(port_of(JaxBatch.from_pdb([pdb_path("1REX.pdb")] * 3)))


# ---------------------------------------------------------------------------
# buckets and convert carry the standardization state
# ---------------------------------------------------------------------------


def test_buckets_carry_standardization(pair):
    jb, _ = pair
    a = JaxBatch.from_pdb(pdb_path("1REX.pdb")).standardize()
    b = jb.standardize()
    ref = jax_buckets.concat_batches([a, b])
    got = buckets.concat_batches([port_of(a), port_of(b)])
    assert_batches(ref, got, atol=0.0)
    assert got.mu.shape == (3, 3)
    with pytest.raises(ValueError, match="standardized with unstandardized"):
        buckets.concat_batches([port_of(a), port_of(jb)])
    padded = buckets.pad_batch_to_bucket(port_of(a))
    assert_batches(jax_buckets.pad_batch_to_bucket(a), padded, atol=0.0)


def test_convert_round_trip_with_standardization(pair):
    jb, _ = pair
    sj = jb.standardize()
    back = to_numpy(port_of(sj))
    assert back["standardized"] is True
    np.testing.assert_array_equal(back["mu"], np.asarray(sj.mu))
    np.testing.assert_array_equal(back["std"], np.asarray(sj.std))
    again = structure_batch_from_numpy(**back, device=DEVICE)
    assert_batches(sj, again, atol=0.0)
    plain = to_numpy(port_of(jb))
    assert plain["mu"] is None and plain["standardized"] is False


def test_from_sequence_ragged_padding_invariants():
    """Padding past a shorter sequence carries no atoms and PAD_IDX indices,
    so its C-terminus is found, as in the JAX package."""
    got = StructureBatch.from_sequence(["MKVGA", "MK"], device=DEVICE)
    assert as_numpy(got.chain_idx)[1, 2:].tolist() == [-1, -1, -1]
    assert as_numpy(got.residue_idx)[1, 2:].tolist() == [-1, -1, -1]
    assert not as_numpy(got.atom_mask)[1, 2:].any()
    ref = JaxBatch.from_sequence(["MKVGA", "MK"])
    np.testing.assert_array_equal(np.asarray(ref.get_c_terminal_mask()),
                                  as_numpy(got.get_c_terminal_mask()))
    assert as_numpy(got.get_c_terminal_mask())[1].tolist() == [False, True, False, False, False]
