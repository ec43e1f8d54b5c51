"""The analysis ops: the port vs the JAX package on the CPU.

Surface (SASA, radius of gyration, contact order), clash energy, secondary
structure (H-bond energies, SS3, SS8), Ramachandran classes and the
structure metrics (superposition, TM-score, GDT-TS, the DockQ components),
each fed the same numpy inputs as its jitted JAX twin, and the
``StructureBatch`` methods over them.  Inputs: 1REX, a 40-residue two-chain
fragment of 1ad0_DC, and synthetic cases (missing atoms, a single-residue
chain, a two-residue structure).

Tolerances: float outputs within ``1e-5 * max(1, max|ref|)``; labels exactly
equal, except a label that flips on an input within 1e-4 of its threshold
(an H-bond energy at -0.5 kcal/mol, a Ramachandran ellipse at 1.0, a SASA
test point at its occluder's radius, a DockQ score at a band edge): such
flips are counted and printed, and any other flip fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu import geometry as jgeom
from protstruc_tpu.ops import metrics as jmetrics
from protstruc_tpu.ops import pack as jpack
from protstruc_tpu.ops import rama as jrama
from protstruc_tpu.ops import secondary as jsec
from protstruc_tpu.ops import surface as jsurf
from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.convert import structure_batch_from_numpy
from protstruc_tpu_torch.ops import metrics, pack, rama, secondary, surface
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

NEAR = 1e-4  # how close to its threshold an input must be for a label to flip
N_POINTS = 30
SASA_MAX_L = 64


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _tol(ref):
    r = np.abs(as_numpy(ref))
    return 1e-5 * max(1.0, float(np.nanmax(r)) if r.size else 1.0)


def assert_close(ref, got, name):
    assert_parity(np.asarray(ref), got, _tol(ref), name)


def _arrays(sb, sel=None, chain_idx=None):
    d = {"xyz": np.array(sb.xyz), "atom_mask": np.array(sb.atom_mask),
         "chain_idx": np.array(sb.chain_idx), "residue_idx": np.array(sb.residue_idx),
         "seq_idx": np.array(sb.get_seq_idx())}
    if sel is not None:
        d = {k: v[:, sel] for k, v in d.items()}
    if chain_idx is not None:
        d["chain_idx"] = np.asarray(chain_idx, np.int32)[None]
    return d


def interface_selection(sb, per_chain=20):
    """Indices of the ``per_chain`` residues of each of chains 0 and 1 whose
    CA lies closest to the other chain, in chain order."""
    ca, ci = np.asarray(sb.xyz)[0, :, 1], np.asarray(sb.chain_idx)[0]
    d = np.linalg.norm(ca[:, None] - ca[None], axis=-1)
    d = np.where(ci[:, None] != ci[None], np.nan_to_num(d, nan=1e9), 1e9).min(1)
    return np.sort(np.concatenate([np.where(ci == c)[0][np.argsort(d[ci == c])[:per_chain]]
                                   for c in (0, 1)]))


def _interface_fragment():
    """20 residues of each chain of 1ad0_DC around the interface."""
    sb = JaxBatch.from_pdb(pdb_path("1ad0_DC.pdb"))
    return _arrays(sb, interface_selection(sb))


@pytest.fixture(scope="module")
def cases():
    rex = JaxBatch.from_pdb(pdb_path("1REX.pdb"))
    out = {"1rex": _arrays(rex), "frag2": _interface_fragment()}
    nan = _arrays(rex, np.arange(48))
    rng = np.random.RandomState(0)
    drop = (rng.rand(*nan["atom_mask"].shape) < 0.1) & nan["atom_mask"]
    drop[0, 20] = nan["atom_mask"][0, 20]  # a residue with no atom at all
    nan["xyz"][drop] = np.nan
    nan["atom_mask"] &= ~drop
    out["nan_atoms"] = nan
    out["single_res_chain"] = _arrays(rex, np.arange(30),
                                      chain_idx=[0] * 14 + [1] + [2] * 15)
    out["two_res"] = _arrays(rex, np.arange(60, 62))
    return out


CASES = ["1rex", "frag2", "nan_atoms", "single_res_chain", "two_res"]


def _residue_mask(c):
    return c["atom_mask"].any(-1)


# ---------------------------------------------------------------------------
# secondary structure
# ---------------------------------------------------------------------------


def _backbone(c):
    xyz = np.nan_to_num(c["xyz"])
    return [xyz[:, :, k] for k in range(4)]


def _hb_flips_traced(e_ref, hb_got, name):
    """The H-bond maps may differ only where the reference energy lies
    within NEAR of the cutoff; returns how many entries differ."""
    hb_ref = e_ref < -0.5
    diff = hb_ref != as_numpy(hb_got)
    far = diff & (np.abs(e_ref + 0.5) >= NEAR)
    assert not far.any(), f"{name}: H-bond flips far from the cutoff at {np.argwhere(far)[:5]}"
    print(f"{name}: {int(diff.sum())} H-bond flips within {NEAR} of the cutoff")
    return int(diff.sum())


@jax.jit
def _jax_secondary(n, ca, c, o, rm, ci):
    return (jsec.hbond_energy_map(n, ca, c, o, rm, ci),
            jsec.assign_secondary_structure(n, ca, c, o, rm, ci)[0],
            jsec.assign_secondary_structure_8(n, ca, c, o, rm, ci))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("with_chain", [True, False])
def test_secondary_structure_matches_jax(cases, case, with_chain):
    c = cases[case]
    bb, rm = _backbone(c), _residue_mask(c)
    ci = c["chain_idx"] if with_chain else None
    e_ref, ss_ref, ss8_ref = map(np.asarray, _jax_secondary(*bb, rm, ci))
    e_got = secondary.hbond_energy_map(*map(_t, bb), _t(rm), _t(ci))
    assert_close(e_ref, e_got, "hbond energy")
    ss_got, hb_got = secondary.assign_secondary_structure(*map(_t, bb), _t(rm), _t(ci))
    ss8_got = secondary.assign_secondary_structure_8(*map(_t, bb), _t(rm), _t(ci))
    assert ss_got.dtype == ss8_got.dtype == torch.int32
    if _hb_flips_traced(e_ref, hb_got, case) == 0:
        np.testing.assert_array_equal(ss_ref, as_numpy(ss_got))
        np.testing.assert_array_equal(ss8_ref, as_numpy(ss8_got))
    assert secondary.SS8_LETTERS == jsec.SS8_LETTERS
    assert secondary.SS8_TO_3 == tuple(np.asarray(jsec.SS8_TO_3).tolist())


# ---------------------------------------------------------------------------
# Ramachandran classes
# ---------------------------------------------------------------------------


def _ellipse_values(phi, psi, seq_idx):
    """Every ellipse value ``dp^2 + ds^2`` a residue's class reads, (B, L, K),
    in float64 from the reference's inputs."""
    phi_d, psi_d = np.degrees(phi.astype(np.float64)), np.degrees(psi.astype(np.float64))
    wrap = lambda x: x - 360.0 * np.round(x / 360.0)  # noqa: E731
    vals = []
    for regions in (jrama._GENERAL, jrama._PRO):
        for scale in (1.0, jrama._ALLOWED_SCALE):
            for sign in (1.0, -1.0):
                for p0, s0, rp, rs in regions:
                    dp = wrap(sign * phi_d - p0) / (rp * scale)
                    ds = wrap(sign * psi_d - s0) / (rs * scale)
                    vals.append(dp * dp + ds * ds)
    return np.stack(vals, -1)


def assert_rama_equal(ref, got, phi, psi, seq_idx, name):
    ref, got = np.asarray(ref), as_numpy(got)
    flips = ref != got
    if flips.any():
        near = (np.abs(_ellipse_values(phi, psi, seq_idx) - 1.0) < NEAR).any(-1)
        assert (near | ~flips).all(), f"{name}: Ramachandran flips far from an ellipse edge"
    print(f"{name}: {int(flips.sum())} Ramachandran flips within {NEAR} of an ellipse edge")


@jax.jit
def _jax_phi_psi(sb):
    d, m = sb.backbone_dihedrals()
    return (jnp.nan_to_num(d[..., 0]), jnp.nan_to_num(d[..., 1]), m[..., 0] & m[..., 1])


@pytest.mark.parametrize("case", CASES)
def test_ramachandran_classes_match_jax(cases, case):
    c = cases[case]
    sb = JaxBatch.from_xyz(c["xyz"], atom_mask=c["atom_mask"])
    phi, psi, valid = map(np.asarray, _jax_phi_psi(sb))
    ref = jax.jit(jrama.ramachandran_classes)(phi, psi, c["seq_idx"], valid)
    got = rama.ramachandran_classes(_t(phi), _t(psi), _t(c["seq_idx"]), _t(valid))
    assert got.dtype == torch.int32
    assert_rama_equal(ref, got, phi, psi, c["seq_idx"], case)


def test_ramachandran_wrap_and_glycine_mirror():
    """Angles past +-180 wrap; glycine takes the mirrored regions."""
    phi = np.radians(np.array([[-63.0, 63.0, 63.0, 180.0, -179.9, 57.0]], np.float32))
    psi = np.radians(np.array([[-43.0, 43.0, 43.0, 180.0, 179.9, 40.0]], np.float32))
    seq = np.array([[0, 7, 0, 0, 7, 14]], np.int32)  # ALA, GLY, ALA, ALA, GLY, PRO
    valid = np.ones_like(seq, bool)
    ref = np.asarray(jrama.ramachandran_classes(phi, psi, seq, valid))
    got = rama.ramachandran_classes(_t(phi), _t(psi), _t(seq), _t(valid))
    np.testing.assert_array_equal(ref, as_numpy(got))
    assert as_numpy(got)[0, 1] == rama.RAMA_FAVORED  # mirrored alpha for glycine


# ---------------------------------------------------------------------------
# surface: SASA, radius of gyration, contact order
# ---------------------------------------------------------------------------


def _buried_margin(c, atoms, probe=1.4):
    """For the given flat atom indices, the smallest |d2 - (rc^2 - 1e-6)|
    over every test point and non-self occluder, in float64 from the inputs."""
    B, L, A = c["atom_mask"].shape
    r = jsurf.atom_radii_table()[np.clip(c["seq_idx"], 0, 20)]
    valid = c["atom_mask"] & (r > 0) & np.isfinite(c["xyz"]).all(-1)
    x = np.where(valid[..., None], np.nan_to_num(c["xyz"]), 1e6).reshape(B, L * A, 3)
    r_ext = (np.where(valid, r, 0.0) + probe).reshape(B, L * A)
    sphere = jsurf._sphere_points(N_POINTS).astype(np.float64)
    out = []
    for b, i in atoms:
        pts = x[b, i] + r_ext[b, i] * sphere
        d2 = ((pts[:, None] - x[b][None]) ** 2).sum(-1)
        m = np.abs(d2 - (r_ext[b] ** 2 - 1e-6)[None])
        m[:, i] = np.inf
        out.append(m.min())
    return np.array(out)


@pytest.mark.parametrize("case", CASES)
def test_sasa_matches_jax(cases, case):
    c = dict(cases[case])
    if c["xyz"].shape[1] > SASA_MAX_L:
        c = {k: v[:, :SASA_MAX_L] for k, v in c.items()}
    args = (c["xyz"], c["atom_mask"], c["seq_idx"])
    ref = np.asarray(jax.jit(lambda *a: jsurf.sasa(*a, n_points=N_POINTS, per_atom=True))(*args))
    got = as_numpy(surface.sasa(*map(_t, args), n_points=N_POINTS, per_atom=True))
    off = np.abs(ref - got) > _tol(ref)
    if off.any():  # each must be an atom with a test point on an occluder's edge
        B, L, A = ref.shape
        idx = [(b, l * A + a) for b, l, a in np.argwhere(off)]
        assert (_buried_margin(c, idx) < NEAR).all(), f"SASA off far from an edge at {idx[:5]}"
    print(f"{case}: {int(off.sum())} atoms' SASA differ through test points on an edge")
    assert_close(ref[~off], torch.from_numpy(got[~off]), "sasa per atom")
    per_res = surface.sasa(*map(_t, args), n_points=N_POINTS)
    np.testing.assert_allclose(as_numpy(per_res), got.sum(-1), rtol=1e-6, atol=1e-4)


@jax.jit
def _jax_compactness(xyz, atom_mask, rm, ci):
    ca = xyz[:, :, 1]
    return ([jsurf.radius_of_gyration(xyz, atom_mask), jsurf.radius_of_gyration(xyz)]
            + [jsurf.contact_order(ca, rm, relative=rel, chain_idx=chain)
               for rel in (True, False) for chain in (ci, None)])


@pytest.mark.parametrize("case", CASES)
def test_rg_and_contact_order_match_jax(cases, case):
    c = cases[case]
    ca, rm = _t(c["xyz"][:, :, 1]), _t(_residue_mask(c))
    got = ([surface.radius_of_gyration(_t(c["xyz"]), _t(c["atom_mask"])),
            surface.radius_of_gyration(_t(c["xyz"]))]
           + [surface.contact_order(ca, rm, relative=rel, chain_idx=chain)
              for rel in (True, False) for chain in (_t(c["chain_idx"]), None)])
    names = ["rg", "rg no mask"] + [f"contact order relative={rel} chain={chain}"
                                    for rel in (True, False) for chain in (True, False)]
    ref = _jax_compactness(c["xyz"], c["atom_mask"], _residue_mask(c), c["chain_idx"])
    for r, g, name in zip(ref, got, names):
        assert_close(r, g, name)


def test_atom_radii_and_sphere_points_match_jax():
    np.testing.assert_array_equal(jsurf.atom_radii_table(), surface.atom_radii_table())
    for n in (30, 92):
        np.testing.assert_array_equal(jsurf._sphere_points(n), surface._sphere_points(n))


# ---------------------------------------------------------------------------
# clash energy
# ---------------------------------------------------------------------------


_jax_clash = jax.jit(lambda x, m, s, tol: jpack.clash_energy(x, m, s, tolerance=tol))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("jitter", [0.0, 0.8])
def test_clash_energy_matches_jax(cases, case, jitter):
    """As parsed (few clashes) and with every atom moved ``randn * 0.8`` A."""
    c = cases[case]
    xyz = (c["xyz"] + jitter * np.random.RandomState(2).randn(*c["xyz"].shape)).astype(np.float32)
    for tol in (0.4, 0.0):
        ref = _jax_clash(xyz, c["atom_mask"], c["seq_idx"], tol)
        got = pack.clash_energy(_t(xyz), _t(c["atom_mask"]), _t(c["seq_idx"]), tolerance=tol)
        assert_close(ref, got, f"clash tolerance={tol}")
        if jitter and case != "two_res":
            assert float(got.min()) > 0.0


# ---------------------------------------------------------------------------
# structure metrics
# ---------------------------------------------------------------------------


def _model_of(native, seed, noise=0.7):
    """``native`` rotated, shifted and jittered (NaN kept)."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.linalg.det(q))
    return (native @ q.T + rng.randn(3) * 4 + rng.randn(*native.shape) * noise).astype(np.float32)


@jax.jit
def _jax_superposition(a, b, mask, n):
    return (*jmetrics.superimpose(a, b, mask),
            *[f(a, b, mask, align=al) for al in (True, False)
              for f in (jmetrics.tm_score, jmetrics.gdt_ts)],
            jmetrics.tm_score(a, b, mask, l_target=n))


@pytest.mark.parametrize("case", CASES)
def test_superposition_metrics_match_jax(cases, case):
    c = cases[case]
    native = c["xyz"][:, :, 1]
    model = _model_of(native, 3)
    mask = _residue_mask(c) & np.isfinite(native).all(-1)
    a, b = np.nan_to_num(model, nan=1e6), np.nan_to_num(native, nan=1e6)
    n = np.float32(100.0)
    ref_al, *ref = _jax_superposition(a, b, mask, n)
    ta, tb, tm = _t(a), _t(b), _t(mask)
    got_al, got_rmsd = metrics.superimpose(ta, tb, tm)
    got = [got_rmsd, *[f(ta, tb, tm, align=al) for al in (True, False)
                       for f in (metrics.tm_score, metrics.gdt_ts)],
           metrics.tm_score(ta, tb, tm, l_target=torch.tensor(n))]
    names = ["superimpose rmsd", "tm align", "gdt align", "tm no align", "gdt no align",
             "tm l_target"]
    for r, g, name in zip(ref, got, names):
        assert_close(r, g, name)
    assert_close(np.where(mask[..., None], ref_al, 0), torch.where(tm[..., None], got_al, 0),
                 "aligned")


def _groups(c):
    rm = _residue_mask(c)
    return rm & (c["chain_idx"] == 0), rm & (c["chain_idx"] == 1)


@jax.jit
def _jax_docking(model, native, am, rec, lig):
    return (jmetrics._min_interchain_dist(native, am, rec, lig),
            *[f(model, native, am, rec, lig)
              for f in (jmetrics.fnat, jmetrics.interface_rmsd, jmetrics.dockq)])


@pytest.mark.parametrize("shift", [0.0, 2.0, 8.0, 100.0])
def test_dockq_components_match_jax(cases, shift):
    """The two-chain fragment against itself with the ligand chain moved
    ``shift`` A and every atom jittered; at 100 A the model keeps no native
    contact (fnat 0).  An empty native interface gives NaN in both."""
    c = cases["frag2"]
    rec, lig = _groups(c)
    native = c["xyz"]
    rng = np.random.RandomState(int(shift))
    model = (native + np.where(lig[..., None, None], shift, 0.0)
             + rng.randn(*native.shape) * 0.3).astype(np.float32)
    am = c["atom_mask"]
    args = (model, native, am, rec, lig)
    targs = tuple(map(_t, args))
    d_ref, *ref = map(np.asarray, _jax_docking(*args))
    d_got = metrics._min_interchain_dist(_t(native), _t(am), _t(rec), _t(lig), row_block=7)
    assert_parity(d_ref, d_got, _tol(d_ref[np.isfinite(d_ref)]), "min interchain dist")
    for r, name in zip(ref, ("fnat", "interface_rmsd", "dockq")):
        assert_close(r, getattr(metrics, name)(*targs), name)
    q_ref = float(ref[2][0])
    q_got = float(metrics.dockq(*targs)[0])
    if min(abs(q_ref - e) for e in (0.23, 0.49, 0.80)) >= NEAR:
        assert metrics.capri_band(q_got) == jmetrics.capri_band(q_ref)


def test_empty_interface_matches_jax(cases):
    """No native contact within 10 A: the Kabsch fit over no point is NaN in
    both packages (XLA's SVD of NaN; the port no longer raises there), and
    iRMS and DockQ mask it out as the JAX package does."""
    c = cases["frag2"]
    rec, lig = _groups(c)
    native = c["xyz"] + np.where(lig[..., None, None], 100.0, 0.0).astype(np.float32)
    args = (native, native, c["atom_mask"], rec, lig)
    for name in ("interface_rmsd", "dockq"):
        ref = np.asarray(jax.jit(getattr(jmetrics, name))(*args))
        got = getattr(metrics, name)(*map(_t, args))
        assert_close(ref, got, name)
    a = np.zeros((2, 5, 3), np.float32)
    w = np.zeros((2, 5), bool)
    w[1] = True
    a[1] = np.random.RandomState(0).randn(5, 3)
    for r, g in zip(jax.jit(jgeom.masked_kabsch)(a, a, w), geom.masked_kabsch(_t(a), _t(a), _t(w))):
        assert_parity(np.asarray(r), g, 1e-5, "masked_kabsch")


@pytest.mark.parametrize("q", [0.0, 0.2299, 0.23, 0.4899, 0.49, 0.7999, 0.80, 1.0])
def test_capri_band_matches_jax(q):
    assert metrics.capri_band(q) == jmetrics.capri_band(q)


# ---------------------------------------------------------------------------
# the batch methods
# ---------------------------------------------------------------------------


def _batches(c, chain_ids=None):
    n_chain = int(c["chain_idx"].max()) + 1
    cids = [[chr(ord("A") + k) for k in range(n_chain)]]
    from protstruc_tpu_torch.vocab import AA
    seq = [{cid: "".join(AA(int(s)).oneletter() for s, ci in zip(c["seq_idx"][0], c["chain_idx"][0])
                         if ci == k) for k, cid in enumerate(cids[0])}]
    jb = JaxBatch.from_xyz(c["xyz"], atom_mask=c["atom_mask"], chain_idx=c["chain_idx"],
                           chain_ids=cids, seq=seq, residue_idx=c["residue_idx"])
    tb = structure_batch_from_numpy(np.array(jb.xyz), np.array(jb.atom_mask),
                                    np.array(jb.chain_idx), np.array(jb.residue_idx),
                                    chain_ids=cids, seq=seq, device=DEVICE)
    np.testing.assert_array_equal(np.asarray(jb.get_seq_idx()), as_numpy(tb.get_seq_idx()))
    return jb, tb


@jax.jit
def _jax_methods(jb, other):
    return (jb.secondary_structure(), jb.secondary_structure_8(), *jb.ramachandran_classes(),
            jb.radius_of_gyration(), jb.contact_order(), jb.clash_energy(), jb.sasa(n_points=20),
            jb.lddt_to(other), jb.lddt_to(other, per_residue=True))


@pytest.mark.parametrize("case", ["frag2", "nan_atoms", "single_res_chain"])
def test_batch_analysis_methods_match_jax(cases, case):
    jb, tb = _batches(cases[case])
    other_j = jb.replace(xyz=jnp.asarray(_model_of(np.asarray(jb.xyz), 5, 0.5)))
    other_t = tb.replace(xyz=_t(np.asarray(other_j.xyz)))
    ss, ss8, rama_cls, rama_valid, *ref = map(np.asarray, _jax_methods(jb, other_j))
    np.testing.assert_array_equal(ss, as_numpy(tb.secondary_structure()))
    np.testing.assert_array_equal(ss8, as_numpy(tb.secondary_structure_8()))
    tr, tv = tb.ramachandran_classes()
    np.testing.assert_array_equal(rama_valid, as_numpy(tv))
    np.testing.assert_array_equal(rama_cls, as_numpy(tr))
    got = [tb.radius_of_gyration(), tb.contact_order(), tb.clash_energy(), tb.sasa(n_points=20),
           tb.lddt_to(other_t), tb.lddt_to(other_t, per_residue=True)]
    for r, g, name in zip(ref, got, ("rg", "contact order", "clash", "sasa", "lddt_to",
                                     "lddt_to per residue")):
        assert_close(r, g, name)


def test_batch_replace_is_functional(cases):
    _, tb = _batches(cases["frag2"])
    moved = tb.replace(xyz=tb.xyz + 1.0)
    assert moved is not tb and torch.equal(moved.xyz.nan_to_num(), (tb.xyz + 1.0).nan_to_num())
    assert moved.atom_mask is tb.atom_mask and moved.seq == tb.seq
