"""The port's histograms, serialization, checks, profiling, NumPy adapter and
reference shims vs the JAX package's on the CPU.

Tolerances: the histogram counts and contact maps are exact (the bin is the
JAX package's float expression, truncated); serialized batches load across
the two packages bitwise; ``validate_batch`` gives the same problem strings;
``compat``'s geometry agrees with the JAX package's at 1e-5 (the geometry
parity budget of tests/test_torch_geometry.py).
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import AntibodyStructureBatch as JaxAb
from protstruc_tpu import StructureBatch as JaxSB
from protstruc_tpu import compat as jax_compat
from protstruc_tpu import general as jax_general
from protstruc_tpu.ops import histogram as jax_hist
from protstruc_tpu.utils import checks as jax_checks
from protstruc_tpu.utils import serialization as jax_ser
from protstruc_tpu_torch import AntibodyStructureBatch, StructureBatch, compat
from protstruc_tpu_torch.ops import histogram
from protstruc_tpu_torch.utils import checks, profiling, serialization
from tests.conftest import pdb_path
from tests.test_torch_batch_api import port_of

torch.set_num_threads(1)

DEVICE = "cpu"


# -- histograms ---------------------------------------------------------------------

def seeded_distances(B=3, L=23, n_bins=64, max_dist=32.0, seed=0):
    """Distances over [-4, 1.2 max_dist) with NaN, +-inf, exact bin edges
    ``k * w`` and the float just below ``max_dist``."""
    rng = np.random.RandomState(seed)
    d = rng.uniform(-4.0, 1.2 * max_dist, (B, L, L)).astype(np.float32)
    flat = d.reshape(-1)
    pick = rng.permutation(flat.size)
    w = np.float32(max_dist) / np.float32(n_bins)
    edges = (np.arange(n_bins + 1, dtype=np.float32) * w).astype(np.float32)
    n_e = len(edges)
    flat[pick[:n_e]] = edges
    flat[pick[n_e:2 * n_e]] = np.nextafter(edges, np.float32(0))
    flat[pick[2 * n_e:2 * n_e + 9]] = [np.nan] * 5 + [np.inf, -np.inf, -0.0, 0.0]
    flat[pick[2 * n_e + 9:2 * n_e + 40]] = np.nextafter(np.float32(max_dist), np.float32(0))
    return d, rng.rand(B, L, L) > 0.3


def real_d_cb():
    sb = StructureBatch.from_pdb([pdb_path("1REX.pdb"), pdb_path("1ad0_DC.pdb"),
                                  pdb_path("4EOT.pdb")], device=DEVICE)
    g = sb.inter_residue_geometry()
    return g["d_cb"].numpy(), g["d_cb_mask"].numpy()


@pytest.mark.parametrize("n_bins,max_dist", [(64, 32.0), (36, 20.0), (7, 0.3), (10, 22.5)])
def test_distance_histogram_counts_equal_jax(n_bins, max_dist, monkeypatch):
    d, mask = seeded_distances(n_bins=n_bins, max_dist=max_dist)
    cases = [(d, None), (d, mask), (d, mask[0])]
    if n_bins == 64:
        cases += [real_d_cb()]
    for chunk in (histogram.HISTOGRAM_CHUNK_PAIRS, 700):  # one chunk; a structure a chunk
        monkeypatch.setattr(histogram, "HISTOGRAM_CHUNK_PAIRS", chunk)
        for dd, m in cases:
            ref = np.asarray(jax_hist.distance_histogram(
                jnp.asarray(dd), None if m is None else jnp.asarray(m), n_bins=n_bins,
                max_dist=max_dist))
            got = histogram.distance_histogram(
                torch.from_numpy(dd), None if m is None else torch.from_numpy(m), n_bins=n_bins,
                max_dist=max_dist)
            assert got.dtype == torch.int32 and got.shape == ref.shape
            np.testing.assert_array_equal(got.numpy(), ref)
            valid = np.isfinite(dd) & (dd >= 0) & (dd < max_dist)
            if m is not None:
                valid &= np.broadcast_to(m, dd.shape)
            assert (got.numpy().sum(1) <= valid.sum((1, 2))).all()


@pytest.mark.parametrize("cutoff", [8.0, 0.5, 40.0])
def test_contact_map_equals_jax(cutoff):
    d, mask = seeded_distances()
    for dd, m in [(d, None), (d, mask), real_d_cb()]:
        ref = np.asarray(jax_hist.contact_map(jnp.asarray(dd), None if m is None else jnp.asarray(m),
                                              cutoff=cutoff))
        got = histogram.contact_map(torch.from_numpy(dd), None if m is None else torch.from_numpy(m),
                                    cutoff=cutoff)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), ref)


# -- serialization ------------------------------------------------------------------

def jax_batches():
    plain = JaxSB.from_pdb(pdb_path("1ad0_DC.pdb")).standardize()
    ab = JaxAb.from_pdb([pdb_path("6dc4.pdb"), pdb_path("15c8_HL.pdb")], "H", "L")
    rng = np.random.RandomState(0)
    bare = JaxAb(xyz=jnp.asarray(rng.randn(1, 8, 15, 3).astype(np.float32)),
                 atom_mask=jnp.ones((1, 8, 15), bool), chain_idx=jnp.zeros((1, 8), jnp.int32),
                 residue_idx=jnp.arange(8, dtype=jnp.int32)[None], chain_ids=None, seq=None,
                 residue_masks=None, heavy_chain_id=("H",), light_chain_id=(None,),
                 antigen_chain_ids=((),))
    return {"plain": plain, "antibody": ab, "antibody without masks": bare}


def assert_loaded_equal(ref, got, host):
    assert type(ref).__name__ == type(got).__name__
    for k in ("xyz", "atom_mask", "chain_idx", "residue_idx", "mu", "std"):
        a, b = getattr(ref, k), getattr(got, k)
        assert (a is None) == (b is None), k
        if a is not None:
            a, b = host(a), host(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k  # bitwise
    for k in ("chain_ids", "seq", "standardized"):
        assert getattr(ref, k) == getattr(got, k), k
    if hasattr(ref, "heavy_chain_id"):
        for k in ("heavy_chain_id", "light_chain_id", "antigen_chain_ids", "numbering_scheme",
                  "keep_fv_only"):
            assert getattr(ref, k) == getattr(got, k), k
        ref_m, got_m = ref.residue_masks or {}, got.residue_masks or {}
        assert sorted(ref_m) == sorted(got_m)
        for k in ref_m:
            np.testing.assert_array_equal(host(ref_m[k]), host(got_m[k]), err_msg=k)


def to_host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_batch(jb):
    tb = port_of(jb)
    if not hasattr(jb, "heavy_chain_id"):
        return tb
    masks = None if jb.residue_masks is None else {
        k: torch.from_numpy(np.asarray(v)) for k, v in jb.residue_masks.items()}
    return AntibodyStructureBatch(
        xyz=tb.xyz, atom_mask=tb.atom_mask, chain_idx=tb.chain_idx, residue_idx=tb.residue_idx,
        chain_ids=jb.chain_ids, seq=jb.seq, residue_masks=masks,
        heavy_chain_id=jb.heavy_chain_id, light_chain_id=jb.light_chain_id,
        antigen_chain_ids=jb.antigen_chain_ids, numbering_scheme=jb.numbering_scheme,
        keep_fv_only=jb.keep_fv_only)


@pytest.mark.parametrize("suffix", [".npz", ".bin"])
def test_files_load_across_packages(tmp_path, suffix):
    for label, jb in jax_batches().items():
        tb = port_batch(jb)
        assert_loaded_equal(jb, tb, to_host)
        jax_ser.save_structure_batch(jb, str(tmp_path / f"jax{suffix}"))
        got = serialization.load_structure_batch(str(tmp_path / f"jax{suffix}"), device=DEVICE)
        assert got.xyz.device.type == DEVICE
        assert_loaded_equal(jb, got, to_host)
        serialization.save_structure_batch(tb, str(tmp_path / f"port{suffix}"))
        assert_loaded_equal(tb, jax_ser.load_structure_batch(str(tmp_path / f"port{suffix}")),
                            to_host)
        buf = io.BytesIO()
        serialization.save_structure_batch(tb, buf)
        buf.seek(0)
        assert_loaded_equal(tb, serialization.load_structure_batch(buf, device=DEVICE), to_host)


# -- checks ---------------------------------------------------------------------------

def malformed():
    """Each problem validate_batch reports, as JAX batches."""
    xyz = np.zeros((1, 6, 15, 3), np.float32)
    am = np.zeros((1, 6, 15), bool)
    am[0, :3] = True
    pad = JaxSB.from_xyz(xyz, am)
    sb = JaxSB.from_pdb(pdb_path("1ad0_DC.pdb"))
    return [
        sb,
        sb.standardize(),
        pad.replace(chain_idx=pad.chain_idx.at[0, 4].set(-2),
                    residue_idx=pad.residue_idx.at[0, 5].set(99)),
        sb.replace(atom_mask=jnp.ones_like(sb.atom_mask)),
        sb.replace(chain_idx=jnp.where(sb.chain_idx >= 0, sb.chain_idx + 1, -1)),
        sb.replace(chain_idx=jnp.where(sb.chain_idx >= 0, 1 - sb.chain_idx, -1)),
        sb.replace(standardized=True),
        sb.standardize().replace(standardized=False),
    ]


def test_validate_batch_equals_jax():
    n_bad = 0
    for jb in malformed():
        ref = jax_checks.validate_batch(jb, raise_on_error=False)
        tb = port_of(jb)
        got = checks.validate_batch(tb, raise_on_error=False)
        assert got == ref
        if ref:
            n_bad += 1
            with pytest.raises(checks.BatchValidationError) as e:
                checks.validate_batch(tb)
            assert e.value.problems == ref
        else:
            assert checks.validate_batch(tb) == []
    assert n_bad == 6
    tb = port_of(malformed()[0])
    bad = StructureBatch(xyz=tb.xyz, atom_mask=tb.atom_mask[:, :-1], chain_idx=tb.chain_idx,
                         residue_idx=tb.residue_idx[:, :, None])
    ref = jax_checks.validate_batch(JaxSB(xyz=jnp.asarray(tb.xyz.numpy()),
                                          atom_mask=jnp.asarray(bad.atom_mask.numpy()),
                                          chain_idx=jnp.asarray(tb.chain_idx.numpy()),
                                          residue_idx=jnp.asarray(bad.residue_idx.numpy())),
                                    raise_on_error=False)
    assert checks.validate_batch(bad, raise_on_error=False) == ref and len(ref) == 2


# -- compat, shims, re-exports ---------------------------------------------------------

def test_with_array_echoes_numpy():
    from protstruc_tpu_torch import geometry

    rng = np.random.RandomState(0)
    pts = [rng.randn(7, 3).astype(np.float32) for _ in range(4)]
    dihedral = compat.with_array(geometry.dihedral, device=DEVICE)
    out = dihedral(*pts)
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, np.asarray(jax_compat.geometry.dihedral(*pts)), atol=1e-5)
    deg = dihedral(np.array([[1.0, 0, 0]], np.float32), np.zeros((1, 3), np.float32),
                   np.array([[0.0, 1, 0]], np.float32), np.array([[0.0, 1, 1]], np.float32),
                   to_degree=True)
    np.testing.assert_allclose(deg, [-90.0], atol=1e-4)
    # a tensor anywhere (positional or keyword) gives tensors on its device
    t = dihedral(torch.from_numpy(pts[0]), *pts[1:])
    assert isinstance(t, torch.Tensor) and t.device.type == DEVICE
    np.testing.assert_array_equal(t.numpy(), out)
    kw = dihedral(*pts[:3], d=torch.from_numpy(pts[3]))
    assert isinstance(kw, torch.Tensor)
    assert isinstance(compat.geometry.dihedral(torch.from_numpy(pts[0]), *pts[1:]), torch.Tensor)
    # tuple outputs convert too
    r, tr = compat.with_array(geometry.kabsch, device=DEVICE)(pts[0], pts[1])
    assert isinstance(r, np.ndarray) and isinstance(tr, np.ndarray)
    jr, jt = jax_compat.geometry.kabsch(pts[0], pts[1])
    np.testing.assert_allclose(r, jr, atol=1e-5)
    np.testing.assert_allclose(tr, jt, atol=1e-5)

    @compat.with_array(device=DEVICE)
    def pair(a, b):
        return {"sum": a + b, "parts": [a, (b,)]}

    out = pair(pts[0], pts[1])
    assert isinstance(out["sum"], np.ndarray) and isinstance(out["parts"][1][0], np.ndarray)
    if not torch.cuda.is_available():  # NumPy alone goes to the card by default
        with pytest.raises(RuntimeError, match="cuda"):
            compat.geometry.dihedral(*pts)


def test_shims_and_reexports_resolve():
    from protstruc_tpu_torch import alphabet, decorator, general
    from protstruc_tpu_torch import geometry
    from protstruc_tpu_torch import io as port_io
    from protstruc_tpu_torch.ops import reconstruct
    from protstruc_tpu_torch.pdbio import writer

    from protstruc_tpu import alphabet as jax_alphabet

    assert alphabet.three2one == jax_alphabet.three2one
    assert alphabet.one2three == jax_alphabet.one2three
    assert decorator.with_tensor is compat.with_array is decorator.with_array
    assert port_io.to_pdb is writer.to_pdb
    assert port_io.structure_batch_to_pdb is writer.structure_batch_to_pdb
    for name in ("non_standard_residue_substitutions", "resindex_to_oneletter",
                 "ressymb_to_resindex", "standard_aa_names", "standard_heavy_atom_names",
                 "CDR_NAMES"):
        assert getattr(general, name) == getattr(jax_general, name), name
    assert [a.name for a in general.AA] == [a.name for a in jax_general.AA]
    assert [a.name for a in general.ATOM] == [a.name for a in jax_general.ATOM]
    for name in ("reconstruct_backbone_distmat_from_interresidue_geometry",
                 "initialize_backbone_with_mds"):
        assert getattr(geometry, name) is getattr(reconstruct, name)
        assert name in geometry.__all__ and hasattr(compat.geometry, name)
    with pytest.raises(AttributeError):
        geometry.no_such_function


# -- profiling ------------------------------------------------------------------------

def test_trace_in_profile_and_timer(tmp_path):
    from protstruc_tpu_torch.ops.pair_maps import pairwise_maps

    x = torch.from_numpy(np.random.RandomState(0).randn(1, 9, 15, 3).astype(np.float32))
    with profiling.profile_to(str(tmp_path)):
        with profiling.trace("featurize"):
            maps = pairwise_maps(x)
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "featurize" in names
    with profiling.Timer("t") as t:
        assert t.block(maps) is maps
    assert t.elapsed is not None and t.elapsed >= 0
