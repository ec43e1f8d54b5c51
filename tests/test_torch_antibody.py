"""The port's AntibodyStructureBatch vs the JAX package's on the CPU.

Everything here is compared bitwise (coordinates included: both parse the
same file): the batch's tensors, the nine named residue masks, the chain-role
metadata and the mask accessors (CDR unions, anchor masks), for 6dc4 (H/L,
437 residues) in every scheme, with scheme conversion (``source_scheme``
auto, explicit and None), Fv trimming, several files in one batch, and an
antigen chain; the wrong-scheme warning text; ``residue_compact``'s
reordered masks; ``utils/buckets`` padding and concatenation of antibody
batches; ``convert``'s antibody form.
"""

import warnings

import numpy as np
import pytest
import torch

from protstruc_tpu import AntibodyStructureBatch as JaxAb
from protstruc_tpu.utils import buckets as jax_buckets
from protstruc_tpu_torch.antibody import NUMBERING_SCHEMES, AntibodyStructureBatch
from protstruc_tpu_torch.convert import structure_batch_from_numpy, to_numpy
from protstruc_tpu_torch.utils import buckets
from tests.conftest import pdb_path
from tests.test_torch_batch_api import port_of
from tests.test_torch_parity import DEVICE, as_numpy

torch.set_num_threads(1)

META = ("heavy_chain_id", "light_chain_id", "antigen_chain_ids", "numbering_scheme",
        "keep_fv_only", "chain_ids", "seq", "standardized")


def assert_same(ref, got):
    for k in ("xyz", "atom_mask", "chain_idx", "residue_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, k)), as_numpy(getattr(got, k)),
                                      err_msg=k)
    assert sorted(got.residue_masks) == sorted(ref.residue_masks)
    for k, v in ref.residue_masks.items():
        np.testing.assert_array_equal(np.asarray(v), as_numpy(got.residue_masks[k]), err_msg=k)
    for k in META:
        assert getattr(got, k) == getattr(ref, k), k


def _both(paths, *args, **kw):
    """(JAX batch, port batch, JAX warnings, port warnings) of one from_pdb call."""
    out = []
    for cls, extra in ((JaxAb, {}), (AntibodyStructureBatch, {"device": DEVICE})):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            out.append((cls.from_pdb(paths, *args, **kw, **extra),
                        [str(x.message) for x in w]))
    (ref, w_ref), (got, w_got) = out
    assert w_got == w_ref
    return ref, got, w_got


CASES = {
    "chothia": ("6dc4.pdb", dict(heavy_chain_id="H", light_chain_id="L")),
    "kabat": ("6dc4.pdb", dict(heavy_chain_id="H", light_chain_id="L",
                                numbering_scheme="kabat")),
    "imgt_auto": ("6dc4.pdb", dict(heavy_chain_id="H", light_chain_id="L",
                                    numbering_scheme="imgt")),
    "imgt_explicit": ("15c8_HL.pdb", dict(heavy_chain_id="H", light_chain_id="L",
                                           numbering_scheme="imgt", source_scheme="chothia")),
    "imgt_as_is_warns": ("6dc4.pdb", dict(heavy_chain_id="H", light_chain_id="L",
                                           numbering_scheme="imgt", source_scheme=None)),
    "fv_only": ("6dc4.pdb", dict(heavy_chain_id="H", light_chain_id="L", keep_fv_only=True,
                                  source_scheme=None)),
    "fv_only_converted": ("6dc4.pdb", dict(heavy_chain_id="H", light_chain_id="L",
                                            keep_fv_only=True, numbering_scheme="imgt")),
    "heavy_only": ("1a3r_HL.pdb", dict(heavy_chain_id="H", light_chain_id=float("nan"))),
    "antigen": ("8dtk.pdb", dict(heavy_chain_id="A", light_chain_id="B",
                                  antigen_chain_ids=["C"])),
    "batch": (["15c8_HL.pdb", "5cjx_HL.pdb", "1a6v_HL.pdb"],
              dict(heavy_chain_id=["H", "H", "H"], light_chain_id="L")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_pdb_matches_jax(case):
    files, kw = CASES[case]
    paths = [pdb_path(f) for f in files] if isinstance(files, list) else pdb_path(files)
    ref, got, warned = _both(paths, **kw)
    assert isinstance(got, AntibodyStructureBatch) and got.device == torch.device(DEVICE)
    assert_same(ref, got)
    assert bool(warned) == (case in ("imgt_as_is_warns", "antigen"))
    for subset in (None, "H3", ["L1", "l2"], ["H1", "H2", "H3"]):
        np.testing.assert_array_equal(np.asarray(ref.get_cdr_mask(subset)),
                                      as_numpy(got.get_cdr_mask(subset)), err_msg=str(subset))
        np.testing.assert_array_equal(np.asarray(ref.get_cdr_anchor_mask(subset)),
                                      as_numpy(got.get_cdr_anchor_mask(subset)))
    for getter in ("get_heavy_chain_mask", "get_light_chain_mask", "get_antigen_mask",
                   "get_fv_mask", "get_residue_idx", "get_n_terminal_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, getter)()),
                                      as_numpy(getattr(got, getter)()), err_msg=getter)
    for getter in ("get_heavy_chain_id", "get_light_chain_id", "get_antigen_chain_ids",
                   "is_fv_only"):
        assert getattr(got, getter)() == getattr(ref, getter)(), getter


def test_errors_match_jax():
    path = pdb_path("6dc4.pdb")
    for kw in (dict(numbering_scheme="martin"), dict(source_scheme="martin"),
               dict(heavy_chain_id=["H", "H"])):
        with pytest.raises(ValueError) as ref:
            JaxAb.from_pdb([path] * 3, **{"heavy_chain_id": "H", **kw})
        with pytest.raises(ValueError) as got:
            AntibodyStructureBatch.from_pdb([path] * 3, **{"heavy_chain_id": "H", **kw},
                                            device=DEVICE)
        assert str(got.value) == str(ref.value)
    ab = AntibodyStructureBatch.from_pdb(path, "H", "L", device=DEVICE)
    with pytest.raises(ValueError, match="at least one CDR"):
        ab.get_cdr_mask([])
    with pytest.raises(ValueError, match="is not valid"):
        ab.get_cdr_anchor_mask(["H4"])
    # from_pdb_id resolves the cached entry (tests/conftest.py) as JAX's does
    assert_same(JaxAb.from_pdb_id("6dc4", "H", "L"),
                AntibodyStructureBatch.from_pdb_id("6dc4", "H", "L", device=DEVICE))
    assert sorted(NUMBERING_SCHEMES) == ["chothia", "imgt", "kabat"]


@pytest.mark.parametrize("keep", ["heavy", "cdrs", "random"])
def test_residue_compact_reorders_masks_as_jax(keep):
    ref, got, _ = _both(pdb_path("6dc4.pdb"), "H", "L")
    mask = {"heavy": np.asarray(ref.get_heavy_chain_mask()),
            "cdrs": np.asarray(ref.get_cdr_mask()),
            "random": np.random.RandomState(0).rand(1, ref.n_residues) < 0.5}[keep]
    assert_same(ref.residue_compact(mask), got.residue_compact(torch.from_numpy(mask)))


def test_buckets_pad_and_concat_antibody_batches():
    a_ref, a, _ = _both(pdb_path("6dc4.pdb"), "H", "L")
    b_ref, b, _ = _both([pdb_path("15c8_HL.pdb"), pdb_path("1a6v_HL.pdb")], "H", "L",
                        numbering_scheme="imgt")
    assert_same(jax_buckets.pad_batch_to_bucket(a_ref), buckets.pad_batch_to_bucket(a))
    ref = jax_buckets.concat_batches([a_ref, b_ref])
    got = buckets.concat_batches([a, b])
    assert got.n_residues == 512 and got.batch_size == 3
    assert_same(ref, got)
    with pytest.raises(ValueError, match="antibody batches with plain"):
        buckets.concat_batches([a, port_of(a_ref)])


def test_convert_round_trip_antibody():
    ref, got, _ = _both(pdb_path("6dc4.pdb"), "H", "L", numbering_scheme="kabat")
    host = to_numpy(got)
    assert host["residue_masks"]["H3"].dtype == bool and host["numbering_scheme"] == "kabat"
    again = structure_batch_from_numpy(**host, device=DEVICE)
    assert isinstance(again, AntibodyStructureBatch)
    assert_same(ref, again)
    moved = again.to(DEVICE)
    assert_same(ref, moved)
    with pytest.raises(TypeError, match="unexpected"):
        structure_batch_from_numpy(**{k: v for k, v in host.items() if k != "residue_masks"},
                                   device=DEVICE)
