"""The port's host layer vs the JAX package's on the CPU: the C++ scanner,
cache-first fetching and ``from_pdb_id``, SS annotations, the ``PDB``
wrappers, the parsed-structure cache.

Everything here is compared exactly: the C++ scanner's records and full
parses against the JAX package's NumPy scanner (coordinates bitwise, NaN
where an atom is absent), the fetched batches field for field, the SS
classes, the wrappers' getters and masks.  The scanner tests skip only where
there is no ``g++``.  No test touches the network: ``urlopen`` is patched.
"""

import contextlib
import io
import json
import pathlib
import shutil
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from protstruc_tpu import AntibodyStructureBatch as JaxAb
from protstruc_tpu import StructureBatch as JaxSB
from protstruc_tpu.pdbio import annotations as jax_ann
from protstruc_tpu.pdbio import parser as jax_parser
from protstruc_tpu.pdbio import pdb as jax_pdb
from protstruc_tpu_torch import AntibodyStructureBatch, StructureBatch
from protstruc_tpu_torch.pdbio import annotations, dataset, fetch, native, parser, pdb
from tests.conftest import DATA_DIR, pdb_path

torch.set_num_threads(1)

DEVICE = "cpu"
FIXTURES = ["1ad0_DC.pdb", "6dc4.pdb", "1REX.pdb", "4EOT.pdb", "15c8_HL.pdb"]
FIELDS = ("atom_name", "altloc", "res_name", "chain_id", "res_num", "icode", "xyz")
PARSED = ("atom_xyz", "atom_mask", "chain_idx", "residue_idx", "chain_id_per_res",
          "residue_number", "insertion", "oneletter")


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the C++ scanner")


def assert_parsed_equal(ref, got):
    for k in PARSED:
        a, b = getattr(ref, k), getattr(got, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)  # NaN == NaN here
    assert ref.chain_order == got.chain_order


@pytest.mark.parametrize("name", FIXTURES)
def test_native_records_and_parse_equal_jax_numpy(name, gxx):
    data = jax_parser._read_bytes(pdb_path(name))
    ref = jax_parser._parse_atom_records(jax_parser._read_model1_lines(data))
    calls = native.CALLS
    got = native.parse_atom_records_native(data)
    assert native.CALLS == calls + 1
    for k in FIELDS:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["xyz"].tobytes() == ref["xyz"].tobytes()  # bitwise
    assert_parsed_equal(jax_parser.parse_pdb(pdb_path(name), use_native=False),
                        parser.parse_pdb(pdb_path(name), use_native=True))
    assert native.CALLS == calls + 2


def test_native_negative_numbers_and_first_model_only(gxx):
    text = (
        "MODEL        1\n"
        "ATOM      1  N   ALA A  -2       1.000   2.000  -3.500  1.00  0.00\n"
        "ATOM      2  CA  ALA A  -2       2.458   0.000   0.000  1.00  0.00\n"
        "ENDMDL\n"
        "MODEL        2\n"
        "ATOM      3  N   GLY A   1       9.000   9.000   9.000  1.00  0.00\n"
        "ENDMDL\n"
    ).encode()
    got = native.parse_atom_records_native(text)
    ref = jax_parser._parse_atom_records(jax_parser._read_model1_lines(text))
    assert got["res_num"].tolist() == [-2, -2]
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(ValueError, match="no ATOM/HETATM records"):
        parser.parse_pdb(io.BytesIO(b"HEADER    nothing\n"), use_native=True)


def test_no_native_env_takes_numpy(monkeypatch, gxx):
    monkeypatch.setenv("PROTSTRUC_TPU_NO_NATIVE", "1")
    calls = native.CALLS
    got = parser.parse_pdb(pdb_path("1REX.pdb"))
    assert native.CALLS == calls
    assert_parsed_equal(jax_parser.parse_pdb(pdb_path("1REX.pdb"), use_native=False), got)


def test_failed_build_raises(monkeypatch, tmp_path, gxx):
    bad = tmp_path / "pdb_parser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load_native()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        parser.parse_pdb(pdb_path("1REX.pdb"))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_without_gxx_numpy_scans_and_info_says_so(monkeypatch, tmp_path, capsys):
    from protstruc_tpu_torch.__main__ import main

    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert native.load_native() is None and not native.native_available()
    calls = native.CALLS
    assert_parsed_equal(jax_parser.parse_pdb(pdb_path("6dc4.pdb"), use_native=False),
                        parser.parse_pdb(pdb_path("6dc4.pdb")))
    assert native.CALLS == calls
    assert main(["info"]) == 0
    assert json.loads(capsys.readouterr().out)["native_parser"] is False


# -- fetching -------------------------------------------------------------------

@pytest.fixture
def isolated_cache(monkeypatch, tmp_path):
    """An empty cache directory, and HOME inside tmp."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("PROTSTRUC_TPU_PDB_CACHE", str(cache))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return cache


@pytest.fixture
def served(monkeypatch):
    """``urlopen`` serving {file name: bytes}; records the URLs asked for."""
    files, calls = {}, []

    @contextlib.contextmanager
    def fake_urlopen(url, timeout=None):
        calls.append(url)
        name = url.rsplit("/", 1)[-1]
        if name not in files:
            raise urllib.error.URLError(f"no fixture for {name}")
        yield io.BytesIO(files[name])

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    return files, calls


def test_cache_hit_never_calls_urlopen(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("network touched on a cache hit")

    monkeypatch.setattr(urllib.request, "urlopen", boom)
    for pid in ("1REX", "1rex", "6dc4"):
        path = pathlib.Path(fetch.fetch_pdb(pid))
        assert path.parent == DATA_DIR and path.stem.lower() == pid.lower()
    assert fetch.cache_dirs()[0] == DATA_DIR


def test_download_writes_the_cache_then_hits_it(isolated_cache, served):
    files, calls = served
    files["1REX.pdb"] = (DATA_DIR / "1REX.pdb").read_bytes()
    path = pathlib.Path(fetch.fetch_pdb("1rex"))
    assert calls == ["https://files.rcsb.org/download/1REX.pdb"]
    assert fetch.cache_dirs()[-1] in path.parents
    assert path.read_bytes() == files["1REX.pdb"]
    assert fetch.fetch_pdb("1REX") == str(path) and len(calls) == 1


def test_cif_fallback(isolated_cache, served, tmp_path):
    from protstruc_tpu_torch.pdbio.writer import structure_batch_to_cif

    files, calls = served
    sb = StructureBatch.from_pdb(pdb_path("1REX.pdb"), device=DEVICE)
    structure_batch_to_cif(sb, str(tmp_path / "1rex.cif"))
    files["9ZZZ.cif"] = (tmp_path / "1rex.cif").read_bytes()
    got = StructureBatch.from_pdb_id("9zzz", device=DEVICE)
    assert [u.rsplit("/", 1)[-1] for u in calls] == ["9ZZZ.pdb", "9ZZZ.cif"]
    assert got.n_residues == sb.n_residues
    np.testing.assert_array_equal(got.atom_mask.numpy(), sb.atom_mask.numpy())


def test_missing_entry_raises_actionable_error(isolated_cache, served):
    with pytest.raises(IOError, match="PROTSTRUC_TPU_PDB_CACHE"):
        fetch.fetch_pdb("0XXX")
    assert len(served[1]) == 2


# -- from_pdb_id ------------------------------------------------------------------

def assert_batch_equal(ref, got):
    for k in ("xyz", "atom_mask", "chain_idx", "residue_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, k)), getattr(got, k).numpy(),
                                      err_msg=k)
    assert got.chain_ids == ref.chain_ids and got.seq == ref.seq
    assert got.xyz.device.type == DEVICE


def test_from_pdb_id_equals_jax():
    ids = ["1REX", "6dc4", "1ad0_DC"]
    assert_batch_equal(JaxSB.from_pdb_id(ids), StructureBatch.from_pdb_id(ids, device=DEVICE))
    assert_batch_equal(JaxSB.from_pdb_id("4EOT"), StructureBatch.from_pdb_id("4EOT", device=DEVICE))
    for kw in ({}, {"keep_fv_only": True, "numbering_scheme": "kabat"}):
        ref = JaxAb.from_pdb_id(["6dc4", "15c8_HL"], "H", "L", **kw)
        got = AntibodyStructureBatch.from_pdb_id(["6dc4", "15c8_HL"], "H", "L", device=DEVICE,
                                                 **kw)
        assert_batch_equal(ref, got)
        assert sorted(got.residue_masks) == sorted(ref.residue_masks)
        for k, v in ref.residue_masks.items():
            np.testing.assert_array_equal(np.asarray(v), got.residue_masks[k].numpy(), err_msg=k)
        for k in ("heavy_chain_id", "light_chain_id", "antigen_chain_ids", "numbering_scheme",
                  "keep_fv_only"):
            assert getattr(got, k) == getattr(ref, k), k


# -- annotations and the PDB wrappers ----------------------------------------------

@pytest.mark.parametrize("name", ["1REX.pdb", "4EOT.pdb"])
def test_ss_annotations_equal_jax(name):
    ref = jax_ann.parse_ss_records(pdb_path(name))
    got = annotations.parse_ss_records(pdb_path(name))
    assert ref and [vars(r) for r in got] == [vars(r) for r in ref]
    with open(pdb_path(name), "rb") as f:
        assert annotations.parse_ss_records(f) == got
    p = parser.parse_pdb(pdb_path(name))
    for alpha_only in (False, True):
        np.testing.assert_array_equal(
            annotations.author_ss_classes(got, p.chain_id_per_res, p.residue_number, alpha_only),
            jax_ann.author_ss_classes(ref, p.chain_id_per_res, p.residue_number, alpha_only))


def assert_parsed_same(ref, got):
    for k in PARSED:
        np.testing.assert_array_equal(getattr(ref, k), getattr(got, k), err_msg=k)
    assert ref.chain_order == got.chain_order


@pytest.mark.parametrize("name,heavy,light,antigen", [("6dc4.pdb", "H", "L", None),
                                                      ("15c8_HL.pdb", "H", "L", None),
                                                      ("4EOT.pdb", "A", None, "B")])
def test_pdb_wrappers_equal_jax(name, heavy, light, antigen):
    ref, got = jax_pdb.PDB.read_pdb(pdb_path(name)), pdb.PDB.read_pdb(pdb_path(name))
    for getter in ("get_chain_idx", "get_residue_idx", "get_seq_idx"):
        np.testing.assert_array_equal(getattr(ref, getter)(), getattr(got, getter)(), err_msg=getter)
    for a, b in zip(ref.get_atom_xyz(), got.get_atom_xyz()):
        np.testing.assert_array_equal(a, b)
    for getter in ("get_chain_ids", "get_seq", "get_seq_dict"):
        assert getattr(ref, getter)() == getattr(got, getter)(), getter
    for fv in (False, True):
        ref = jax_pdb.ChothiaAntibodyPDB.read_pdb(pdb_path(name), heavy, light, antigen, fv)
        got = pdb.ChothiaAntibodyPDB.read_pdb(pdb_path(name), heavy, light, antigen, fv)
        assert got.n_residues == ref.n_residues
        for getter in ("get_heavy_chain_mask", "get_light_chain_mask", "get_antigen_mask",
                       "get_fv_mask"):
            np.testing.assert_array_equal(getattr(ref, getter)(), getattr(got, getter)(),
                                          err_msg=getter)
        for subset in (None, "H3", ["L1", "l2"]):
            np.testing.assert_array_equal(ref.get_cdr_mask(subset), got.get_cdr_mask(subset))
        for getter in ("get_heavy_chain_structure", "get_light_chain_structure"):
            assert_parsed_same(getattr(ref, getter)(), getattr(got, getter)())
        if antigen:
            assert_parsed_same(ref.get_antigen_chains_structure(), got.get_antigen_chains_structure())
        else:
            assert got.get_antigen_chains_structure() is None
        with pytest.raises(ValueError, match="CDR H4 is not valid"):
            got.get_cdr_mask("H4")


# -- the parsed-structure cache ------------------------------------------------------

def test_parsed_cache_counts_and_clears():
    dataset.clear_parsed_cache()
    before = dataset.parsed_cache_stats()
    assert before["entries"] == 0 and before["bytes"] == 0
    paths = [pdb_path("1REX.pdb"), pdb_path("4EOT.pdb")]
    ds = dataset.StructureDataset(paths * 2, batch_size=2, device=DEVICE, n_workers=1)
    assert sum(b.batch_size for b in ds) == 4
    s = dataset.parsed_cache_stats()
    assert s["misses"] - before["misses"] == 2 and s["hits"] - before["hits"] == 2
    assert s["entries"] == 2 and s["bytes"] > 0
    assert 0 < s["hit_rate"] <= 1
    dataset.clear_parsed_cache()
    s2 = dataset.parsed_cache_stats()
    assert s2["entries"] == 0 and s2["bytes"] == 0 and s2["hits"] == s["hits"]


def test_abandoned_epoch_joins_its_producer():
    paths = [pdb_path("1REX.pdb"), pdb_path("4EOT.pdb")] * 6
    ds = dataset.StructureDataset(paths, batch_size=1, device=DEVICE, prefetch=1)
    for _ in ds:
        break
    assert not [t for t in threading.enumerate()
                if t.name == dataset.PRODUCER_THREAD and t.is_alive()]
