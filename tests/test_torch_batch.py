"""Port StructureBatch vs the JAX package on the CPU.

* ``from_pdb``: xyz with identical NaN positions and 1e-6 elsewhere,
  ``atom_mask``/``chain_idx``/``residue_idx`` bitwise;
* ``inter_residue_geometry(use_kernel=False)`` (the arccos-form port of the
  jnp path) vs ``protstruc_tpu.batch._inter_residue_geometry``: 1e-5 abs,
  masks bitwise;
* masks, lengths and getters bitwise; ``convert`` round trips; asking for a
  CUDA device without CUDA raises.
"""

import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.batch import _inter_residue_geometry as jax_inter_residue_geometry
from protstruc_tpu_torch import StructureBatch
from protstruc_tpu_torch.convert import structure_batch_from_numpy, to_numpy
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

PDBS = {
    "1REX": ["1REX.pdb"],
    "1ad0_DC": ["1ad0_DC.pdb"],
    "mixed": ["1REX.pdb", "1ad0_DC.pdb", "4EOT.pdb"],
}


def _pair(name):
    paths = [pdb_path(p) for p in PDBS[name]]
    return JaxBatch.from_pdb(paths), StructureBatch.from_pdb(paths, device=DEVICE)


@pytest.mark.parametrize("name", sorted(PDBS))
def test_from_pdb_matches_jax(name):
    sbj, sbt = _pair(name)
    assert sbt.device == torch.device("cpu")
    assert sbt.xyz.dtype == torch.float32 and sbt.chain_idx.dtype == torch.int32
    assert_parity(sbj.xyz, sbt.xyz, 1e-6, "xyz")
    for field in ("atom_mask", "chain_idx", "residue_idx"):
        np.testing.assert_array_equal(as_numpy(getattr(sbj, field)),
                                      as_numpy(getattr(sbt, field)), err_msg=field)
    assert sbt.get_chain_ids() == sbj.get_chain_ids()
    assert sbt.get_seq() == sbj.get_seq()


@pytest.mark.parametrize("name", sorted(PDBS))
def test_masks_and_lengths_match_jax(name):
    sbj, sbt = _pair(name)
    for getter in ("get_n_terminal_mask", "get_c_terminal_mask",
                   "get_residue_mask", "get_total_lengths", "get_seq_idx"):
        np.testing.assert_array_equal(as_numpy(getattr(sbj, getter)()),
                                      as_numpy(getattr(sbt, getter)()), err_msg=getter)
    np.testing.assert_array_equal(as_numpy(sbj.residue_mask), as_numpy(sbt.residue_mask))
    assert (sbt.batch_size, sbt.n_residues, sbt.max_n_atoms_per_residue) == sbj.xyz.shape[:3]


@pytest.mark.parametrize("name", ["random", "1REX", "mixed"])
def test_inter_residue_geometry_jnp_twin_matches_jax(name):
    if name == "random":
        rng = np.random.RandomState(4)
        xyz = (rng.randn(2, 48, 15, 3) * 5).astype(np.float32)
        am = rng.rand(2, 48, 15) > 0.05
        xyz[~am] = np.nan
        sbt = StructureBatch.from_xyz(xyz, am, device=DEVICE)
    else:
        sbj, sbt = _pair(name)
        xyz, am = np.asarray(sbj.xyz), np.asarray(sbj.atom_mask)
    ref = jax_inter_residue_geometry(xyz, am)
    out = sbt.inter_residue_geometry(use_kernel=False)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert_parity(ref[k], out[k], 1e-5, k)


def test_from_xyz_defaults_and_validation():
    xyz = np.random.RandomState(5).randn(2, 6, 15, 3)
    sbj = JaxBatch.from_xyz(xyz)
    sbt = StructureBatch.from_xyz(torch.from_numpy(xyz), device=DEVICE)
    for field in ("xyz", "atom_mask", "chain_idx", "residue_idx"):
        np.testing.assert_array_equal(as_numpy(getattr(sbj, field)),
                                      as_numpy(getattr(sbt, field)), err_msg=field)
    with pytest.raises(ValueError, match="should be provided"):
        StructureBatch.from_xyz(xyz, chain_idx=np.zeros((2, 6)), device=DEVICE)
    with pytest.raises(ValueError, match="start from zero"):
        StructureBatch.from_xyz(xyz, chain_idx=np.ones((2, 6)), chain_ids=[["A"]] * 2,
                                device=DEVICE)


def test_convert_round_trip():
    sbj, _ = _pair("mixed")
    arrays = {k: np.asarray(getattr(sbj, k))
              for k in ("xyz", "atom_mask", "chain_idx", "residue_idx")}
    sbt = structure_batch_from_numpy(**arrays, chain_ids=sbj.chain_ids, seq=sbj.seq,
                                     device=DEVICE)
    back = to_numpy(sbt)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    assert back["chain_ids"] == sbj.chain_ids and back["seq"] == sbj.seq
    again = to_numpy(structure_batch_from_numpy(**back, device=DEVICE))
    np.testing.assert_array_equal(again["xyz"], arrays["xyz"])


def test_to_returns_new_batch():
    _, sbt = _pair("1REX")
    moved = sbt.to("cpu")
    assert moved is not sbt and moved.device == torch.device("cpu")
    assert torch.equal(moved.chain_idx, sbt.chain_idx)


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, sbt = _pair("1REX")
    with pytest.raises(RuntimeError, match="cuda"):
        sbt.to("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        StructureBatch.from_pdb(pdb_path("1REX.pdb"), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        StructureBatch.from_xyz(np.zeros((1, 3, 15, 3)), device="cuda")
