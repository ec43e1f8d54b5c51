"""K1 pair maps: the port's plain version vs the JAX package on the CPU.

* vs ``pairwise_maps_pallas(..., interpret=True)``, run as
  tests/test_pallas_pairwise.py runs it: 1e-5 abs on every map (the Pallas
  kernel's minimax atan2 is within 1.7e-6), identical NaN patterns, with
  degenerate probes (coincident atoms, GLY's missing CB, zero-coordinate
  padding residues);
* vs the jnp path (``_inter_residue_geometry``): 2e-4 on the angle maps, the
  waiver the JAX package uses between the two formulations (arccos vs atan2
  phi), 1e-5 on the distance maps, masks bitwise.

The CUDA kernel itself runs only on the card (``python3 chip_smoke.py``); on a
CPU tensor ``pairwise_maps`` takes the plain version.
"""

import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.batch import _inter_residue_geometry as jax_inter_residue_geometry
from protstruc_tpu.ops.pallas_pairwise import pairwise_maps_pallas
from protstruc_tpu_torch.ops import cuda_lib, pair_maps
from protstruc_tpu_torch.ops.pair_maps import (
    MAP_NAMES,
    _pair_maps_plain,
    pairwise_maps,
    trrosetta_features,
)
from tests.conftest import pdb_path
from tests.test_torch_parity import assert_parity

torch.set_num_threads(1)

DIST_MAPS = ("d_ca", "d_cb", "d_no")
MASKS = ("d_ca_mask", "d_cb_mask", "d_no_mask")


def _random(B, L, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, L, 15, 3) * 5).astype(np.float32)


def _degenerate(seed=2):
    """Random residues plus the configurations K1 pins or leaves NaN.

    Configurations the JAX package does not pin (one atom shared by two
    residues: a == c or b == d alone) are left out: there its value is
    decided by XLA's FMA contraction of an exactly cancelling cross product.
    """
    xyz = _random(1, 24, seed)
    xyz[0, 3, 4] = xyz[0, 3, 1]          # CB == CA (coincident in one residue)
    xyz[0, 5] = xyz[0, 9]                # a residue duplicated: pair fully coincident
    xyz[0, 7, 0] = xyz[0, 7, 1]          # N == CA
    xyz[0, 8, 4:] = np.nan               # GLY: no CB (NaN from the parser)
    xyz[0, 12] = xyz[0, 12, 1]           # a collapsed residue: all atoms at its CA
    xyz[0, 20:] = 0.0                    # zero-coordinate padding residues
    return xyz


def _pdb_xyz(name):
    paths = [pdb_path(p) for p in name.split("+")]
    return np.asarray(JaxBatch.from_pdb(paths if len(paths) > 1 else paths[0]).xyz)


INPUTS = {
    "random_L37": lambda: _random(2, 37, 0),
    "random_L64": lambda: _random(1, 64, 1),
    "degenerate": _degenerate,
    "1REX": lambda: _pdb_xyz("1REX.pdb"),
    "1ad0_DC": lambda: _pdb_xyz("1ad0_DC.pdb"),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_plain_matches_pallas_interpret(name):
    xyz = INPUTS[name]()
    ref = pairwise_maps_pallas(xyz, tile_i=64, tile_j=128, interpret=True)
    out = _pair_maps_plain(torch.from_numpy(xyz))
    assert tuple(out) == MAP_NAMES
    for k in MAP_NAMES:
        assert_parity(ref[k], out[k], 1e-5, k)


@pytest.mark.parametrize("name", ["random_L37", "1ad0_DC", "mixed"])
def test_plain_matches_jnp_path(name):
    if name == "mixed":  # two lengths padded into one batch (zero padding)
        sb = JaxBatch.from_pdb([pdb_path("1REX.pdb"), pdb_path("1ad0_DC.pdb")])
        xyz, am = np.asarray(sb.xyz), np.asarray(sb.atom_mask)
    else:
        xyz = INPUTS[name]()
        am = np.isfinite(xyz).all(-1)
    ref = jax_inter_residue_geometry(xyz, am)
    out = trrosetta_features(torch.from_numpy(xyz), torch.from_numpy(am))
    assert sorted(out) == sorted(ref)
    for k in ref:
        atol = 0 if k in MASKS else (1e-5 if k in DIST_MAPS else 2e-4)
        assert_parity(ref[k], out[k], atol, k)


def test_map_subset_and_cpu_dispatch():
    xyz = torch.from_numpy(_random(1, 20, 3))
    launches = pair_maps.LAUNCHES
    full = pairwise_maps(xyz)
    sub = pairwise_maps(xyz, maps=("phi", "d_cb"))
    assert tuple(sub) == ("phi", "d_cb")
    for k in sub:
        assert sub[k].shape == (1, 20, 20) and sub[k].dtype == torch.float32
        assert torch.equal(torch.isnan(sub[k]), torch.isnan(full[k]))
        assert torch.equal(sub[k].nan_to_num(), full[k].nan_to_num())
    assert pair_maps.LAUNCHES == launches  # CPU tensors never count as launches


def test_unknown_map_raises():
    with pytest.raises(ValueError, match="unknown maps"):
        pairwise_maps(torch.zeros(1, 4, 15, 3), maps=("d_ca", "chi"))


def test_kernel_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_lib, "_LIBS", {})
    with pytest.raises(RuntimeError, match="no nvcc"):
        pair_maps.load_library()
