"""Port geometry vs the JAX package on the CPU (tolerance: 1e-5 abs).

``geometry.dihedral/angle/gram_schmidt`` and ``_backbone_dihedrals`` of
``protstruc_tpu_torch`` against their ``protstruc_tpu`` counterparts, run under
``jax.jit`` as the JAX package runs them, on the same numpy inputs: NaN
patterns identical, masks bitwise.  Also: importing the port pulls in no JAX.
"""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu import geometry as jgeom
from protstruc_tpu.batch import _backbone_dihedrals as jax_backbone_dihedrals
from protstruc_tpu_torch import StructureBatch, geometry
from protstruc_tpu_torch.batch import _backbone_dihedrals
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, assert_parity

torch.set_num_threads(1)

ATOL = 1e-5


def _points(seed, n_points, shape=(3, 17)):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape, 3) * 5).astype(np.float32) for _ in range(n_points)]


def _probes():
    """Degenerate point sets: coincident, collinear, NaN (missing atom)."""
    o = np.zeros(3, np.float32)
    x = np.array([1.0, 0.0, 0.0], np.float32)
    y = np.array([0.0, 1.0, 0.0], np.float32)
    z = np.array([0.0, 1.0, 1.0], np.float32)
    nan = np.full(3, np.nan, np.float32)
    rows = [
        (x, o, y, z),        # reference sign convention: -pi/2
        (x, o, x, z),        # a == c
        (x, o, y, y),        # c == d (zero last bond)
        (x, x, y, z),        # a == b (zero first bond)
        (x, o, o, z),        # b == c (zero axis)
        (x, o, 2 * x, z),    # collinear a, b, c
        (-x, o, 2 * x, z),   # anti-parallel arms
        (nan, o, y, z),      # missing atom
        (o, o, o, o),        # zero-coordinate padding residue
    ]
    return [np.stack(col) for col in zip(*rows)]


FUNCS = {
    "dihedral": (jgeom.dihedral, geometry.dihedral, 4),
    "angle": (jgeom.angle, geometry.angle, 3),
    "gram_schmidt": (jgeom.gram_schmidt, geometry.gram_schmidt, 3),
}


@pytest.mark.parametrize("inputs", ["random", "probes"])
@pytest.mark.parametrize("fn", sorted(FUNCS))
def test_geometry_matches_jax(fn, inputs):
    jfn, tfn, n = FUNCS[fn]
    pts = _points(0, n) if inputs == "random" else _probes()[:n]
    ref = jax.jit(jfn)(*pts)
    out = tfn(*(torch.from_numpy(p) for p in pts))
    assert_parity(ref, out, ATOL, fn)


def _pdb_inputs(name):
    if name == "random":
        rng = np.random.RandomState(1)
        xyz = (rng.randn(2, 40, 15, 3) * 5).astype(np.float32)
        am = rng.rand(2, 40, 15) > 0.1
        xyz[~am] = np.nan
        ci = np.zeros((2, 40), np.int32)
        ci[0, 25:] = 1          # a chain break
        ci[1, 33:] = -1         # padding
        am[1, 33:] = False
        return xyz, am, ci
    paths = [pdb_path(p) for p in name.split("+")]
    sb = JaxBatch.from_pdb(paths if len(paths) > 1 else paths[0])
    return np.asarray(sb.xyz), np.asarray(sb.atom_mask), np.asarray(sb.chain_idx)


@pytest.mark.parametrize("name", ["random", "1REX.pdb", "1ad0_DC.pdb",
                                  "1REX.pdb+1ad0_DC.pdb"])
def test_backbone_dihedrals_match_jax(name):
    xyz, am, ci = _pdb_inputs(name)
    ref_d, ref_m = jax_backbone_dihedrals(xyz, ci, am)
    d, m = _backbone_dihedrals(torch.from_numpy(xyz), torch.from_numpy(ci),
                               torch.from_numpy(am))
    assert_parity(ref_d, d, ATOL, "dihedrals")
    assert_parity(ref_m, m, 0, "dihedral_mask")


def test_backbone_orientations_match_jax():
    sbj = JaxBatch.from_pdb(pdb_path("1ad0_DC.pdb"))
    sbt = StructureBatch.from_pdb(pdb_path("1ad0_DC.pdb"), device=DEVICE)
    assert_parity(sbj.backbone_orientations(), sbt.backbone_orientations(), ATOL)
    assert_parity(sbj.backbone_translations(), sbt.backbone_translations(), 0)


def test_import_pulls_in_no_jax():
    # every module of the package, and the card's smoke script
    # (the batch API's and the antibody batch's modules named, so that a
    # missing one fails here too)
    needed = ["protstruc_tpu_torch." + m for m in (
        "antibody", "numbering", "ops.nerf", "ops.diffusion", "ops.reconstruct",
        "utils.buckets", "convert")]
    code = ("import importlib, pkgutil, sys, chip_smoke, protstruc_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "protstruc_tpu_torch.__path__, 'protstruc_tpu_torch.')]; "
            f"missing = [m for m in {needed!r} if m not in sys.modules]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'protstruc_tpu')]; "
            "print(bad, missing); sys.exit(1 if bad or missing else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=pathlib.Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
