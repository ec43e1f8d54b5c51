"""K3, the fused model features: the port's plain version vs the Pallas kernel.

The JAX side is ``model_features_pallas(interpret=True)`` on the CPU, as the
JAX package's own tests run it; the port's side is ``model_features`` on a CPU
tensor, which takes the kernel's plain version (the CUDA kernel itself is held
to that plain version on the card by ``chip_smoke.py`` phase 10).

Inputs: two bundled PDBs, random ``B=2`` batches at ``L=37`` and ``L=130``
(``randn * 10``, numpy seeds), and degenerate probes (CB on CA, N on CA, a
duplicated residue, a collapsed residue, NaN atoms, a GLY without CB).
Tolerances: bins equal except where ``d_cb`` lies within 1e-3 A of a bin edge
(XLA contracts the distance's dot product into FMAs, the port rounds each
operation; such pairs are counted); float32 planes within 1e-5; bfloat16
planes within one bf16 ulp of the JAX value, values below 1e-4 taking the
ulp at 1e-4 (where cos theta cancels to ~1e-6 the two float32 planes already
differ by ~6e-8, 1% of the value, before the rounding to bf16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops.pallas_pairwise import model_features_pallas
from protstruc_tpu_torch import StructureBatch
from protstruc_tpu_torch.models import trfold
from protstruc_tpu_torch.ops import model_features as mf
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

EDGE = 1e-3  # angstroms
N_BINS, MAX_DIST = 36, 20.0


def _probes():
    xyz = (np.random.RandomState(2).randn(1, 24, 15, 3) * 5).astype(np.float32)
    xyz[0, 3, 4] = xyz[0, 3, 1]          # CB == CA
    xyz[0, 7, 0] = xyz[0, 7, 1]          # N == CA
    xyz[0, 5] = xyz[0, 9]                # a duplicated residue
    xyz[0, 12] = xyz[0, 12, 1]           # a collapsed residue
    xyz[0, 8, 4:] = np.nan               # GLY: no CB
    xyz[0, 15, :2] = np.nan              # missing N and CA
    xyz[0, 20:] = 0.0                    # zero-coordinate padding
    return xyz


def _xyz(name):
    if name.endswith(".pdb"):
        return np.asarray(JaxBatch.from_pdb(pdb_path(name)).xyz)
    if name == "probes":
        return _probes()
    L = int(name[1:])
    return (np.random.RandomState(L).randn(2, L, 15, 3) * 10).astype(np.float32)


def _near_edge(xyz):
    cb = xyz[:, :, 4].astype(np.float64)
    d = np.sqrt(((cb[:, :, None] - cb[:, None]) ** 2).sum(-1))
    width = MAX_DIST / N_BINS
    return np.abs(d / width - np.round(d / width)) * width < EDGE


def _bf16_ulp(x):
    a = np.maximum(np.abs(x.astype(np.float32)), 1e-4)
    return np.exp2(np.floor(np.log2(a)) - 7)


CASES = ["1REX.pdb", "1ad0_DC.pdb", "L37", "L130", "probes"]


@pytest.mark.parametrize("ang_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_plain_version_matches_pallas_kernel(name, ang_dtype):
    xyz = _xyz(name)
    rbins, rang = model_features_pallas(jnp.asarray(xyz), N_BINS, MAX_DIST, interpret=True,
                                        ang_dtype=getattr(jnp, ang_dtype))
    bins, ang = mf.model_features(torch.from_numpy(xyz), N_BINS, MAX_DIST,
                                  getattr(torch, ang_dtype))
    assert bins.dtype == torch.int32 and ang.dtype == getattr(torch, ang_dtype)
    rang = np.moveaxis(np.asarray(rang, np.float32), 1, -1)  # JAX: (B, 6, L, L)
    assert ang.shape == rang.shape == xyz.shape[:2] + xyz.shape[1:2] + (6,)

    off = as_numpy(bins) != np.asarray(rbins)
    near = _near_edge(xyz)
    assert not (off & ~near).any(), f"{int((off & ~near).sum())} bins differ away from an edge"
    assert off.sum() <= near.sum()

    got = as_numpy(ang.float())
    if ang_dtype == "float32":
        assert_parity(rang, got, 1e-5, name)
    else:
        assert (np.abs(got - rang) <= _bf16_ulp(rang)).all(), name


def test_pins_of_degenerate_pairs():
    """(sin, cos) = (0, 1) for a pinned omega/theta, (0, 0) where NaN."""
    xyz = _probes()
    _, ang = mf.model_features(torch.from_numpy(xyz), ang_dtype=torch.float32)
    ang = as_numpy(ang)
    np.testing.assert_array_equal(ang[0, 3, 10, 0:2], [0.0, 1.0])   # CA_i == CB_i: omega
    np.testing.assert_array_equal(ang[0, 7, 10, 2:4], [0.0, 1.0])   # N_i == CA_i: theta
    np.testing.assert_array_equal(ang[0, 5, 9, 0:4], [0.0, 1.0, 0.0, 1.0])  # duplicated residue
    np.testing.assert_array_equal(ang[0, 8, 10], np.zeros(6))      # GLY row: NaN CB
    np.testing.assert_array_equal(ang[0, 10, 8], np.zeros(6))
    sc = ang.reshape(-1, 3, 2)
    r = (sc ** 2).sum(-1)
    assert ((np.abs(r - 1) < 1e-5) | (r == 0)).all()  # unit or (0, 0)


def test_bins_follow_the_kernel_not_distogram_bins():
    """K3's bins are clip(int(d * f32(n_bins / max_dist))); NaN -> last bin."""
    cb = np.zeros((1, 4, 15, 3), np.float32)
    cb[0, :, 4, 0] = [0.0, 10.0, 19.9999, np.nan]
    bins, _ = mf.model_features(torch.from_numpy(cb))
    d = np.abs(cb[0, :, 4, 0][:, None] - cb[0, :, 4, 0][None])
    ratio = np.float32(N_BINS / MAX_DIST)
    want = np.where(np.isnan(d), N_BINS - 1,
                    np.minimum(np.nan_to_num(d * ratio), N_BINS - 1)).astype(np.int32)
    np.testing.assert_array_equal(as_numpy(bins[0]), want)


@pytest.mark.parametrize("name", ["1ad0_DC.pdb", "4EOT.pdb"])
def test_featurize_for_model_fused_matches_jax(name):
    ref = jtrfold.featurize_for_model(JaxBatch.from_pdb(pdb_path(name)), fused=True,
                                      ang_dtype=jnp.float32)
    out = trfold.featurize_for_model(StructureBatch.from_pdb(pdb_path(name), device=DEVICE),
                                     fused=True, ang_dtype=torch.float32)
    assert sorted(out) == sorted(ref)
    B, L = out["seq_idx"].shape
    assert out["ang_sincos"].shape == (B, L, L, 6)
    near = _near_edge(np.asarray(JaxBatch.from_pdb(pdb_path(name)).xyz))
    for k, r in ref.items():
        if k == "d_cb_bins":
            off = as_numpy(out[k]) != np.asarray(r)
            assert not (off & ~near).any(), k
        else:
            assert_parity(np.asarray(r), out[k], 1e-5, k)


def test_model_inputs_on_a_foreign_device_raises():
    with pytest.raises(ValueError, match="no implementation for device meta"):
        mf.model_features(torch.zeros((1, 4, 15, 3), device="meta"))
