"""The pair maps' gradient (K2's plain version, the autograd Function) vs the
JAX package on the CPU.

* ``_maps_bwd_plain`` against the jnp formulation's VJP (``jax.vjp`` of
  ``_maps_jnp``) and against the Pallas backward ``_maps_bwd_pallas`` in
  interpret mode, on the JAX tests' inputs (tests/test_pallas_pairwise.py:
  random, degenerate, a length no tile divides, a NaN residue):
  ``max|d| <= 1e-5 max(1, max|ref|)``, NaN patterns equal.
* ``pairwise_maps`` through autograd against ``jax.grad`` of the JAX
  ``pairwise_maps`` (custom VJP, Pallas backward in interpret mode), finite
  where JAX is finite; map subsets and ``None`` cotangents.
* ``trrosetta_features`` and ``inter_residue_geometry(use_kernel=True)`` are
  differentiable in ``xyz`` on the CPU.
* ``inter_residue_geometry()`` defaults to the arccos form, as the JAX
  package's does, and the ``featurize --pallas`` switch selects K1.

K2 itself runs only on the card (``python3 chip_smoke.py``, phases 14-16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.ops import pallas_pairwise as pp
from protstruc_tpu.vocab import ATOM
from protstruc_tpu_torch import StructureBatch
from protstruc_tpu_torch.__main__ import main
from protstruc_tpu_torch.ops import cuda_lib, pair_maps
from protstruc_tpu_torch.ops.pair_maps import (
    MAP_NAMES,
    _maps_bwd_plain,
    maps_bwd,
    pairwise_maps,
    trrosetta_features,
)
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, assert_parity

torch.set_num_threads(1)

MASKS = ("d_ca_mask", "d_cb_mask", "d_no_mask")


@jax.jit
def _jnp_vjp(xyz, g):
    return jax.vjp(pp._maps_jnp, xyz)[1](g)[0]


def _random(B, L, seed, scale=5.0):
    return (np.random.RandomState(seed).randn(B, L, 15, 3) * scale).astype(np.float32)


def _degenerate():
    xyz = _random(1, 24, 1)
    xyz[:, ::3, int(ATOM.CB)] = xyz[:, ::3, int(ATOM.CA)]  # glycine-like CB == CA
    xyz[:, 7] = xyz[:, 3]                                   # a duplicated residue
    return xyz


def _nan_residue():
    xyz = _random(1, 16, 3)
    xyz[:, 5, :4] = np.nan  # residue 5's backbone missing
    return xyz


# the inputs of tests/test_pallas_pairwise.py's backward tests, with their tiles
INPUTS = {
    "random": (lambda: _random(2, 50, 0), 64),
    "degenerate": (_degenerate, 32),
    "ragged_L37": (lambda: _random(1, 37, 2), 32),
    "nan_residue": (_nan_residue, 32),
}


def _cotangents(B, L, seed, maps=MAP_NAMES):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(B, L, L).astype(np.float32) for k in maps}


def assert_grad_parity(ref, out, name=""):
    """``max|d| <= 1e-5 max(1, max|ref|)`` where ``ref`` is finite, NaN patterns
    equal: the JAX package's gradient gate."""
    ref, out = np.asarray(ref), out.detach().numpy()
    scale = float(np.abs(ref[np.isfinite(ref)]).max(initial=0.0))
    assert_parity(ref, out, 1e-5 * max(1.0, scale), name)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_plain_backward_matches_jax(name):
    make, tile = INPUTS[name]
    xyz = make()
    B, L = xyz.shape[:2]
    g = _cotangents(B, L, seed=0)
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    got = _maps_bwd_plain(torch.from_numpy(xyz), {k: torch.from_numpy(v) for k, v in g.items()})
    assert got.shape == xyz.shape and got.dtype == torch.float32
    slots = [int(ATOM[a]) for a in ("N", "CA", "CB", "O")]
    others = np.setdiff1d(np.arange(15), slots)
    assert not got[:, :, others].any()  # exact zeros off the four atoms
    if name == "nan_residue":
        assert torch.isnan(got[:, 5]).any()
    else:
        assert torch.isfinite(got).all()
    assert_grad_parity(_jnp_vjp(jnp.asarray(xyz), jg), got, f"{name} vs jnp VJP")
    assert_grad_parity(pp._maps_bwd_pallas(jnp.asarray(xyz), jg, tile, tile, interpret=True),
                       got, f"{name} vs Pallas backward")


def test_pairwise_maps_gradient_matches_jax_grad():
    """Random (1, 24) residues (numpy seed 1, scale 5), loss the sum over the
    six maps of nansum: the Function's gradient is finite (autograd through
    the plain forward gave NaN at the i == j diagonal's sqrt(0) and
    atan2(0, 0)) and equals jax.grad of the JAX pairwise_maps."""
    xyz = _random(1, 24, 1)
    x = torch.from_numpy(xyz).requires_grad_()
    maps = pairwise_maps(x)
    assert all(v.grad_fn is not None for v in maps.values())
    (got,) = torch.autograd.grad(sum(torch.nansum(v) for v in maps.values()), x)
    assert torch.isfinite(got).all()

    def loss(x):
        return sum(jnp.nansum(v) for v in pp.pairwise_maps(x, 32, 32, True).values())

    assert_grad_parity(jax.jit(jax.grad(loss))(jnp.asarray(xyz)), got)


def test_subset_maps_and_none_cotangents():
    xyz = _degenerate()
    B, L = xyz.shape[:2]
    g = _cotangents(B, L, seed=7, maps=("d_cb", "phi"))
    x = torch.from_numpy(xyz).requires_grad_()
    sub = pairwise_maps(x, maps=("d_cb", "phi"))
    assert tuple(sub) == ("d_cb", "phi")
    (got,) = torch.autograd.grad([sub["d_cb"], sub["phi"]],
                                 x, [torch.from_numpy(g["d_cb"]), torch.from_numpy(g["phi"])])
    # the absent maps count as zero cotangents
    zeros = {k: jnp.asarray(g[k]) if k in g else jnp.zeros((B, L, L), jnp.float32)
             for k in MAP_NAMES}
    assert_grad_parity(_jnp_vjp(jnp.asarray(xyz), zeros), got)
    # an unused output reaches the backward as None: only d_cb's cotangent
    full = pairwise_maps(x)
    (only_cb,) = torch.autograd.grad(full["d_cb"].sum(), x)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    assert torch.equal(only_cb, _maps_bwd_plain(x.detach(), {"d_cb": torch.ones(B, L, L)}))
    assert torch.equal(maps_bwd(x.detach(), dict(tg, omega=None, d_ca=None)),
                       _maps_bwd_plain(x.detach(), tg))
    assert not maps_bwd(x.detach(), {"theta": None}).any()
    with pytest.raises(ValueError, match="unknown maps"):
        maps_bwd(x.detach(), {"chi": tg["phi"]})


def test_features_and_geometry_differentiable_on_cpu():
    xyz = _random(2, 20, 5)
    sb = StructureBatch.from_xyz(xyz, device=DEVICE)
    sb.xyz.requires_grad_()
    g = sb.inter_residue_geometry(use_kernel=True)
    feats = trrosetta_features(sb.xyz, sb.atom_mask)
    for k in MAP_NAMES:
        assert torch.equal(g[k].nan_to_num(), feats[k].nan_to_num())
    loss = sum(torch.where(g["d_cb_mask"] & torch.isfinite(g[k]), g[k], 0.0).sum() * (i + 1)
               for i, k in enumerate(MAP_NAMES))
    loss.backward()
    cots = {k: (i + 1) * (g["d_cb_mask"] & torch.isfinite(g[k])).float()
            for i, k in enumerate(MAP_NAMES)}
    ref = _maps_bwd_plain(sb.xyz.detach(), cots)
    assert torch.isfinite(sb.xyz.grad).all()
    torch.testing.assert_close(sb.xyz.grad, ref, rtol=0, atol=1e-5 * max(1.0, float(ref.abs().max())))
    assert pair_maps.BWD_LAUNCHES == 0  # CPU tensors never count as launches


@pytest.mark.parametrize("pdb", ["1ad0_DC.pdb", "1REX.pdb"])
def test_inter_residue_geometry_default_matches_jax(pdb):
    """The default is the arccos form in both packages (the K1 form differs
    from it by up to 3.3e-5 in phi on 1ad0_DC)."""
    ref = JaxBatch.from_pdb(pdb_path(pdb)).inter_residue_geometry()
    out = StructureBatch.from_pdb(pdb_path(pdb), device=DEVICE).inter_residue_geometry()
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert_parity(np.asarray(ref[k]), out[k], 0 if k in MASKS else 1e-5, k)


def test_cli_featurize_pallas_switch(tmp_path):
    path = pdb_path("1REX.pdb")
    sb = StructureBatch.from_pdb(path, device=DEVICE)
    for flag, use_kernel in (([], False), (["--pallas"], True)):
        out = tmp_path / f"f{use_kernel}.npz"
        assert main(["featurize", path, "--out", str(out), "--device", "cpu", *flag]) == 0
        ref = sb.inter_residue_geometry(use_kernel=use_kernel)
        dat = np.load(out)
        for k in MAP_NAMES:
            np.testing.assert_array_equal(dat[k], ref[k].numpy(), err_msg=f"{flag} {k}")


def test_cuda_wrapper_rejects_bad_input_and_other_devices():
    with pytest.raises(ValueError, match="no implementation for device meta"):
        maps_bwd(torch.zeros(1, 4, 15, 3, device="meta"), {"d_ca": torch.zeros(1, 4, 4)})
    with pytest.raises(TypeError, match="float32"):
        pair_maps._maps_bwd_cuda(torch.zeros(1, 4, 15, 3, dtype=torch.float64), {})
    with pytest.raises(ValueError, match=r"cotangent of d_ca"):
        pair_maps._maps_bwd_cuda(torch.zeros(1, 4, 15, 3), {"d_ca": torch.zeros(1, 4, 5)})


def test_bwd_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(cuda_lib, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_lib, "_LIBS", {})
    with pytest.raises(RuntimeError, match="no nvcc"):
        pair_maps.load_bwd_library()
