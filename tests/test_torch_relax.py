"""Structure relaxation: the port's ``ops/relax.py`` vs the JAX package's on
the CPU.

The energies (backbone bonded, intra-residue restraint, clash) and their
gradients within ``1e-5 * max(1, max|ref|)``, on 1REX windows with missing
(NaN) atoms; ``relax_structure`` one Adam step within 1e-5 A and ten steps
within 1e-3 A with final energies within 1e-4 relative, missing atoms still
NaN; and ``StructureBatch.relax``.  The JAX references are jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.ops import pack as jpack
from protstruc_tpu.ops import relax as jrelax
from protstruc_tpu_torch.convert import structure_batch_from_numpy
from protstruc_tpu_torch.ops import pack, relax
from protstruc_tpu_torch.vocab import AA
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

L_WIN = 36


def _t(x):
    return torch.from_numpy(np.array(x))


def _tol(ref):
    return 1e-5 * max(1.0, float(np.nanmax(np.abs(as_numpy(ref)))))


@pytest.fixture(scope="module")
def inputs():
    """1REX residues 20-55 as numpy: as parsed, and with missing atoms
    (NaN, masked off) including one residue's whole backbone; chain 1 from
    residue 18 on, so the cross-residue terms meet a chain break."""
    sb = JaxBatch.from_pdb(pdb_path("1REX.pdb"))
    sl = slice(20, 20 + L_WIN)
    base = {"xyz": np.array(sb.xyz)[:, sl], "atom_mask": np.array(sb.atom_mask)[:, sl],
            "seq_idx": np.array(sb.get_seq_idx())[:, sl],
            "chain_idx": np.where(np.arange(L_WIN) < 18, 0, 1).astype(np.int32)[None]}
    missing = {k: v.copy() for k, v in base.items()}
    drop = (np.random.RandomState(0).rand(*missing["atom_mask"].shape) < 0.08)
    drop[0, 9, :4] = True
    drop &= missing["atom_mask"]
    missing["xyz"][drop] = np.nan
    missing["atom_mask"] &= ~drop
    return {"parsed": base, "missing": missing}


@jax.jit
def _jax_energies(xyz, am, ci, seq, x0, pair_ok):
    # relax_structure hands the restraint the NaN-free coordinates
    def energies(x):
        return (jrelax.backbone_bonded_energy(x, am, ci),
                jrelax.intra_residue_restraint_energy(jnp.nan_to_num(x), x0, pair_ok),
                jpack.clash_energy(x, am, seq))

    grads = [jax.grad(lambda x, k=k: energies(x)[k].sum())(xyz) for k in range(3)]
    return energies(xyz), grads


def _pair_ok(c):
    present = c["atom_mask"] & np.isfinite(c["xyz"]).all(-1)
    return present[:, :, :, None] & present[:, :, None, :]


@pytest.mark.parametrize("case", ["parsed", "missing"])
@pytest.mark.parametrize("jitter", [0.0, 0.5])
def test_energies_and_gradients_match_jax(inputs, case, jitter):
    """With ``jitter`` every atom moves ``randn * 0.5`` A (clashes, strained
    bonds); the restraint's start is the unjittered structure."""
    c = inputs[case]
    x0 = np.nan_to_num(c["xyz"])
    xyz = (c["xyz"] + jitter * np.random.RandomState(1).randn(*c["xyz"].shape)).astype(np.float32)
    args = (c["atom_mask"], c["chain_idx"], c["seq_idx"])
    (ref_e, ref_g) = _jax_energies(xyz, *args, x0, _pair_ok(c))
    names = ("bonded", "intra", "clash")
    for k, name in enumerate(names):
        x = _t(xyz).requires_grad_()
        if name == "bonded":
            e = relax.backbone_bonded_energy(x, _t(c["atom_mask"]), _t(c["chain_idx"]))
        elif name == "intra":
            e = relax.intra_residue_restraint_energy(torch.nan_to_num(x), _t(x0),
                                                     _t(_pair_ok(c)))
        else:
            e = pack.clash_energy(x, _t(c["atom_mask"]), _t(c["seq_idx"]))
        assert_parity(np.asarray(ref_e[k]), e.detach(), _tol(ref_e[k]), name)
        (g,) = torch.autograd.grad(e.sum(), x)
        ref = np.asarray(ref_g[k])
        # JAX's gradient at a NaN atom is NaN or 0 by term; the port's too
        finite = np.isfinite(ref) & torch.isfinite(g).numpy()
        assert_parity(ref[finite], g[torch.from_numpy(finite)], _tol(ref[finite]), f"grad {name}")
        np.testing.assert_array_equal(np.isfinite(ref), torch.isfinite(g).numpy(),
                                      err_msg=f"grad {name} finite pattern")


def test_differentiable_with_nans(inputs):
    """The twin of tests/test_relax.py::TestBondedEnergy::test_differentiable_with_nans:
    finite gradients of every term at the present atoms of a structure with
    missing atoms, whatever their NaN neighbours."""
    c = inputs["missing"]
    x = _t(c["xyz"]).requires_grad_()
    e = (relax.backbone_bonded_energy(x, _t(c["atom_mask"]), _t(c["chain_idx"]))
         + pack.clash_energy(x, _t(c["atom_mask"]), _t(c["seq_idx"])))
    (g,) = torch.autograd.grad(e.sum(), x)
    present = torch.from_numpy(c["atom_mask"] & np.isfinite(c["xyz"]).all(-1))
    assert bool(torch.isfinite(g[present]).all())
    assert float(g[present].abs().max()) > 0.0


@pytest.mark.parametrize("case", ["parsed", "missing"])
@pytest.mark.parametrize("n_steps,atol", [(1, 1e-5), (10, 1e-3)])
def test_relax_structure_matches_jax(inputs, case, n_steps, atol):
    c = inputs[case]
    xyz = (c["xyz"] + 0.3 * np.random.RandomState(2).randn(*c["xyz"].shape)).astype(np.float32)
    args = (c["atom_mask"], c["seq_idx"], c["chain_idx"])
    ref_x, ref_e = jax.jit(lambda x, *a: jrelax.relax_structure(x, *a, n_steps=n_steps))(xyz, *args)
    got_x, got_e = relax.relax_structure(_t(xyz), *map(_t, args), n_steps=n_steps)
    assert_parity(np.asarray(ref_x), got_x, atol, "relaxed xyz")  # NaN pattern included
    assert torch.isnan(got_x[torch.from_numpy(~np.isfinite(c["xyz"]).all(-1))]).all()
    assert sorted(got_e) == sorted(ref_e)
    for k, v in ref_e.items():
        v = np.asarray(v)
        rtol = 1e-5 if k.endswith("initial") else 1e-4
        np.testing.assert_allclose(as_numpy(got_e[k]), v, rtol=rtol, atol=1e-6, err_msg=k)
    assert float(got_e["final"][0]) < float(got_e["initial"][0])


def test_batch_relax_is_functional(inputs):
    c = inputs["missing"]
    letters = "".join(AA(int(s)).oneletter() for s in c["seq_idx"][0])
    sb = structure_batch_from_numpy(c["xyz"], c["atom_mask"], c["chain_idx"],
                                    np.arange(L_WIN, dtype=np.int32)[None],
                                    chain_ids=[["A", "B"]],
                                    seq=[{"A": letters[:18], "B": letters[18:]}], device=DEVICE)
    relaxed, e = sb.relax(n_steps=3)
    direct, _ = relax.relax_structure(sb.xyz, sb.atom_mask, sb.get_seq_idx(), sb.chain_idx,
                                      n_steps=3)
    assert relaxed is not sb and relaxed.seq == sb.seq and relaxed.atom_mask is sb.atom_mask
    assert torch.equal(relaxed.xyz.nan_to_num(), direct.nan_to_num())
    assert torch.equal(torch.isnan(relaxed.xyz), torch.isnan(sb.xyz))
    assert set(e) == {"initial", "final", "bonded_initial", "bonded_final", "clash_initial",
                      "clash_final"}
    assert bool(torch.isfinite(e["final"]).all())
