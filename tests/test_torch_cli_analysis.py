"""The analysis commands: the port's CLI vs the JAX package's.

* ``analyze`` (with ``--ss8 --sasa``), ``score`` (single chain, and a
  two-chain complex with DockQ) and ``convert`` (PDB -> mmCIF -> PDB): the
  port's output equals the JAX CLI's at the printed rounding (the JSON text
  and the written files are compared whole).
* ``score``'s checks: the residue-count mismatch and the receptor-chain
  errors.
* ``fold --relax`` on the CPU: it relaxes, says so, and writes a PDB.

The server's ``analyze`` and ``fold`` ops are held to the JAX ``serve_loop``
in tests/test_torch_serve.py.
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.__main__ import main as jax_main
from protstruc_tpu.pdbio.writer import structure_batch_to_pdb
from protstruc_tpu_torch import train
from protstruc_tpu_torch.__main__ import main
from protstruc_tpu_torch.models import checkpoint
from protstruc_tpu_torch.pdbio.parser import parse_pdb
from tests.conftest import pdb_path
from tests.test_torch_analysis import interface_selection
from tests.test_torch_parity import DEVICE
from tests.test_torch_serve import FOLD_CFG, _atoms

torch.set_num_threads(1)

def _run(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def _select(name, sel, path):
    sb = JaxBatch.from_pdb(pdb_path(name))
    mask = np.zeros(sb.chain_idx.shape, bool)
    mask[:, sel] = True
    structure_batch_to_pdb(sb.residue_masked_select(jnp.asarray(mask)), str(path))
    return str(path)


@pytest.fixture(scope="module")
def pdbs(tmp_path_factory):
    """A 40-residue fragment of 1REX, its two-residue stretch, and a
    40-residue two-chain fragment of 1ad0_DC (20 a chain, at the
    interface), written by the JAX package's writer."""
    d = tmp_path_factory.mktemp("pdbs")
    sel = interface_selection(JaxBatch.from_pdb(pdb_path("1ad0_DC.pdb")))
    return {"frag": _select("1REX.pdb", slice(0, 40), d / "frag.pdb"),
            "two_res": _select("1REX.pdb", slice(60, 62), d / "two_res.pdb"),
            "complex": _select("1ad0_DC.pdb", sel, d / "complex.pdb")}


def _same_output(argv):
    ref = _run(jax_main, argv)
    got = _run(main, argv + ["--device", DEVICE])
    assert got == ref, (argv, ref, got)
    return json.loads(got[1]) if got[1].startswith("{") else got[1]


def test_analyze_matches_jax_cli(pdbs):
    """One batch: the 1REX fragment and its two-residue stretch (no residue
    with phi AND psi: the Ramachandran fractions are 0.0, not NaN)."""
    rep = _same_output(["analyze", pdbs["frag"], pdbs["two_res"], "--ss8", "--sasa"])
    assert rep["n_residues"] == [40, 2] and len(rep["dssp8"][0]) == 40
    assert rep["rama_favored_frac"][1] == 0.0 and rep["total_sasa_A2"][0] > 0


def test_score_matches_jax_cli(pdbs, tmp_path):
    rep = _same_output(["score", pdbs["frag"], pdbs["frag"]])
    assert rep["ca_rmsd"] < 1e-3 and rep["tm_score"] > 0.999 and "dockq" not in rep
    assert _same_output(["score", pdbs["complex"], pdbs["complex"]])["capri_band"] == "high"
    sb = JaxBatch.from_pdb(pdbs["complex"])
    moved = sb.replace(xyz=jnp.where((sb.chain_idx == 1)[:, :, None, None], sb.xyz + 4.0, sb.xyz))
    structure_batch_to_pdb(moved, str(tmp_path / "model.pdb"))
    rep = _same_output(["score", str(tmp_path / "model.pdb"), pdbs["complex"],
                        "--receptor-chains", "1"])
    assert rep["dockq"] < 0.8


def test_score_checks(pdbs):
    with pytest.raises(SystemExit, match="residue count mismatch"):
        main(["score", pdbs["frag"], pdb_path("1REX.pdb"), "--device", DEVICE])
    for chains in ("5", "0,1"):
        assert main(["score", pdbs["complex"], pdbs["complex"], "--receptor-chains", chains,
                     "--device", DEVICE]) == 2


def test_convert_matches_jax_cli(pdbs, tmp_path):
    out = {}
    for tag, fn in (("jax", jax_main), ("torch", main)):
        cif, pdb = str(tmp_path / f"{tag}.cif"), str(tmp_path / f"{tag}.pdb")
        dev = [] if tag == "jax" else ["--device", DEVICE]
        assert _run(fn, ["convert", pdb_path("15c8_HL.pdb"), cif] + dev) == (0, f"wrote {cif}\n")
        assert _run(fn, ["convert", cif, pdb] + dev)[0] == 0
        out[tag] = (open(cif).read(), open(pdb).read())
    assert out["torch"] == out["jax"]
    a, b = parse_pdb(pdb_path("15c8_HL.pdb")), parse_pdb(str(tmp_path / "torch.pdb"))
    m = a.atom_mask & b.atom_mask
    np.testing.assert_allclose(a.atom_xyz[m], b.atom_xyz[m], atol=5e-4)


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """A tiny FoldModel checkpoint of the port (seeded init)."""
    d = str(tmp_path_factory.mktemp("ck"))
    cfg = train.TrainConfig(**FOLD_CFG)
    model = train._build_model(cfg, DEVICE)
    model.reset_parameters(torch.Generator().manual_seed(3))
    checkpoint.save_train_state(d, 1, model.state_dict(), {})
    with open(os.path.join(d, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    return d


def test_fold_relax_cli(port_checkpoint, tmp_path, capsys):
    tdir = port_checkpoint
    out = str(tmp_path / "relaxed.pdb")
    assert main(["fold", "--checkpoint-dir", tdir, "--seq", "MKVGA:WE", "--out", out,
                 "--relax", "3", "--device", DEVICE]) == 0
    err = capsys.readouterr().err
    assert "relaxed 3 steps: energy" in err
    e0, e1 = (float(x) for x in err.split("energy")[1].split("->"))
    assert e1 <= e0
    heads, xyz, _ = _atoms(out)
    assert len(heads) == 7 * 5 - 1 and np.isfinite(xyz).all()  # no CB for the glycine
