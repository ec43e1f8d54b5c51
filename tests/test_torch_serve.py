"""The served slice as a whole: the port's serving path vs the JAX package's.

Both ``serve_loop``s get the same JSONL (ping, featurize of 1REX and 1ad0_DC,
a bad path, shutdown) and must give the same response keys, npz keys and
shapes, distance maps and frames within 1e-5, omega/theta/phi within 2e-4,
and masks bitwise.  The 2e-4 is the formulation waiver: the port serves
through K1 (its plain version on the CPU, atan2 form for phi), while the JAX
package on the CPU serves its jnp path (arccos form).
"""

import io
import json

import numpy as np
import pytest
import torch

from protstruc_tpu.__main__ import serve_loop as jax_serve_loop
from protstruc_tpu.utils.aot import precompile_featurizer as jax_precompile
from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu_torch import StructureBatch
from protstruc_tpu_torch.__main__ import main, serve_loop
from protstruc_tpu_torch.ops import pair_maps
from protstruc_tpu_torch.utils.aot import precompile_featurizer
from tests.conftest import pdb_path
from tests.test_torch_parity import DEVICE, assert_parity

torch.set_num_threads(1)

BUCKETS = (256, 512)
EXACT = ("d_ca_mask", "d_cb_mask", "d_no_mask", "dihedral_mask")
ANGLE_MAPS = ("omega", "theta", "phi")


def _atol(key):
    if key in EXACT:
        return 0
    return 2e-4 if key in ANGLE_MAPS else 1e-5


def _requests(out_dir, tag):
    return [
        {"op": "ping"},
        {"op": "featurize", "path": pdb_path("1REX.pdb"), "out": str(out_dir / f"{tag}_1rex.npz")},
        {"op": "featurize", "path": pdb_path("1ad0_DC.pdb"),
         "out": str(out_dir / f"{tag}_1ad0.npz")},
        {"op": "featurize", "path": str(out_dir / "missing.pdb"), "out": str(out_dir / "x.npz")},
        {"op": "shutdown"},
    ]


def _serve(fn, reqs, **kw):
    out = io.StringIO()
    rc = fn(io.StringIO("\n".join(json.dumps(r) for r in reqs)), out, **kw)
    assert rc == 0
    return [json.loads(line) for line in out.getvalue().splitlines()]


def test_serve_loop_matches_jax(tmp_path):
    ref = _serve(jax_serve_loop, _requests(tmp_path, "jax"), buckets=BUCKETS)
    got = _serve(serve_loop, _requests(tmp_path, "torch"), buckets=BUCKETS, device="cpu")
    assert len(got) == len(ref) == 6
    assert got[0] == ref[0] == {"ok": True, "ready": True, "shapes": [[1, 256], [1, 512]]}
    assert got[1] == ref[1] == {"ok": True}
    for r, g in zip(ref[2:4], got[2:4]):
        assert sorted(g) == sorted(r) and g["ok"] and g["n_residues"] == r["n_residues"]
        want, have = np.load(r["out"]), np.load(g["out"])
        assert sorted(have.files) == sorted(want.files)
        for k in want.files:
            assert_parity(want[k], have[k], _atol(k), k)
    assert got[4] == ref[4] and not got[4]["ok"]
    assert got[4]["error"].startswith("FileNotFoundError")
    assert got[5] == ref[5] == {"ok": True, "bye": True}


def test_featurizer_matches_jax_on_mixed_batch():
    """B=3 rounds up to 4, L rounds up to the 512 bucket, and back."""
    paths = [pdb_path(p) for p in ("1REX.pdb", "1ad0_DC.pdb", "4EOT.pdb")]
    ref = jax_precompile(batch_sizes=(4,), buckets=(512,))(JaxBatch.from_pdb(paths))
    feat = precompile_featurizer(batch_sizes=(4,), buckets=(512,), device="cpu")
    assert feat.shapes == [(4, 512)] and feat.device == torch.device("cpu")
    got = feat(StructureBatch.from_pdb(paths, device=DEVICE))
    for k in ref[0]:
        assert_parity(ref[0][k], got[0][k], _atol(k), k)
    for name, r, g in zip(("dihedrals", "dihedral_mask", "frames"), ref[1:], got[1:]):
        assert_parity(r, g, _atol(name), name)


def test_featurizer_rejects_unwarmed_shape_and_foreign_device():
    feat = precompile_featurizer(batch_sizes=(1,), buckets=(64,), device="cpu")
    with pytest.raises(KeyError, match="no warmed featurizer"):
        feat(StructureBatch.from_pdb(pdb_path("1REX.pdb"), device=DEVICE))
    with pytest.raises(ValueError, match="batch is on meta"):
        feat(StructureBatch.from_pdb(pdb_path("1REX.pdb"), device="meta"))


def test_serve_reports_unported_and_unknown_ops():
    reqs = [{"op": "analyze", "path": pdb_path("1REX.pdb")}, {"op": "fold", "seq": "AG"},
            {"op": "nope"}]
    lines = _serve(serve_loop, reqs, buckets=(64,), device="cpu")
    assert [l["ok"] for l in lines] == [True, False, False, False]
    assert "not yet ported" in lines[1]["error"] and "not yet ported" in lines[2]["error"]
    assert "unknown op" in lines[3]["error"]


def test_cpu_serving_launches_no_kernel(tmp_path):
    launches = pair_maps.LAUNCHES
    reqs = [{"op": "featurize", "path": pdb_path("1REX.pdb"), "out": str(tmp_path / "f.npz")}]
    assert _serve(serve_loop, reqs, buckets=(256,), device="cpu")[1]["ok"]
    assert pair_maps.LAUNCHES == launches


def test_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        precompile_featurizer(buckets=(64,), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_loop(io.StringIO(""), io.StringIO(), buckets=(64,))


def test_cli_featurize_and_info(tmp_path, capsys):
    out = tmp_path / "feats.npz"
    assert main(["featurize", pdb_path("1ad0_DC.pdb"), "--out", str(out),
                 "--device", "cpu"]) == 0
    dat = np.load(out)
    assert dat["d_cb"].shape == (1, 434, 434) and dat["frames"].shape == (1, 434, 3, 3)
    assert dat["dihedrals"].shape == (1, 434, 3)
    capsys.readouterr()
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["torch"] == torch.__version__ and "nvcc" in info
