"""The served slice as a whole: the port's serving path vs the JAX package's.

Both ``serve_loop``s get the same JSONL (ping, featurize of 1REX and 1ad0_DC,
a bad path, shutdown) and must give the same response keys, npz keys and
shapes, every float map (distances, omega/theta/phi, dihedrals, frames)
within 1e-5, and masks bitwise.  On the CPU both packages serve the arccos
form of the pair maps (the JAX package's jnp path, the port's
``_inter_residue_geometry``): K1 and its atan2-form plain version are for
the card, as Pallas is for the TPU.

The ``analyze`` and ``fold`` ops against the JAX ``serve_loop``: one tiny
FoldModel's weights (the port's seeded init), saved once in each package's
checkpoint format (the port's through ``convert.foldmodel_params_from_flax``);
the ``analyze`` responses equal, the folded coordinates within 1e-3 A and
pLDDT within 1e-2 (the served PDBs, which print 3 and 2 decimals, within
those plus one unit of their last printed digit).  The JAX FoldModel's
``init`` and ``apply`` are jitted there (eager flax costs a minute a fold).
"""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu import train as jtrain
from protstruc_tpu.__main__ import serve_loop as jax_serve_loop
from protstruc_tpu.models.checkpoint import save_train_state as jax_save_train_state
from protstruc_tpu.utils.aot import precompile_featurizer as jax_precompile
from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu_torch import StructureBatch, train
from protstruc_tpu_torch.__main__ import main, serve_loop
from protstruc_tpu_torch.convert import foldmodel_params_from_flax
from protstruc_tpu_torch.models import checkpoint
from protstruc_tpu_torch.ops import pair_maps
from protstruc_tpu_torch.utils.aot import precompile_featurizer
from tests.conftest import pdb_path
from tests.test_torch_ipa import _randomise, port_init_params
from tests.test_torch_parity import DEVICE, assert_parity

torch.set_num_threads(1)

BUCKETS = (256, 512)
EXACT = ("d_ca_mask", "d_cb_mask", "d_no_mask", "dihedral_mask")


def _atol(key):
    return 0 if key in EXACT else 1e-5


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
    """``analyze`` answers; ``fold`` without a checkpoint and an unknown op
    give the JAX server's errors."""
    reqs = [{"op": "analyze", "path": pdb_path("1REX.pdb")}, {"op": "fold", "seq": "AG"},
            {"op": "nope"}]
    lines = _serve(serve_loop, reqs, buckets=(64,), device="cpu")
    assert [l["ok"] for l in lines] == [True, True, False, False]
    assert lines[1]["n_residues"] == 130 and 0.0 < lines[1]["helix_frac"] < 1.0
    ref = _serve(jax_serve_loop, reqs[1:], buckets=(64,))
    assert lines[2:] == ref[1:]
    assert lines[2]["error"] == "ValueError: fold requires --checkpoint-dir"
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


# ---------------------------------------------------------------------------
# the analyze and fold ops, against the JAX serve_loop
# ---------------------------------------------------------------------------

# a tiny FoldModel with phase 12's switches: triangle updates, remat,
# fused_tri and flash attention (each package's plain path on the CPU)
FOLD_CFG = dict(steps=1, batch_size=1, node_dim=16, pair_dim=8, n_heads=2, n_blocks=1,
                n_ipa_iter=2, n_recycle=1, sequence_only=True, save_every=0,
                pair_update="triangle", remat=True, fused_tri=True, use_flash_attn=True)


class _JittedModel:
    """A flax FoldModel with ``init`` and ``apply`` jitted, for the JAX
    package's ``load_fold_model`` and ``fold_with_model``."""

    def __init__(self, model):
        self.trunk_cfg = model.trunk_cfg
        self.init = jax.jit(model.init)
        self.apply = jax.jit(model.apply, static_argnames="n_recycle")


@pytest.fixture(scope="module")
def jitted_jax_models():
    build, cache = jtrain._build_model, {}

    def cached(cfg, *args, **kw):
        key = cfg.to_json()
        if key not in cache:
            cache[key] = _JittedModel(build(cfg, *args, **kw))
        return cache[key]

    jtrain._build_model = cached
    yield
    jtrain._build_model = build


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, jitted_jax_models):
    """The same weights in a JAX (orbax) and a port (torch.save) checkpoint."""
    d = tmp_path_factory.mktemp("ck")
    model = train._build_model(train.TrainConfig(**FOLD_CFG), DEVICE)
    params = port_init_params(model, seed=3)
    rng = np.random.RandomState(7)
    st = dict(params["structure"])
    st["backbone_update"] = _randomise(st["backbone_update"], rng)
    params = dict(params, structure=st)
    jdir, tdir = str(d / "jax"), str(d / "torch")
    jax_save_train_state(jdir, 1, params, {"count": jnp.zeros((), jnp.int32)})
    checkpoint.save_train_state(tdir, 1, foldmodel_params_from_flax(_numpy(params)), {})
    with open(os.path.join(jdir, "config.json"), "w") as fh:
        fh.write(jtrain.TrainConfig(**FOLD_CFG).to_json())
    with open(os.path.join(tdir, "config.json"), "w") as fh:
        fh.write(train.TrainConfig(**FOLD_CFG).to_json())
    return jdir, tdir


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)


def _fold_requests(out_dir):
    return [{"op": "ping"},
            {"op": "analyze", "path": pdb_path("1REX.pdb")},
            {"op": "fold", "seq": "MKVLAGHEWR", "out": str(out_dir / "fold1.pdb")},
            {"op": "fold", "seq": "MKVLA:GSEWR", "out": str(out_dir / "fold2.pdb")},
            {"op": "nope"},
            {"op": "shutdown"}]


def _atoms(path):
    rows = [ln for ln in open(path) if ln.startswith("ATOM")]
    return ([ln[:30] for ln in rows],
            np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in rows]),
            np.array([float(ln[60:66]) for ln in rows]))


def test_server_analyze_and_fold_match_jax(checkpoints, tmp_path):
    jdir, tdir = checkpoints
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref = _serve(jax_serve_loop, _fold_requests(tmp_path / "jax"), checkpoint_dir=jdir,
                 buckets=(64,))
    got = _serve(serve_loop, _fold_requests(tmp_path / "torch"), checkpoint_dir=tdir,
                 buckets=(64,), device=DEVICE)
    assert len(got) == len(ref) == 7
    assert got[:3] == ref[:3]  # ready, ping, analyze
    assert got[2]["ok"] and got[2]["n_residues"] == 130
    for i in (3, 4):
        assert got[i]["ok"] and ref[i]["ok"] and sorted(got[i]) == sorted(ref[i])
        assert abs(got[i]["mean_plddt"] - ref[i]["mean_plddt"]) <= 0.1 + 1e-9
        head_r, xyz_r, b_r = _atoms(ref[i]["out"])
        head_g, xyz_g, b_g = _atoms(got[i]["out"])
        assert head_g == head_r
        np.testing.assert_allclose(xyz_g, xyz_r, rtol=0, atol=1e-3 + 1e-3)
        np.testing.assert_allclose(b_g, b_r, rtol=0, atol=1e-2 + 1e-2)
    assert got[5] == ref[5] and "unknown op" in got[5]["error"]
    assert got[6] == ref[6] == {"ok": True, "bye": True}


def test_fold_with_model_matches_jax_unrounded(checkpoints):
    """The served fold's numbers before the writer rounds them."""
    jdir, tdir = checkpoints
    jmodel = jtrain.load_fold_model(jdir)
    tmodel = train.load_fold_model(tdir, device=DEVICE)
    for seq in ("MKVLAGHEWR", "MKVLA:GSEWR"):
        ref = [np.asarray(x) for x in jtrain.fold_with_model(*jmodel, seq, return_confidence=True)]
        got = [x.numpy() for x in train.fold_with_model(*tmodel, seq, return_confidence=True)]
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-3, err_msg="coords")
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-2, err_msg="plddt")
