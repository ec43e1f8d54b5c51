"""The FoldModel training loop: the port vs the JAX package on the CPU.

* The optimizer (:class:`TrainOptimizer`) against the JAX package's optax chain
  (``train._build_tx``): clipping, adamw, ``warmup_cosine``, the params EMA
  and ``MultiSteps`` accumulation, on toy parameters over several
  microbatches (1e-6).
* One train step of a tiny FoldModel (node 32, pair 16, 2 heads, 1 block, 2
  IPA iterations, one recycle) against the JAX ``step_fn`` (``train.py:479-486``)
  from the same parameters and features, with clipping active: the loss
  (1e-5 relative) and the new parameters (1e-5; an entry whose gradient is
  below 1e-4 of its leaf's largest, or whose exact gradient is 0
  (tests/test_torch_ipa.py), where Adam's first step is ``lr * sign(g)`` of
  rounding noise, is held to a move of at most ``lr``).
* ``train`` on bundled PDBs (save, resume to the total ``steps``, the
  config-mismatch error, ``metrics.jsonl``), ``best_eval_step``,
  ``load_fold_model`` (EMA weights), ``fold_with_model``, and the ``train``/
  ``fold`` CLI, all with ``device="cpu"``.
* ``random_crop`` against JAX for given starts, ``StructureDataset`` epoch
  order against JAX's, the bucket helpers, the PDB writer and ``TrainConfig``'s
  JSON against JAX's.
* The port's entry points default to the card: without one, each default call
  raises the "no CUDA" error.
"""

import json
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu import train as jtrain
from protstruc_tpu.models import ipa as jipa
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.pdbio.dataset import StructureDataset as JaxDataset
from protstruc_tpu.pdbio.writer import to_pdb as jax_to_pdb
from protstruc_tpu.utils import buckets as jbuckets
from protstruc_tpu_torch import StructureBatch, train
from protstruc_tpu_torch.__main__ import main
from protstruc_tpu_torch.convert import foldmodel_params_from_flax, structure_batch_from_numpy
from protstruc_tpu_torch.models import checkpoint, ipa, trfold
from protstruc_tpu_torch.pdbio import parser
from protstruc_tpu_torch.pdbio.dataset import StructureDataset
from protstruc_tpu_torch.pdbio.parser import parse_pdb_files
from protstruc_tpu_torch.pdbio.writer import to_pdb
from protstruc_tpu_torch.utils import buckets
from tests.conftest import pdb_path
from tests.test_torch_ipa import _zero_grad_entries, port_init_params
from tests.test_torch_parity import DEVICE, as_numpy, assert_parity

torch.set_num_threads(1)

TINY = dict(node_dim=32, pair_dim=16, n_heads=2, n_blocks=1, n_ipa_iter=2, n_recycle=1)
PDBS = ("1REX.pdb", "4EOT.pdb", "1ad0_DC.pdb")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

OPT_CONFIGS = {
    "constant": dict(learning_rate=1e-2, grad_clip=1.0),
    "warmup_cosine_ema": dict(learning_rate=1e-2, grad_clip=1.0, lr_schedule="warmup_cosine",
                              warmup_steps=2, steps=6, ema_decay=0.9),
    "accum_ema": dict(learning_rate=1e-2, grad_clip=0.5, lr_schedule="warmup_cosine",
                      warmup_steps=2, steps=8, ema_decay=0.8, accum_steps=2),
}


@pytest.mark.parametrize("name", sorted(OPT_CONFIGS))
def test_optimizer_matches_optax_chain(name):
    kw = OPT_CONFIGS[name]
    rng = np.random.RandomState(0)
    init = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32),
            "unused": rng.randn(2).astype(np.float32)}
    tx = jtrain._build_tx(jtrain.TrainConfig(**kw))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(jparams)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = train.TrainOptimizer(params, train.TrainConfig(**kw))
    for i in range(6):
        scale = 0.05 if i == 3 else 1.0  # one microbatch under the clip norm
        g = {k: (rng.randn(*v.shape) * scale).astype(np.float32) for k, v in init.items()}
        g["unused"][:] = 0.0
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.items():
            p.grad = None if k == "unused" else torch.from_numpy(g[k])
        opt.step()
        for k in init:
            assert_parity(np.asarray(jparams[k]), params[k], 1e-6, f"{name} step {i} {k}")
        if kw.get("ema_decay"):
            ema = jtrain._find_ema(state)
            for k in init:
                assert_parity(np.asarray(ema[k]), opt.state["ema"][k], 1e-6, f"ema {i} {k}")


def test_learning_rate_schedule_matches_optax():
    cfg = dict(learning_rate=3e-4, lr_schedule="warmup_cosine", warmup_steps=40, steps=200,
               accum_steps=2, lr_min_ratio=0.1)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 20, 100, 3e-5)
    sched = train.learning_rate_schedule(train.TrainConfig(**cfg))
    got = np.array([sched(c) for c in range(130)])
    np.testing.assert_allclose(got, np.array([float(ref(c)) for c in range(130)]),
                               rtol=1e-6, atol=1e-12)
    assert train.learning_rate_schedule(train.TrainConfig(learning_rate=0.5))(7) == 0.5
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        train.learning_rate_schedule(train.TrainConfig(lr_schedule="step"))


# ---------------------------------------------------------------------------
# one train step against the JAX step_fn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_case():
    """A 36-residue window of two PDBs featurized by the JAX trainer's
    ``_featurize``, the port's FoldModel init (tests/test_torch_ipa.py holds
    its tree to flax's) with a random backbone update, and the JAX step
    (value_and_grad of fold_loss_fn, the optax chain)."""
    cfg = jtrain.TrainConfig(**TINY, learning_rate=1e-3, grad_clip=0.1)
    model = jtrain._build_model(cfg)
    sb = JaxBatch.from_pdb([pdb_path(p) for p in PDBS[:2]])
    sb = sb.replace(xyz=sb.xyz[:, 4:40], atom_mask=sb.atom_mask[:, 4:40],
                    chain_idx=sb.chain_idx[:, 4:40], residue_idx=sb.residue_idx[:, 4:40], seq=None)
    feats, target, _ = jtrain._featurize(sb, cfg, model.trunk_cfg)
    params = port_init_params(train._build_model(train.TrainConfig(**TINY), DEVICE))
    rng = np.random.RandomState(3)
    st = dict(params["structure"])
    st["backbone_update"] = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), st["backbone_update"])
    params = dict(params, structure=st)
    tx = jtrain._build_tx(cfg)

    @jax.jit
    def step_fn(params, opt_state, feats, xyz):
        loss, grads = jax.value_and_grad(jipa.fold_loss_fn)(params, model, feats, xyz,
                                                              target_feats=target)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, grads

    new, loss, grads = step_fn(params, tx.init(params), feats, sb.xyz)
    np_tree = lambda t: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), t)  # noqa: E731
    return {"cfg": cfg, "feats": {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16
                                  else np.array(v) for k, v in feats.items()},
            "xyz": np.array(sb.xyz), "params": np_tree(params), "new": np_tree(new),
            "loss": float(loss), "grads": np_tree(grads)}


def test_one_train_step_matches_jax_step_fn(step_case):
    c = step_case
    cfg = train.TrainConfig(**TINY, learning_rate=1e-3, grad_clip=0.1)
    model = train._build_model(cfg, DEVICE)
    model.load_state_dict(foldmodel_params_from_flax(c["params"]))
    feats = {k: torch.from_numpy(v) for k, v in c["feats"].items()}
    feats["ang_sincos"] = feats["ang_sincos"].to(torch.bfloat16)  # JAX's bf16 planes, exactly
    params = dict(model.named_parameters())
    opt = train.TrainOptimizer(params, cfg)
    loss = train.train_step(model, params, opt, feats, None, torch.from_numpy(c["xyz"]))
    assert abs(float(loss) - c["loss"]) <= 1e-5 * abs(c["loss"])
    grads = foldmodel_params_from_flax(c["grads"])
    gnorm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    assert gnorm > 10 * cfg.grad_clip  # clipping is active
    old, new = foldmodel_params_from_flax(c["params"]), foldmodel_params_from_flax(c["new"])
    lr = cfg.learning_rate
    for k, r in new.items():
        r, got, g = as_numpy(r), as_numpy(params[k]), np.abs(as_numpy(grads[k]))
        noise = (g <= 1e-4 * g.max()) | _zero_grad_entries(k, g.shape)
        moved = np.abs(got - as_numpy(old[k]))
        assert (moved[noise] <= 1.01 * lr * (1 + 1e-4 * np.abs(as_numpy(old[k])[noise]))).all(), k
        assert_parity(r[~noise], got[~noise], 1e-5, k)


# ---------------------------------------------------------------------------
# the loop, checkpoints, folding, CLI
# ---------------------------------------------------------------------------

LOOP = dict(TINY, batch_size=2, crop_len=32, save_every=1, pair_update="triangle", remat=True,
            fused_tri=True, use_flash_attn=True, ema_decay=0.9)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck"))
    logs = []
    cfg = train.TrainConfig(**LOOP, steps=2)
    res = train.train([pdb_path(p) for p in PDBS[:2]], ck, cfg, log_fn=logs.append,
                      eval_paths=[pdb_path(PDBS[2])], device=DEVICE)
    return ck, res, logs


def test_train_saves_evaluates_and_records(trained):
    ck, res, logs = trained
    assert res["steps"] == 2 and np.isfinite(res["final_loss"])
    assert 0.0 <= res["eval_ca_lddt"] <= 1.0 and res["eval_ca_rmsd"] > 0
    assert checkpoint.all_steps(ck) == [1, 2]
    rows = [json.loads(ln) for ln in open(os.path.join(ck, "metrics.jsonl"))]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2]
    assert [r["step"] for r in rows if "eval_ca_lddt" in r] == [1, 2]
    assert train.TrainConfig.from_json(open(os.path.join(ck, "config.json")).read()) == \
        train.TrainConfig(**LOOP, steps=2)
    assert any("[eval] final" in ln for ln in logs)


def test_train_resumes_to_the_total_steps_and_refuses_another_config(trained, tmp_path):
    ck, _, _ = trained
    work = str(tmp_path / "ck")
    shutil.copytree(ck, work)
    logs = []
    res = train.train([pdb_path(p) for p in PDBS[:2]], work, train.TrainConfig(**LOOP, steps=3),
                      log_fn=logs.append, device=DEVICE)
    assert res["steps"] == 3 and "[train] resumed from step 2" in logs
    assert checkpoint.latest_step(work) == 3
    logs = []
    res = train.train([pdb_path(PDBS[0])], work, train.TrainConfig(**LOOP, steps=3),
                      log_fn=logs.append, device=DEVICE)
    assert res["final_loss"] is None and any("nothing to train" in ln for ln in logs)
    with pytest.raises(ValueError, match=r"node_dim=32 \(checkpoint\) vs 48 \(requested\)"):
        train.train([pdb_path(PDBS[0])], work, train.TrainConfig(**dict(LOOP, node_dim=48)),
                    device=DEVICE)


def test_best_step_ema_weights_and_folding(trained):
    ck, _, _ = trained
    best = train.best_eval_step(ck)
    assert best in (1, 2)
    assert train.best_eval_step(ck, "eval_ca_rmsd") in (1, 2)
    with pytest.warns(UserWarning, match="structure-conditioned"):
        model, params, cfg = train.load_fold_model(ck, step="best", device=DEVICE)
    assert cfg.use_flash_attn and cfg.fused_tri  # kept as trained
    _, opt_state, _ = checkpoint.restore_train_state(ck, step=best)
    for k, v in opt_state["ema"].items():
        assert torch.equal(params[k].detach(), v), k
    with pytest.warns(UserWarning):
        _, raw, _ = train.load_fold_model(ck, step=best, use_ema=False, device=DEVICE)
    saved, _, _ = checkpoint.restore_train_state(ck, step=best)
    assert all(torch.equal(raw[k].detach(), v) for k, v in saved.items())
    coords, plddt, pae = train.fold_with_model(model, params, cfg, "MKVLAGH:GSE",
                                               return_confidence=True)
    assert coords.shape == (10, 5, 3) and plddt.shape == (10,) and pae.shape == (10, 10)
    assert torch.isfinite(coords).all() and ((plddt >= 0) & (plddt <= 100)).all()
    assert train.fold_with_model(model, params, cfg, "MKV", n_recycle=0).shape == (3, 5, 3)


def test_cli_train_and_fold(tmp_path, capsys):
    ck, out = str(tmp_path / "ck"), str(tmp_path / "fold.pdb")
    assert main(["train", pdb_path(PDBS[0]), "--checkpoint-dir", ck, "--steps", "1",
                 "--batch-size", "1", "--node-dim", "32", "--pair-dim", "16", "--blocks", "1",
                 "--recycle", "0", "--crop", "24", "--save-every", "1", "--flash-attn",
                 "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["steps"] == 1
    with pytest.warns(UserWarning):
        assert main(["fold", "--checkpoint-dir", ck, "--seq", "MKVGA", "--out", out,
                     "--device", "cpu"]) == 0
    lines = [ln for ln in open(out) if ln.startswith("ATOM")]
    assert len(lines) == 5 * 5 - 1  # no CB for the glycine
    capsys.readouterr()
    with pytest.warns(UserWarning):
        assert main(["fold", "--checkpoint-dir", ck, "--seq", "MKV", "--out", out,
                     "--relax", "2", "--device", "cpu"]) == 0
    assert "relaxed 2 steps: energy" in capsys.readouterr().err
    assert len([ln for ln in open(out) if ln.startswith("ATOM")]) == 3 * 5
    with pytest.raises(ValueError, match=r"needs dp\*sp\*tp = 2 ranks"):
        main(["train", pdb_path(PDBS[0]), "--checkpoint-dir", ck, "--mesh", "1,2,1",
              "--device", "cpu"])


def test_unported_options_raise():
    # every mesh is ported (tests/test_torch_dist.py, tests/test_torch_model_parallel.py);
    # one whose dp * sp * tp is not the world size is refused before any group starts
    for kw in (dict(mesh_shape=(1, 2, 1)), dict(mesh_shape=(1, 1, 2), zero1=True)):
        with pytest.raises(ValueError, match=r"needs dp\*sp\*tp = 2 ranks"):
            train.train([pdb_path(PDBS[0])], "unused", train.TrainConfig(**kw), device=DEVICE)
    with pytest.raises(ValueError, match="zero1=True requires mesh_shape"):
        train.train([pdb_path(PDBS[0])], "unused", train.TrainConfig(zero1=True), device=DEVICE)
    with pytest.raises(ValueError, match="at least one input"):
        train.train([], "unused", device=DEVICE)


def test_train_config_json_matches_jax():
    kw = dict(steps=8, crop_len=256, use_flash_attn=True, mesh_shape=None, ema_decay=0.99)
    assert train.TrainConfig(**kw).to_json() == jtrain.TrainConfig(**kw).to_json()
    assert train.TrainConfig.from_json(jtrain.TrainConfig(**kw).to_json()) == train.TrainConfig(**kw)


# ---------------------------------------------------------------------------
# ingest: crop, dataset, buckets, writer, checkpoints
# ---------------------------------------------------------------------------


def test_random_crop_matches_jax_for_given_starts():
    paths = [pdb_path(p) for p in PDBS[:2]]
    sbj, sbt = JaxBatch.from_pdb(paths), StructureBatch.from_pdb(paths, device=DEVICE)
    key, size = jax.random.PRNGKey(7), 30
    seq = np.asarray(sbj.get_seq_idx())
    ref, (rseq,) = sbj.random_crop(key, size, extras=(seq,))
    lengths = np.asarray(sbj.get_total_lengths())
    u = np.asarray(jax.random.uniform(key, (2,)))
    max_start = np.maximum(lengths - size, 0)
    starts = np.minimum((u * (max_start + 1).astype(np.float32)).astype(np.int32), max_start)
    got, (gseq,) = sbt.random_crop(size, starts=starts, extras=(torch.from_numpy(seq),))
    for f in ("xyz", "atom_mask", "chain_idx", "residue_idx"):
        assert_parity(np.asarray(getattr(ref, f)), getattr(got, f), 0, f)
    assert_parity(np.asarray(rseq), gseq, 0, "extras")
    assert got.seq is None
    a = sbt.random_crop(size, torch.Generator().manual_seed(5))
    b = sbt.random_crop(size, torch.Generator().manual_seed(5))
    assert torch.equal(a.residue_idx, b.residue_idx) and a.n_residues == size
    with pytest.raises(ValueError, match="crop size"):
        sbt.random_crop(10_000)


def test_dataset_epoch_order_matches_jax(monkeypatch):
    paths = [pdb_path(p) for p in ("1REX.pdb", "4EOT.pdb", "1ad0_DC.pdb", "6dc4.pdb", "8dtk.pdb")]
    jds = JaxDataset(paths, batch_size=2, shuffle=True, seed=3)
    tds = StructureDataset(paths, batch_size=2, shuffle=True, seed=3, device=DEVICE)
    for epoch in range(2):
        if epoch == 1:  # every file is in the parsed-structure cache now
            monkeypatch.setattr(parser, "parse_pdb", lambda *a, **k: pytest.fail("parsed again"))
        ref, got = list(jds), list(tds)
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            assert_parity(np.asarray(r.xyz), g.xyz, 0, "xyz")
            assert r.chain_ids == g.chain_ids and r.seq == g.seq


def test_bucket_helpers_match_jax():
    paths = [pdb_path(p) for p in PDBS[:2]]
    sbj = [JaxBatch.from_pdb(p) for p in paths]
    sbt = [StructureBatch.from_pdb(p, device=DEVICE) for p in paths]
    for r, g in ((jbuckets.pad_batch_to_bucket(sbj[0]), buckets.pad_batch_to_bucket(sbt[0])),
                 (jbuckets.concat_batches(sbj), buckets.concat_batches(sbt))):
        for f in ("xyz", "atom_mask", "chain_idx", "residue_idx"):
            assert_parity(np.asarray(getattr(r, f)), getattr(g, f), 0, f)
        assert r.chain_ids == g.chain_ids and r.seq == g.seq


def test_pdb_writer_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    coords = (rng.randn(5, 7, 3) * 10).astype(np.float32)
    kw = dict(sequences=["MKG", "AGHS"], chain_ids=["A", "B"], bfactors=rng.rand(7) * 100)
    jax_to_pdb(str(tmp_path / "a.pdb"), coords, **kw)
    to_pdb(str(tmp_path / "b.pdb"), coords, **kw)
    assert open(tmp_path / "a.pdb").read() == open(tmp_path / "b.pdb").read()


def test_checkpoint_round_trip(tmp_path):
    d = str(tmp_path)
    assert checkpoint.latest_step(d) is None and checkpoint.all_steps(d + "/none") == []
    p = {"a.kernel": torch.randn(3, 2)}
    o = {"count": 4, "mu": {"a.kernel": torch.randn(3, 2)}, "ema": None}
    for step in (10, 2):
        checkpoint.save_train_state(d, step, p, o)
    assert checkpoint.all_steps(d) == [2, 10] and checkpoint.latest_step(d) == 10
    p2, o2, step = checkpoint.restore_train_state(d)
    assert step == 10 and torch.equal(p2["a.kernel"], p["a.kernel"])
    assert o2["count"] == 4 and o2["ema"] is None and torch.equal(o2["mu"]["a.kernel"], o["mu"]["a.kernel"])
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_train_state(d, step=3)


# ---------------------------------------------------------------------------
# entry points default to the card
# ---------------------------------------------------------------------------

_SMALL = dict(node_dim=16, pair_dim=8, n_heads=2, n_blocks=1)


def _fold_default(tmp_path):
    (tmp_path / "config.json").write_text(train.TrainConfig(**TINY).to_json())
    return train.fold_sequence(str(tmp_path), "MKV")


DEFAULT_CALLS = {
    "StructureBatch.from_pdb": lambda _: StructureBatch.from_pdb(pdb_path(PDBS[0])),
    "StructureBatch.from_xyz": lambda _: StructureBatch.from_xyz(np.zeros((1, 3, 15, 3))),
    "StructureBatch._from_parsed": lambda _: StructureBatch._from_parsed(
        parse_pdb_files([pdb_path(PDBS[0])])),
    "structure_batch_from_numpy": lambda _: structure_batch_from_numpy(
        np.zeros((1, 2, 15, 3)), np.ones((1, 2, 15), bool), np.zeros((1, 2)), np.zeros((1, 2))),
    "featurize_from_sequence": lambda _: trfold.featurize_from_sequence(np.zeros((1, 4), np.int32)),
    "TrFold": lambda _: trfold.TrFold(trfold.TrFoldConfig(**_SMALL)),
    "FoldModel": lambda _: ipa.FoldModel(trfold.TrFoldConfig(**_SMALL)),
    "make_train_state": lambda _: trfold.make_train_state(
        trfold.TrFold(trfold.TrFoldConfig(**_SMALL), device=DEVICE), {},
        torch.Generator().manual_seed(0)),
    "StructureDataset": lambda _: StructureDataset([pdb_path(PDBS[0])]),
    "train": lambda tmp: train.train([pdb_path(PDBS[0])], str(tmp), train.TrainConfig(**TINY)),
    "fold_sequence": _fold_default,
}


@pytest.mark.parametrize("name", sorted(DEFAULT_CALLS))
def test_default_device_is_the_card(name, monkeypatch, tmp_path):
    """Without a card, the default call raises the same error as an explicit
    ``cuda``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # fold_sequence's structure-conditioned warning
        with pytest.raises(RuntimeError,
                           match=r"device 'cuda.*' requested but torch.cuda.is_available"):
            DEFAULT_CALLS[name](tmp_path)
