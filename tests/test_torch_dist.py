"""The port's multi-rank paths on gloo ranks: the port vs the JAX package on
the CPU.

Two process groups, of 2 and 4 ranks, each rank a spawned process running
``tests/torch_dist_workers.py`` (torch, numpy and the port only), joined by a
``FileStore`` under ``tmp_path``, one thread a rank, every collective under a
90 s timeout and every spawn joined with a time limit that fails the test.
While they run, this process computes the references:

* ``ring_attention_sharded`` at n = 2 and 4 against JAX's on the conftest's
  CPU mesh and against the global attention, one key shard fully masked:
  the output and the q, k, v and bias gradients of each rank's block (the
  key and value gradients come home through the ring);
* ``featurize_sharded`` at dp x sp = 2 x 2, kernel path and plain path,
  against JAX's on its mesh (distances 1e-5 + 1e-5 relative, angles 1e-4,
  masks and NaN patterns exact);
* ``pipeline_forward`` at (S, M) = (2, 4) and (4, 8) and ``pipeline_apply``
  of a TrFold against JAX's on the pp mesh, forward and gradients;
* ``train`` over the data-parallel mesh (2, 1, 1), with and without ZeRO-1,
  against the single-process port run (which tests/test_torch_train.py holds
  to optax and JAX): the loss of each step (1e-5 relative), the AdamW
  moments (1e-4 of the leaf's largest, over a floor of 1e-6 of the model's), the parameters and EMA after 2 steps
  (1e-5 relative; an entry whose gradient in a step is exactly 0, below
  1e-4 of its leaf's largest or below 1e-7 of the model's largest, where
  Adam turns rounding into up to +-lr, within 2 lr); the moment bytes a ZeRO-1 rank holds; the ``train
  --mesh 2,1,1 --zero1`` CLI end to end, resumed on both ranks.

The JAX package's shard_map entry points return global arrays; the port's
return each rank's block, which these tests gather.  Tolerances (f32): the
ring's forward 2e-5 and gradients 5e-5 (bias 5e-4) times max(1, max|ref|);
the pipeline 1e-5 (relative for the TrFold gradients).
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu.ops.ring_attn import ring_attention_sharded as jax_ring
from protstruc_tpu.parallel import mesh as jmesh
from protstruc_tpu.parallel.pipeline import pipeline_forward as jax_pipeline
from protstruc_tpu_torch import train
from protstruc_tpu_torch.convert import trfold_params_from_flax, trfold_params_to_flax
from protstruc_tpu_torch.models import checkpoint, trfold
from protstruc_tpu_torch.ops.flash_attn import flash_pair_bias_attention
from tests.conftest import pdb_path
from tests.test_torch_ipa import _zero_grad_entries
from tests.test_torch_parity import DEVICE, assert_parity

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_dist_workers.py")
SPAWN_LIMIT = 300      # seconds a process group may take, start to finish
RING = dict(B=2, L=24, H=2, dh=8)
TF_WIDTHS = dict(node_dim=16, pair_dim=8, n_heads=2)
TRAIN_CFG = dict(steps=2, batch_size=2, node_dim=32, pair_dim=16, n_heads=2, n_blocks=1,
                 n_ipa_iter=2, n_recycle=0, crop_len=24, save_every=1, learning_rate=1e-3,
                 ema_decay=0.9, seed=0)
TRAIN_PDBS = ("15c8_HL.pdb", "1a6v_HL.pdb", "1a3r_HL.pdb", "1a6v_JN.pdb")   # one 256 bucket


def _inputs():
    rng = np.random.RandomState(0)
    B, L, H, dh = RING["B"], RING["L"], RING["H"], RING["dh"]
    inp = {f"ring_{x}": rng.randn(B, L, H, dh).astype(np.float32) for x in ("q", "k", "v", "ct")}
    inp["ring_bias"] = rng.randn(B, H, L, L).astype(np.float32)
    kmask = rng.rand(B, L) > 0.2
    kmask[0, 6:12] = False     # a key block of the 4-rank ring
    kmask[1, 12:] = False      # a key shard of the 2-rank ring
    inp["ring_kmask"] = kmask

    for S, M in ((2, 4), (4, 8)):
        inp[f"pipe{S}_w"] = (rng.randn(S, 16, 16) * 0.3).astype(np.float32)
        inp[f"pipe{S}_b"] = (rng.randn(S, 16) * 0.1).astype(np.float32)
        inp[f"pipe{S}_x"] = rng.randn(M, 8, 16).astype(np.float32)

    xyz = (rng.randn(2, 12, 15, 3) * 5).astype(np.float32)
    feats = {k: np.array(v) for k, v in jtrfold.featurize_for_model(JaxBatch.from_xyz(xyz)).items()}
    feats["residue_mask"][1, -3:] = False
    inp.update({f"tf_feat_{k}": v for k, v in feats.items()})
    inp["tf_widths"] = TF_WIDTHS
    for S in (2, 4):
        model = trfold.TrFold(trfold.TrFoldConfig(**TF_WIDTHS, n_blocks=S), device=DEVICE)
        model.reset_parameters(torch.Generator().manual_seed(S))
        inp[f"tf_params{S}"] = {k: v.numpy().copy() for k, v in model.state_dict().items()}

    parts = []
    for name, (s, e) in (("1REX.pdb", (10, 58)), ("4EOT.pdb", (20, 68))):
        jb = JaxBatch.from_pdb(pdb_path(name))
        parts.append({k: np.asarray(getattr(jb, k))[:1, s:e]
                      for k in ("xyz", "atom_mask", "chain_idx", "residue_idx")})
    for k in ("xyz", "atom_mask", "chain_idx", "residue_idx"):
        inp[f"feat_{k}"] = np.concatenate([p[k] for p in parts]).copy()
    inp["feat_xyz"][0, 30, 4] = np.nan          # a missing CB
    inp["feat_atom_mask"][0, 30, 4] = False
    inp["feat_xyz"][1, 5] = np.nan              # a missing residue
    inp["feat_atom_mask"][1, 5] = False
    inp["train_cfg"] = TRAIN_CFG
    inp["train_paths"] = [pdb_path(p) for p in TRAIN_PDBS]
    return inp


def _spawn(world, tmp):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    logs = [open(os.path.join(tmp, f"log{r}.txt"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(world), str(r), tmp], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    return procs, logs


def _join(procs, logs, tmp, start):
    try:
        for p in procs:
            p.wait(timeout=max(1.0, SPAWN_LIMIT - (time.time() - start)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"ranks under {tmp} did not finish within {SPAWN_LIMIT} s")
    finally:
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            pytest.fail(f"rank {r} exited with {p.returncode}:\n"
                        + open(os.path.join(tmp, f"log{r}.txt")).read()[-4000:])
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _ring_refs(inp):
    """JAX's ring over n = 2 and 4 (forward and vjp), and the global flash."""
    args = [jnp.asarray(inp[f"ring_{x}"]) for x in ("q", "k", "v", "bias")]
    km = jnp.asarray(inp["ring_kmask"])
    ct = jnp.asarray(inp["ring_ct"])
    refs = {}
    for n in (2, 4):
        m = _jax_mesh((1, n, 1), ("dp", "sp", "tp"))
        fn = jax.jit(lambda *a, m=m: jax.vjp(lambda *x: jax_ring(*x, km, m), *a)[1](ct))
        out = jax.jit(lambda *a, m=m: jax_ring(*a, km, m))(*args)
        refs[n] = (np.asarray(out), [np.asarray(g) for g in fn(*args)])
    ins = [torch.from_numpy(inp[f"ring_{x}"]).requires_grad_() for x in ("q", "k", "v", "bias")]
    out = flash_pair_bias_attention(*ins, torch.from_numpy(inp["ring_kmask"]))
    (out * torch.from_numpy(inp["ring_ct"])).sum().backward()
    refs["global"] = (out.detach().numpy(), [t.grad.numpy() for t in ins])
    return refs


def _feat_refs(inp):
    jb = JaxBatch(xyz=jnp.asarray(inp["feat_xyz"]), atom_mask=jnp.asarray(inp["feat_atom_mask"]),
                  chain_idx=jnp.asarray(inp["feat_chain_idx"]),
                  residue_idx=jnp.asarray(inp["feat_residue_idx"]))
    m = _jax_mesh((2, 2, 1), ("dp", "sp", "tp"))
    sb = jmesh.shard_batch(jb, m)
    return {use: jax.tree_util.tree_map(np.asarray, jmesh.featurize_sharded(sb, m, use_pallas=use))
            for use in (True, False)}


def _pipe_refs(inp):
    refs = {}
    for S in (2, 4):
        m = _jax_mesh((S,), ("pp",))
        stages = {k: jnp.asarray(inp[f"pipe{S}_{k}"]) for k in ("w", "b")}
        x = jnp.asarray(inp[f"pipe{S}_x"])

        def fwd(p, m=m, x=x):
            return jax_pipeline(lambda pp, a: jnp.tanh(a @ pp["w"] + pp["b"]), p, x, m)

        out, g = jax.jit(jax.value_and_grad(lambda p: jnp.sum(fwd(p) ** 2)))(stages)
        out = jax.jit(fwd)(stages)
        generic = (np.asarray(out), np.asarray(g["w"]), np.asarray(g["b"]))

        feats = {k[len("tf_feat_"):]: jnp.asarray(v) for k, v in inp.items()
                 if k.startswith("tf_feat_")}
        model = jtrfold.TrFold(jtrfold.TrFoldConfig(**TF_WIDTHS, n_blocks=S))
        params = jax.tree_util.tree_map(jnp.asarray, trfold_params_to_flax(
            {k: torch.from_numpy(v) for k, v in inp[f"tf_params{S}"].items()}))

        def tf_loss(p, m=m, model=model, feats=feats):
            o = jtrfold.pipeline_apply(p, model, feats, m, n_microbatches=2)
            return sum(jnp.mean(o[k].astype(jnp.float32) ** 2) for k in sorted(o)
                       if k != "moe_aux_loss"), o

        (lv, o), g = jax.jit(jax.value_and_grad(tf_loss, has_aux=True))(params)
        flat = {k: v.numpy() for k, v in trfold_params_from_flax(
            jax.tree_util.tree_map(np.asarray, g)).items()}
        refs[S] = (generic, ({k: np.asarray(v) for k, v in o.items()}, float(lv), flat))
    return refs


def _single_process_train(tmp):
    ck = os.path.join(tmp, "ck_single")
    train.train([pdb_path(p) for p in TRAIN_PDBS], ck, train.TrainConfig(**TRAIN_CFG),
                log_fn=lambda *a: None, device=DEVICE)
    return ck


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both process groups started at once; the references computed here
    while they run; then every rank's results."""
    inp = _inputs()
    tmps, spawned = {}, {}
    start = time.time()
    for world in (2, 4):
        tmps[world] = str(tmp_path_factory.mktemp(f"world{world}"))
        torch.save(inp, os.path.join(tmps[world], "inputs.pt"))
        spawned[world] = _spawn(world, tmps[world])
    try:
        refs = {"ring": _ring_refs(inp), "featurize": _feat_refs(inp), "pipe": _pipe_refs(inp),
                "train_ck": _single_process_train(str(tmp_path_factory.mktemp("single")))}
    except BaseException:
        for procs, _ in spawned.values():
            for p in procs:
                p.kill()
        raise
    results = {w: _join(*spawned[w], tmps[w], start) for w in (2, 4)}
    return inp, refs, results, tmps


def _budget(ref, atol):
    return atol * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_and_global(runs, n):
    inp, refs, results, _ = runs
    L = RING["L"]
    out_j, grads_j = refs["ring"][n]
    out_g, grads_g = refs["ring"]["global"]
    for r, res in enumerate(results[n]):
        got = res["ring"]
        rows = slice(r * L // n, (r + 1) * L // n)
        for ref_out in (out_j, out_g):
            assert np.abs(got["out"] - ref_out[:, rows]).max() <= _budget(ref_out, 2e-5)
        for name, gj, gg, tol in zip(("dq", "dk", "dv", "dbias"), grads_j, grads_g,
                                     (5e-5, 5e-5, 5e-5, 5e-4)):
            blk = (slice(None), slice(None), rows) if name == "dbias" else (slice(None), rows)
            for ref in (gj, gg):
                assert np.abs(got[name] - ref[blk]).max() <= _budget(ref, tol), (r, name)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_gradients_come_home(runs, n):
    """Each rank's gradients of the global inputs lie in its own block: the
    key and value gradients that other ranks computed travelled back; the
    fully masked key shard gets exactly zero."""
    inp, _, results, _ = runs
    L = RING["L"]
    for r, res in enumerate(results[n]):
        got = res["ring"]
        assert not got["stray"]
        rows = np.arange(r * L // n, (r + 1) * L // n)
        masked = ~inp["ring_kmask"][:, rows]
        assert not got["dk"][masked].any() and not got["dv"][masked].any()
        assert np.abs(got["dk"]).sum() > 0 or masked.all()


def _check_feats(ref, got, name):
    maps_r, d_r, m_r, fr_r = ref
    maps_g, d_g, m_g, fr_g = got
    assert sorted(maps_r) == sorted(maps_g)
    for k, r in maps_r.items():
        if r.dtype == bool:
            assert_parity(r, maps_g[k], 0.0, f"{name} {k}")
        else:
            atol = 1e-4 if k in ("omega", "theta", "phi") else 1e-5 + 1e-5 * float(np.nanmax(np.abs(r)))
            assert_parity(r, maps_g[k], atol, f"{name} {k}")
    assert_parity(d_r, d_g, 1e-4, f"{name} dihedrals")
    assert_parity(m_r, m_g, 0.0, f"{name} dihedral mask")
    assert_parity(fr_r, fr_g, 1e-5, f"{name} frames")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_featurize_sharded_matches_jax(runs, use_kernel):
    """dp x sp = 2 x 2: rank (i, j) holds structure i's rows 24 j .. 24 j + 23
    against all 48 columns."""
    inp, refs, results, _ = runs
    ref = refs["featurize"][use_kernel]
    for r, res in enumerate(results[4]):
        bi, si = divmod(r, 2)
        got = res["featurize"]
        assert got["shape"] == (1, 24, 15, 3)
        b, rows = slice(bi, bi + 1), slice(24 * si, 24 * si + 24)
        block = ({k: v[b, rows] for k, v in ref[0].items()}, ref[1][b, rows], ref[2][b, rows],
                 ref[3][b, rows])
        _check_feats(block, got[use_kernel], f"rank {r}")


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_forward_matches_jax(runs, S):
    _, refs, results, _ = runs
    out_r, gw_r, gb_r = refs["pipe"][S][0]
    for d, res in enumerate(results[S]):
        out, gw, gb = res["pipe"]["generic"]
        np.testing.assert_allclose(out, out_r, rtol=0, atol=1e-5)   # replicated on every rank
        # stage d's gradient lands on rank d
        np.testing.assert_allclose(gw[d], gw_r[d], rtol=0, atol=_budget(gw_r, 1e-5))
        np.testing.assert_allclose(gb[d], gb_r[d], rtol=0, atol=_budget(gb_r, 1e-5))


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_apply_matches_jax(runs, S):
    _, refs, results, _ = runs
    out_r, loss_r, grads_r = refs["pipe"][S][1]
    heads = ("distogram_head", "torsion_head", "omega_head", "theta_head", "phi_head",
             "final_node_norm", "final_pair_norm")
    for d, res in enumerate(results[S]):
        out, loss, grads = res["pipe"]["apply"]
        for k, r in out_r.items():
            assert_parity(r, out[k], 1e-5 * max(1.0, float(np.abs(r).max())), k)
        assert abs(loss - loss_r) <= 1e-5 * abs(loss_r)
        mine = [k for k in grads_r if k.startswith(f"block_{d}.") or k.startswith(heads)
                or (d == 0 and not k.startswith("block_"))]
        top = max(float(np.abs(v).max()) for v in grads_r.values())
        for k in mine:
            r, g = grads_r[k], grads[k]
            zero = _zero_grad_entries(k, r.shape)
            assert np.abs(g[zero]).max(initial=0) <= 1e-5 * top, k
            if not zero.all():
                scale = float(np.abs(r[~zero]).max())
                assert np.abs(g[~zero] - r[~zero]).max() <= 1e-5 * scale + 1e-7 * top, (d, k)


def _losses(ck):
    import json

    return [json.loads(line)["loss"] for line in open(os.path.join(ck, "metrics.jsonl"))
            if "loss" in line]


@pytest.mark.parametrize("zero1", [False, True])
def test_dp_train_equals_single_process(runs, zero1):
    """Two dp ranks, each on half of the same crops, take the single-process
    steps: the loss of each step, then the parameters, EMA and AdamW state
    of the checkpoint after 2 steps (rank 0 writes it; under ZeRO-1 it
    gathers the moments from their owners)."""
    _, refs, results, tmps = runs
    ck = os.path.join(tmps[2], f"ck_dp_zero{int(zero1)}")
    single = refs["train_ck"]
    ref_losses, got_losses = _losses(single), _losses(ck)
    assert len(ref_losses) == len(got_losses) == TRAIN_CFG["steps"]
    for a, b in zip(ref_losses, got_losses):
        assert abs(a - b) <= 1e-5 * abs(a)
    for res in results[2]:
        assert abs(res["train"][f"train_zero{int(zero1)}"]["final_loss"] - ref_losses[-1]) \
            <= 1e-5 * abs(ref_losses[-1])
    p_ref, o_ref, s_ref = checkpoint.restore_train_state(single)
    p_got, o_got, s_got = checkpoint.restore_train_state(ck)
    assert s_ref == s_got == 2
    lr = TRAIN_CFG["learning_rate"]
    st_ref, st_got = o_ref["adamw"]["state"], o_got["adamw"]["state"]
    # Adam's step is lr * m / (sqrt(v) + eps): on an entry whose gradient is
    # exactly 0 or below 1e-4 of its leaf's largest in a step, the two runs'
    # rounding of it becomes up to +-lr (tests/test_torch_train.py's rule);
    # each step's gradient from the first moments of the checkpoints 1 and 2
    m1 = checkpoint.restore_train_state(single, step=1)[1]["adamw"]["state"]
    steps = {k: (m1[i]["exp_avg"].numpy() / 0.1,
                 (st_ref[i]["exp_avg"].numpy() - 0.9 * m1[i]["exp_avg"].numpy()) / 0.1)
             for i, k in enumerate(p_ref)}
    tops = [max(float(np.abs(g[s]).max()) for g in steps.values()) for s in (0, 1)]
    # small: below 1e-4 of the leaf's largest, or at the model's rounding
    # floor (1e-7 of its largest gradient: a leaf whose exact gradient is 0)
    small = {k: np.logical_or.reduce([(np.abs(g) < 1e-4 * np.abs(g).max()) | (np.abs(g) < 1e-7 * t)
                                      for g, t in zip(gs, tops)]) for k, gs in steps.items()}
    for k, r in p_ref.items():
        r, g = r.numpy(), p_got[k].numpy()
        noise = _zero_grad_entries(k, r.shape) | small[k]
        assert np.abs(g[noise] - r[noise]).max(initial=0) <= 2 * lr + 1e-6, k
        assert np.abs(g[~noise] - r[~noise]).max(initial=0) <= 1e-5 * max(1.0, np.abs(r).max()), k
    for k, r in o_ref["ema"].items():
        noise = _zero_grad_entries(k, r.shape) | small[k]
        d = np.abs(o_got["ema"][k].numpy() - r.numpy())
        assert d[~noise].max(initial=0) <= 1e-5 * max(1.0, float(r.abs().max())), k
        assert d[noise].max(initial=0) <= 2 * lr + 1e-6, k
    assert sorted(st_ref) == sorted(st_got)       # every moment, gathered from its owner
    for key in ("exp_avg", "exp_avg_sq"):
        top = max(float(st_ref[i][key].abs().max()) for i in st_ref)
        for i in st_ref:
            a, b = st_ref[i][key].numpy(), st_got[i][key].numpy()
            assert a.shape == b.shape
            # 1e-4 of the leaf's largest, over a floor of 1e-6 of the model's
            assert np.abs(a - b).max() <= 1e-4 * float(np.abs(a).max()) + 1e-6 * top, (i, key)


def test_zero1_partitions_the_moments(runs):
    _, _, results, _ = runs
    held = [res["train"]["moment_bytes"] for res in results[2]]
    total = results[2][0]["train"]["total_moment_bytes"]
    leaf = results[2][0]["train"]["largest_leaf_bytes"]
    assert sum(held) == total           # each moment on exactly one rank
    assert max(held) - min(held) <= leaf
    assert max(held) <= total / 2 + leaf


def test_train_cli_mesh_zero1_end_to_end(runs):
    """``train --mesh 2,1,1 --zero1`` on two ranks, then resumed to step 2:
    rank 0 alone wrote the checkpoints and the metrics."""
    _, _, _, tmps = runs
    ck = os.path.join(tmps[2], "ck_cli")
    assert checkpoint.all_steps(ck) == [1, 2]
    losses = _losses(ck)
    assert len(losses) == 2 and all(np.isfinite(losses))
    log = open(os.path.join(tmps[2], "log0.txt")).read()
    assert "resumed from step 1" in log and "ZeRO-1" in log
    saved, opt_state, _ = checkpoint.restore_train_state(ck)
    model = train._build_model(train.TrainConfig(node_dim=32, pair_dim=16, n_blocks=1,
                                                 n_recycle=0), torch.device("cpu"))
    model.load_state_dict(saved)
    assert len(opt_state["adamw"]["state"]) == len(saved)
