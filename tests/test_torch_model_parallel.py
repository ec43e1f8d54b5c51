"""Model parallelism inside FoldModel on gloo ranks: the port's sharded runs
against the JAX package's mesh run and the one-process port, on the CPU.

One group of four ranks (``tests/torch_mp_workers.py``, torch and the port
only; a ``FileStore`` under the test's tmp dir; every collective under a 90 s
timeout; the spawns joined with a time limit that fails the test) runs the
meshes ``(1, 2, 2)``, ``(1, 4, 1)`` and ``(2, 1, 2)`` in turn.  While it
runs, this process computes the references:

* ``fold_loss_fn``'s value and gradients for ``triangle`` and ``gated_mix``
  (the flash ``gated_mix`` with MoE blocks: 4 experts, replicated, the aux
  on every rank against the one-process port's) (and, against the
  one-process port alone, the unfused triangle under the ``dots`` policy),
  flash attention on (the ring over sp on the plain local attention) and off
  (the keys and values gathered), fused_tri on (K4-K7's plain versions),
  remat with the ``tri_dots`` and ``none`` policies on two of the four, at
  node 32, pair 16, 4 heads, 1 block, 2 IPA iterations, B = 4, L = 32 (one
  structure two chains, a residue without atoms, three padded): the JAX
  package's run on its (1, 2, 2) mesh of the conftest's virtual devices
  (the four compiled on threads) and the one-process port.  Every mesh's
  loss (its ranks' shares summed) within 1e-5 relative; its gradients,
  reduced as the trainer reduces them and gathered whole, within 1e-4 of
  each leaf's largest plus 1e-6 of the model's; its forward outputs'
  blocks within 1e-5 x max(1, max|ref|) of the one-process port's;
* ``MoEMLP`` with its experts over dp on ``(4, 1, 1)``: each rank's output
  block against the JAX layer under ``moe_param_shardings`` on a 4-device
  mesh (1e-5) and the one-process port, the aux, and the input, expert and
  router gradients against the one-process port;
* ``train --mesh 1,2,2 --zero1`` (2 steps, resumed to 3) and ``train --mesh
  2,2,1`` (3 steps) against the one-process ``train`` on the same data:
  each step's loss (1e-5 relative) and the parameters after 3 steps; the
  mesh checkpoint folds in one process (``load_fold_model``, the ``fold``
  command, the server's ``fold`` op);
* each collective against its transpose (the inner-product identity) on
  the four ranks, and the errors a mesh raises.

The cheap cases run here alone: the four sharding rules against JAX's
``PartitionSpec``s leaf by leaf, ``fused_triangle_multiplication`` on row
blocks against the square call, each collective on a one-rank group.
"""

import concurrent.futures
import io
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from protstruc_tpu import StructureBatch as JaxBatch
from protstruc_tpu.models import ipa as jipa
from protstruc_tpu.models import moe as jmoe
from protstruc_tpu.models import trfold as jtrfold
from protstruc_tpu_torch import train
from protstruc_tpu_torch.convert import foldmodel_params_from_flax, foldmodel_params_to_flax
from protstruc_tpu_torch.models import checkpoint, ipa, moe, trfold
from protstruc_tpu_torch.ops.tri_mul import fused_triangle_multiplication
from protstruc_tpu_torch.parallel import collectives as col
from tests.conftest import pdb_path
from tests.test_torch_ipa import _zero_grad_entries
from tests.test_torch_parity import DEVICE, assert_parity

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_workers.py")
WORLD = 4
SPAWN_LIMIT = 300      # seconds the group may take, start to finish
MESHES = [(1, 2, 2), (1, 4, 1), (2, 1, 2)]
WIDTHS = dict(node_dim=32, pair_dim=16, n_heads=4, n_blocks=1)
IPA = dict(n_heads=4, n_iter=2)
CONFIGS = {
    "triangle_flash": dict(pair_update="triangle", fused_tri=True, use_flash_attn=True,
                           remat=True, remat_policy="tri_dots", n_recycle=1),
    "triangle_einsum": dict(pair_update="triangle", fused_tri=True),
    # with MoE blocks: experts replicated, the dispatched slots summed over
    # dp x sp with capacity offsets from the lower sp ranks, the aux shared out
    "gated_flash": dict(pair_update="gated_mix", fused_tri=True, use_flash_attn=True,
                        moe_experts=4),
    "gated_einsum": dict(pair_update="gated_mix", fused_tri=True, remat=True),
}
#: against the one-process port only (no JAX compile): the unfused triangle
#: updates under the ``dots`` remat policy
PORT_ONLY = {"triangle_unfused": dict(pair_update="triangle", fused_tri=False, use_flash_attn=True,
                                      remat=True, remat_policy="dots")}
B, L = 4, 32
MOE_DIMS = (4, 16, 24)   # experts, dim, hidden
TRAIN_PDBS = ("15c8_HL.pdb", "1a6v_HL.pdb", "1a3r_HL.pdb", "1a6v_JN.pdb")   # one 256 bucket
TRAIN_ARGV = ["--batch-size", "2", "--node-dim", "32", "--pair-dim", "16", "--blocks", "1",
              "--recycle", "0", "--crop", "24", "--save-every", "1", "--lr", "1e-3",
              "--ema-decay", "0.9", "--pair-update", "triangle", "--fused-tri", "--flash-attn",
              "--remat", "--remat-policy", "tri_dots"]
TRAIN_CFG = dict(batch_size=2, node_dim=32, pair_dim=16, n_blocks=1, n_recycle=0, crop_len=24,
                 save_every=1, learning_rate=1e-3, ema_decay=0.9, pair_update="triangle",
                 fused_tri=True, use_flash_attn=True, remat=True, remat_policy="tri_dots",
                 steps=3)


def _inputs():
    rng = np.random.RandomState(0)
    xyz = (rng.randn(B, L, 15, 3) * 5).astype(np.float32)
    xyz[1, 5] = np.nan                       # a residue without atoms
    feats = {k: np.array(v) for k, v in
             jtrfold.featurize_for_model(JaxBatch.from_xyz(xyz)).items()}
    feats["seq_idx"] = rng.randint(0, 20, (B, L)).astype(np.int32)
    feats["chain_idx"][2, 20:] = 1           # two chains: the relative positions' last class
    feats["residue_mask"][3, -3:] = False    # padding
    params = {}
    for name, kw in {**CONFIGS, **PORT_ONLY}.items():
        model = ipa.FoldModel(trfold.TrFoldConfig(**WIDTHS, pair_update=kw["pair_update"],
                                                  moe_experts=kw.get("moe_experts", 0)),
                              ipa.IPAConfig(**IPA), n_recycle=kw.get("n_recycle", 0),
                              device=DEVICE)
        model.reset_parameters(torch.Generator().manual_seed(3))
        params[name] = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        # the zero-initialised backbone update would leave the structure at the origin
        upd = rng.randn(*params[name]["structure.backbone_update.update.kernel"].shape) * 0.05
        params[name]["structure.backbone_update.update.kernel"] = upd.astype(np.float32)
    E, D, H = MOE_DIMS
    m = moe.MoEMLP(D, n_experts=E, hidden_dim=H, device=DEVICE)
    m.reset_parameters(torch.Generator().manual_seed(4))
    moe_x = rng.randn(WORLD, 6, D).astype(np.float32)
    moe_mask = rng.rand(WORLD, 6) > 0.25
    return {"xyz": xyz, "feats": feats, "params": params, "widths": WIDTHS, "ipa": IPA,
            "configs": {**CONFIGS, **PORT_ONLY}, "meshes": MESHES, "moe_dims": MOE_DIMS,
            "moe_params": {k: v.numpy().copy() for k, v in m.state_dict().items()},
            "moe_x": moe_x, "moe_mask": moe_mask,
            "moe_ct": rng.randn(*moe_x.shape).astype(np.float32),
            "train_paths": [pdb_path(p) for p in TRAIN_PDBS], "train_argv": TRAIN_ARGV}


def _spawn(tmp):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    logs = [open(os.path.join(tmp, f"log{r}.txt"), "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), tmp], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
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
            for r in range(WORLD)]


def _jax_mesh(shape):
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                ("dp", "sp", "tp"))


def _jax_fold(inp, name):
    """JAX's fold_loss_fn and its gradients on the (1, 2, 2) mesh."""
    mesh = _jax_mesh((1, 2, 2))
    kw = dict(CONFIGS[name])
    nr = kw.pop("n_recycle", 0)
    cfg = jtrfold.TrFoldConfig(**WIDTHS, **kw,
                               ring_mesh=mesh if kw.get("use_flash_attn") else None)
    model = jipa.FoldModel(trunk_cfg=cfg, ipa_cfg=jipa.IPAConfig(**IPA), n_recycle=nr)
    params = jax.tree_util.tree_map(jnp.asarray, foldmodel_params_to_flax(
        {k: torch.from_numpy(v) for k, v in inp["params"][name].items()}))
    params = jax.device_put(params, jipa.ipa_param_shardings(params, mesh))
    fs = jtrfold.feats_shardings(mesh)
    feats = {k: jax.device_put(jnp.asarray(v), fs[k]) for k, v in inp["feats"].items()}
    xyz = jax.device_put(jnp.asarray(inp["xyz"]), NamedSharding(mesh, P("dp", "sp", None, None)))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, f, x: jipa.fold_loss_fn(p, model, f, x)))(params, feats, xyz)
    return float(loss), {k: v.numpy() for k, v in foldmodel_params_from_flax(
        jax.tree_util.tree_map(np.asarray, grads)).items()}


def _port_fold(inp, name):
    """The one-process port: loss, gradients, forward outputs, MoE aux."""
    kw = dict({**CONFIGS, **PORT_ONLY}[name])
    nr = kw.pop("n_recycle", 0)
    model = ipa.FoldModel(trfold.TrFoldConfig(**WIDTHS, **kw), ipa.IPAConfig(**IPA), n_recycle=nr,
                          device=DEVICE)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["params"][name].items()})
    params = dict(model.named_parameters())
    feats = {k: torch.from_numpy(v) for k, v in inp["feats"].items()}
    loss = ipa.fold_loss_fn(params, model, feats, torch.from_numpy(inp["xyz"]))
    loss.backward()
    with torch.no_grad():
        out = model(feats)
    return (float(loss), {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
                          for k, p in params.items()},
            {k: out[k].numpy() for k in ("xyz", "distogram_logits", "omega_sincos",
                                         "pae_logits", "plddt_logits")},
            float(out["moe_aux_loss"]))


def _jax_moe(inp):
    """JAX's MoEMLP with moe_param_shardings over dp on a (4, 1, 1) mesh."""
    mesh = _jax_mesh((WORLD, 1, 1))
    E, _, H = MOE_DIMS
    mod = jmoe.MoEMLP(n_experts=E, hidden_dim=H)
    tree = jax.tree_util.tree_map(jnp.asarray, foldmodel_params_to_flax(
        {k: torch.from_numpy(v) for k, v in inp["moe_params"].items()}))
    tree = jax.device_put(tree, jmoe.moe_param_shardings(tree, mesh, ep_axis="dp"))
    x = jax.device_put(jnp.asarray(inp["moe_x"]), NamedSharding(mesh, P("dp", None, None)))
    mask = jax.device_put(jnp.asarray(inp["moe_mask"]), NamedSharding(mesh, P("dp", None)))
    out, aux = jax.jit(lambda p, a, m: mod.apply({"params": p}, a, m))(tree, x, mask)
    return np.asarray(out), float(aux)


def _port_moe(inp):
    E, D, H = MOE_DIMS
    m = moe.MoEMLP(D, n_experts=E, hidden_dim=H, device=DEVICE)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in inp["moe_params"].items()})
    x = torch.from_numpy(inp["moe_x"]).requires_grad_()
    out, aux = m(x, torch.from_numpy(inp["moe_mask"]))
    ((out * torch.from_numpy(inp["moe_ct"])).sum() + aux).backward()
    return {"out": out.detach().numpy(), "aux": float(aux), "dx": x.grad.numpy(),
            "w1": m.w1.grad.numpy(), "b2": m.b2.grad.numpy(),
            "router": [m.router.kernel.grad.numpy(), m.router.bias.grad.numpy()]}


def _single_train(tmp):
    """The one-process runs: 3 steps (``--mesh 2,2,1``'s reference), and 2
    steps resumed to 3 (``--mesh 1,2,2``'s: a resume starts the data over)."""
    paths = [pdb_path(p) for p in TRAIN_PDBS]
    cks = {"221": os.path.join(tmp, "ck_single"), "122": os.path.join(tmp, "ck_resumed")}
    train.train(paths, cks["221"], train.TrainConfig(**TRAIN_CFG), log_fn=lambda *a: None,
                device=DEVICE)
    for steps in (2, 3):
        train.train(paths, cks["122"], train.TrainConfig(**dict(TRAIN_CFG, steps=steps)),
                    log_fn=lambda *a: None, device=DEVICE)
    return cks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks started first; the references computed here while they
    run (the JAX mesh runs compiled on threads); then every rank's results."""
    inp = _inputs()
    tmp = str(tmp_path_factory.mktemp("mp"))
    torch.save(inp, os.path.join(tmp, "inputs.pt"))
    start = time.time()
    procs, logs = _spawn(tmp)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(CONFIGS)) as ex:
            jax_futs = {k: ex.submit(_jax_fold, inp, k) for k in CONFIGS}
            refs = {"port": {k: _port_fold(inp, k) for k in {**CONFIGS, **PORT_ONLY}},
                    "moe_port": _port_moe(inp), "moe_jax": _jax_moe(inp),
                    "train_ck": _single_train(str(tmp_path_factory.mktemp("single")))}
            refs["jax"] = {k: f.result() for k, f in jax_futs.items()}
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return inp, refs, _join(procs, logs, tmp, start), tmp


def _assemble(blocks, shape, name):
    """The global (B, L, ...) output from the ranks' blocks (tp ranks hold the
    same block; take tp index 0)."""
    dp, sp, tp = shape
    rows = []
    for d in range(dp):
        rows.append(np.concatenate([blocks[(d * sp + s) * tp][name] for s in range(sp)], axis=1))
    return np.concatenate(rows, axis=0)


def _grads_close(got, ref, who):
    top = max(float(np.abs(r).max()) for r in ref.values())
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, (who, k)
        budget = 1e-4 * float(np.abs(r).max()) + 1e-6 * top
        assert float(np.abs(g - r).max()) <= budget, (who, k, float(np.abs(g - r).max()), budget)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_fold_loss_matches_jax_mesh_and_one_process(runs, shape, config):
    _, refs, results, _ = runs
    jax_loss, jax_grads = refs["jax"][config]
    port_loss, port_grads, _, port_aux = refs["port"][config]
    got = results[0][shape][config]
    assert got["ring"] == (CONFIGS[config].get("use_flash_attn", False) and shape[1] > 1)
    for res in results:   # every rank holds the global MoE aux (0 without experts)
        aux = res[shape][config]["aux"]
        assert abs(aux - port_aux) <= 1e-5 * max(1.0, abs(port_aux)), (aux, port_aux)
    if CONFIGS[config].get("moe_experts"):
        assert port_aux > 0
    for r, res in enumerate(results):   # every rank holds the same global loss
        loss = res[shape][config]["loss"]
        for ref in (jax_loss, port_loss):
            assert abs(loss - ref) <= 1e-5 * abs(ref), (r, loss, ref)
    _grads_close(got["grads"], jax_grads, "jax")
    _grads_close(got["grads"], port_grads, "port")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_unfused_triangle_matches_one_process(runs, shape):
    """fused_tri off (the plain triangle updates on the rows, the sharded
    contractions) under the ``dots`` remat policy: loss and gradients."""
    _, refs, results, _ = runs
    port_loss, port_grads = refs["port"]["triangle_unfused"][:2]
    got = results[0][shape]["triangle_unfused"]
    assert got["ring"] == (shape[1] > 1)
    for res in results:
        loss = res[shape]["triangle_unfused"]["loss"]
        assert abs(loss - port_loss) <= 1e-5 * abs(port_loss), (loss, port_loss)
    _grads_close(got["grads"], port_grads, "port")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_forward_blocks_match_one_process(runs, shape):
    _, refs, results, _ = runs
    for config in {**CONFIGS, **PORT_ONLY}:
        ref = refs["port"][config][2]
        blocks = [res[shape][config]["out"] for res in results]
        for name, r in ref.items():
            got = _assemble(blocks, shape, name)
            assert_parity(r, got, 1e-5 * max(1.0, float(np.abs(r).max())), f"{config} {name}")


def test_moe_expert_parallel_matches_jax(runs):
    _, refs, results, _ = runs
    out_j, aux_j = refs["moe_jax"]
    port = refs["moe_port"]
    got = np.concatenate([res["moe"]["out"] for res in results])
    assert_parity(out_j, got, 1e-5, "moe out vs jax")
    assert_parity(port["out"], got, 1e-5, "moe out vs port")
    El = MOE_DIMS[0] // WORLD
    for r, res in enumerate(results):
        m = res["moe"]
        assert abs(m["aux"] - aux_j) <= 1e-6 * max(1.0, abs(aux_j))
        assert_parity(port["dx"][r:r + 1], m["dx"], 1e-5, "dx")
        for k in ("w1", "b2"):   # this rank's experts
            ref = port[k][r * El:(r + 1) * El]
            assert_parity(ref, m[k], 1e-5 * max(1.0, float(np.abs(ref).max())), k)
        for ref, g in zip(port["router"], m["router"]):
            assert_parity(ref, g, 1e-5 * max(1.0, float(np.abs(ref).max())), "router")


def _losses(ck):
    return [json.loads(line)["loss"] for line in open(os.path.join(ck, "metrics.jsonl"))
            if '"loss"' in line]


@pytest.mark.parametrize("mesh", ["122", "221"])
def test_train_mesh_equals_one_process(runs, mesh):
    """``train --mesh 1,2,2 --zero1`` (resumed at step 2, its checkpoint cut
    for the mesh) and ``--mesh 2,2,1`` take the one-process steps: each
    step's loss, then the whole parameters of the last checkpoint."""
    _, refs, _, tmp = runs
    ck = os.path.join(tmp, f"ck_{mesh}")
    single = refs["train_ck"][mesh]
    ref_losses, got_losses = _losses(single), _losses(ck)
    assert len(ref_losses) == len(got_losses) == 3
    for a, b in zip(ref_losses, got_losses):
        assert abs(a - b) <= 1e-5 * abs(a), (ref_losses, got_losses)
    p_ref, o_ref, s_ref = checkpoint.restore_train_state(single)
    p_got, o_got, s_got = checkpoint.restore_train_state(ck)
    assert s_ref == s_got == 3
    lr = TRAIN_CFG["learning_rate"]
    st_ref, st_got = o_ref["adamw"]["state"], o_got["adamw"]["state"]
    assert sorted(st_ref) == sorted(st_got)
    # each step's gradient, from the first moments of the checkpoints 1-3
    m = [[st["exp_avg"].numpy() for _, st in sorted(
          checkpoint.restore_train_state(single, step=s)[1]["adamw"]["state"].items())]
         for s in (1, 2, 3)]
    steps = [[m[0][i] / 0.1] + [(m[s][i] - 0.9 * m[s - 1][i]) / 0.1 for s in (1, 2)]
             for i in range(len(p_ref))]
    tops = [max(float(np.abs(g[s]).max()) for g in steps) for s in range(3)]
    for (k, r), gs in zip(p_ref.items(), steps):
        # whole leaves.  Adam moves an entry by lr * m / sqrt(v): a gradient
        # error e on an entry of gradient g moves it by about lr * e / |g|,
        # at most 2 lr a step.  e is the fold tests' budget, 1e-4 of the
        # leaf's largest plus 1e-6 of the model's; entries whose exact
        # gradient is 0 take the 2 lr
        r, g = r.numpy(), p_got[k].numpy()
        assert g.shape == r.shape, k
        tol = sum(np.minimum(2 * lr, 4 * lr * (1e-4 * np.abs(x).max() + 1e-6 * t)
                             / np.maximum(np.abs(x), 1e-30)) for x, t in zip(gs, tops))
        tol = np.where(_zero_grad_entries(k, r.shape), 2 * lr * 3, tol) + 1e-6
        assert (np.abs(g - r) <= tol).all(), (k, float(np.abs(g - r).max()))
    for key in ("exp_avg", "exp_avg_sq"):   # 1e-4 of the leaf's largest, 1e-6 of the model's
        top_k = max(float(st_ref[i][key].abs().max()) for i in st_ref)
        for i in st_ref:
            a, b = st_ref[i][key].numpy(), st_got[i][key].numpy()
            assert np.abs(a - b).max() <= 1e-4 * float(np.abs(a).max()) + 1e-6 * top_k, (i, key)
    if mesh == "122":
        log = open(os.path.join(tmp, "log0.txt")).read()
        assert "resumed from step 2" in log and "rings over sp=2" in log


def test_mesh_checkpoint_folds_in_one_process(runs, tmp_path, capsys):
    """The ``--mesh 1,2,2`` checkpoint (whole parameters) folds in one
    process: ``fold_sequence``, the ``fold`` command and the server's op."""
    from protstruc_tpu_torch.__main__ import main, serve_loop

    _, refs, _, tmp = runs
    ck = os.path.join(tmp, "ck_122")
    with pytest.warns(UserWarning):
        coords, plddt, pae = train.fold_sequence(ck, "MKVGAL", return_confidence=True,
                                                 device=DEVICE)
    assert coords.shape == (6, 5, 3) and torch.isfinite(coords).all()
    assert plddt.shape == (6,) and pae.shape == (6, 6)
    out = str(tmp_path / "f.pdb")
    with pytest.warns(UserWarning):
        assert main(["fold", "--checkpoint-dir", ck, "--seq", "MKVGA", "--out", out,
                     "--device", "cpu"]) == 0
    assert len([ln for ln in open(out) if ln.startswith("ATOM")]) == 5 * 5 - 1
    req = json.dumps({"op": "fold", "seq": "MKVGA", "out": str(tmp_path / "s.pdb")})
    resp = io.StringIO()
    with pytest.warns(UserWarning):
        serve_loop(io.StringIO(req + "\n" + json.dumps({"op": "shutdown"}) + "\n"), resp,
                   checkpoint_dir=ck, buckets=(64,), device="cpu")
    assert json.loads(resp.getvalue().splitlines()[0])["ok"]


def test_collectives_are_their_transposes(runs):
    """<f(x), y> = <x, f^T(y)> on the four ranks, each collective."""
    _, _, results, _ = runs
    adj = results[0]["adjoints"]
    assert sorted(adj) == sorted(["all_gather", "reduce_scatter", "all_to_all", "psum",
                                  "copy_to", "reduce_from", "split_to"])
    for name, (lhs, rhs) in adj.items():
        assert abs(lhs - rhs) <= 1e-9 * max(1.0, abs(lhs)), name


def test_mesh_errors(runs):
    """L % sp and n_heads % tp raise ValueError on the ranks; a mesh whose
    dp * sp * tp is not the world size raises before any group starts."""
    _, _, results, _ = runs
    errs = results[0]["errors"]
    assert "does not split over sp=4" in errs["L % sp"]
    assert "n_heads = 3 does not split over tp=2" in errs["n_heads % tp"]
    with pytest.raises(ValueError, match=r"needs dp\*sp\*tp = 8 ranks"):
        train.train([pdb_path(TRAIN_PDBS[0])], "unused", train.TrainConfig(mesh_shape=(2, 2, 2)),
                    device=DEVICE)


# ---------------------------------------------------------------------------
# the cheap cases, in this process
# ---------------------------------------------------------------------------


def _flat_specs(tree):
    return {".".join(str(p.key) for p in path): tuple(s.spec)
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("rule", ["param", "feats", "ipa", "moe"])
def test_sharding_rules_match_jax(rule):
    """Each rule's split of every leaf against JAX's ``PartitionSpec``."""
    mesh = _jax_mesh((2, 2, 2))
    if rule == "feats":
        ref = {k: tuple(v.spec) for k, v in jtrfold.feats_shardings(mesh).items()}
        assert ref == trfold.feats_shardings()
        return
    if rule == "moe":
        cfg = trfold.TrFoldConfig(**WIDTHS, moe_experts=4)
        names = trfold.TrFold(cfg, device=DEVICE).state_dict()
    elif rule == "param":
        names = trfold.TrFold(trfold.TrFoldConfig(**WIDTHS), device=DEVICE).state_dict()
    else:
        names = ipa.FoldModel(trfold.TrFoldConfig(**WIDTHS), ipa.IPAConfig(**IPA), n_recycle=1,
                              device=DEVICE).state_dict()
    tree = jax.tree_util.tree_map(lambda t: jax.ShapeDtypeStruct(t.shape, jnp.float32),
                                  foldmodel_params_to_flax(names))
    jfn = {"param": jtrfold.param_shardings, "ipa": jipa.ipa_param_shardings,
           "moe": lambda p, m: jmoe.moe_param_shardings(p, m, ep_axis="dp")}[rule]
    pfn = {"param": trfold.param_shardings, "ipa": ipa.ipa_param_shardings,
           "moe": lambda p, m: moe.moe_param_shardings(p, m, ep_axis="dp")}[rule]
    ref = _flat_specs(jfn(tree, mesh))
    got = pfn(names, None)
    assert ref == got
    assert any("tp" in s or "dp" in s for s in got.values())


@pytest.mark.parametrize("outgoing", [True, False])
def test_fused_tri_row_blocks_match_square(outgoing):
    """``fused_triangle_multiplication`` on 3 row blocks (a row mask, the
    column mask, a row-local contraction) against the square call's rows:
    the output, the a/b handed to the contraction, the pair's cotangent
    rows; the weight gradients summed over the blocks."""
    rng = np.random.RandomState(11)
    Bt, Lt, C = 2, 12, 8
    pair = torch.from_numpy(rng.randn(Bt, Lt, Lt, C).astype(np.float32))
    mask = torch.from_numpy(rng.rand(Bt, Lt) > 0.2)
    ct = torch.from_numpy(rng.randn(Bt, Lt, Lt, C).astype(np.float32))
    w = torch.from_numpy(rng.randn(Bt, Lt, Lt, C).astype(np.float32))
    names = ("ln_in", "ln_out", "a_gate", "a_proj", "b_gate", "b_proj", "out_gate", "out_proj")
    f32 = np.float32
    leaves = {n: ((torch.from_numpy((1.0 + 0.1 * rng.randn(C)).astype(f32)) if n.startswith("ln")
                   else torch.from_numpy((0.3 * rng.randn(C, C)).astype(f32))),
                  torch.from_numpy((0.1 * rng.randn(C)).astype(f32))) for n in names}

    def run(x, rows, cols, wrows):
        params = {n: tuple(t.clone().requires_grad_() for t in v) for n, v in leaves.items()}
        seen = {}

        def contract(a, b):   # row-local: each row's product from its own a, b
            seen["a"], seen["b"] = a.detach(), b.detach()
            return a * wrows + b
        x = x.clone().requires_grad_()
        out = fused_triangle_multiplication(x, rows, params, outgoing, col_mask=cols,
                                            contract=contract)
        return out, x, params, seen

    out_sq, x_sq, p_sq, seen_sq = run(pair, mask, mask, w)
    (out_sq * ct).sum().backward()
    wgrads = {n: [torch.zeros_like(t) for t in v] for n, v in leaves.items()}
    for i0, i1 in ((0, 5), (5, 8), (8, 12)):
        out, x, params, seen = run(pair[:, i0:i1], mask[:, i0:i1], mask, w[:, i0:i1])
        (out * ct[:, i0:i1]).sum().backward()
        assert torch.equal(out, out_sq[:, i0:i1])
        assert torch.equal(seen["a"], seen_sq["a"][:, i0:i1])
        assert torch.equal(seen["b"], seen_sq["b"][:, i0:i1])
        assert torch.equal(x.grad, x_sq.grad[:, i0:i1])
        for n in names:
            for acc, t in zip(wgrads[n], params[n]):
                acc += t.grad
    for n in names:
        for acc, t in zip(wgrads[n], p_sq[n]):
            assert float((acc - t.grad).abs().max()) <= 1e-5 * max(1.0, float(t.grad.abs().max()))


def test_collectives_on_one_rank_group():
    """A group of one rank runs every collective through the same code: each
    is the identity there, forward and backward, and its own transpose."""
    own = not dist.is_initialized()
    if own:
        dist.init_process_group("gloo", rank=0, world_size=1, store=dist.HashStore())
    try:
        g = dist.new_group([0])
        x = torch.randn(3, 4, 5, dtype=torch.float64, requires_grad=True)
        y = torch.randn(3, 4, 5, dtype=torch.float64)
        for f in (lambda z: col.all_gather(z, 1, g), lambda z: col.reduce_scatter(z, 1, g),
                  lambda z: col.all_to_all(z, 0, 2, g), lambda z: col.psum(z, g),
                  lambda z: col.copy_to(z, g), lambda z: col.reduce_from(z, g),
                  lambda z: col.split_to(z, 2, g)):
            x.grad = None
            out = f(x)
            assert torch.equal(out, x)
            (out * y).sum().backward()
            assert torch.equal(x.grad, y)
            assert abs(float((out * y).sum() - (x * x.grad).sum())) <= 1e-12
    finally:
        if own:
            dist.destroy_process_group()


def test_collectives_without_a_group_are_the_identity():
    """``group=None`` (an unsharded model) issues nothing: every collective
    returns its input itself, so the unsharded path keeps its graph."""
    x = torch.randn(3, 4, 5, requires_grad=True)
    for f in (lambda z: col.all_gather(z, 1, None), lambda z: col.reduce_scatter(z, 1, None),
              lambda z: col.all_to_all(z, 0, 2, None), lambda z: col.psum(z, None),
              lambda z: col.copy_to(z, None), lambda z: col.reduce_from(z, None),
              lambda z: col.split_to(z, 2, None)):
        assert f(x) is x


@pytest.mark.parametrize("rows", [(0, 12), (4, 5), (9, 3)])
def test_lddt_rows_are_the_rows_of_the_whole(rows):
    """``lddt(per_residue=True, rows=(r0, m))`` (a sequence-parallel rank's
    residues scored against every point) equals the same rows of the whole
    per-residue lDDT, bitwise."""
    from protstruc_tpu_torch.ops.metrics import lddt

    rng = np.random.RandomState(12)
    ref = torch.from_numpy((rng.randn(2, 12, 3) * 6).astype(np.float32))
    pred = ref + torch.from_numpy(rng.randn(2, 12, 3).astype(np.float32))
    mask = torch.from_numpy(rng.rand(2, 12) > 0.2)
    r0, m = rows
    whole = lddt(pred, ref, mask=mask, per_residue=True)
    assert torch.equal(lddt(pred, ref, mask=mask, per_residue=True, rows=rows),
                       whole[:, r0:r0 + m])
