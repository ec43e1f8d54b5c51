"""The scale-out path across four ranks: ring attention, ``featurize_sharded``,
``pipeline_apply`` and the data-parallel trainer with ZeRO-1, each on one
process group (NCCL on cards, one card a rank; gloo on the CPU) and held
against the same computation in one process.

    torchrun --nproc_per_node 4 -m protstruc_tpu_torch.experiments.nccl_ranks [--device cpu]

(``python -m torch.distributed.run`` where ``torchrun`` is not on PATH.)
Every rank runs every check in order; rank 0 prints, and any rank whose
check fails raises, which ends the run non-zero.  The checks:

* ``ring_attention_sharded`` over a ``(1, 4, 1)`` mesh, f32, B=2, H=4,
  dh=32, L=256, the third key block of structure 1 masked off: each rank's
  output block and its blocks of dq, dk, dv and dbias (its query rows)
  against ``flash_pair_bias_attention`` over all of L with the same
  cotangent, within 2e-5 (out), 5e-5 (dq, dk, dv) and 5e-4 (dbias) times
  max(1, max|ref|); per step of the ring two exchanges forward (k and v,
  the key mask) and one back (the k and v cotangent), 9 in all;
* ``featurize_sharded(use_kernel=True)`` over ``(2, 2, 1)`` on four PDB
  structures padded to their bucket: each rank's maps, masks, dihedrals
  and frames bitwise equal to its block of the unsharded featurization;
* ``pipeline_apply`` over ``pp = 4`` of a 4-block TrFold (f32, node 64,
  pair 32, 4 heads, triangle updates, fused_tri and flash attention) on
  B=4, L=64 in 4 microbatches: outputs within 1e-5 times max(1, max|ref|)
  of ``model(feats)`` and each rank's parameter gradients (block d on rank
  d, the embeddings on rank 0, the heads everywhere) within 1e-4 of the
  leaf's largest plus 1e-6 of the model's;
* ``train --mesh 4,1,1 --zero1`` for 3 steps (B=4, crop 64, node 64, pair
  32, 2 blocks, f32) against the same 3 steps without a mesh on rank 0:
  losses within 1e-4 relative, and the AdamW moments the mesh run's
  checkpoint gathered from their owners within 1e-3 of each leaf's
  largest plus 1e-6 of the model's (a leaf whose gradient is all but 0
  holds rounding alone).

It also counts the ``torch.distributed`` calls each check made and times
the ring (forward and backward) and the two trainers' steps.

Model parallelism inside FoldModel, at ``experiments/fold_loo.py:57-63``'s
width (f32, D=128, P=64, 4 heads, 4 blocks, 6 IPA iterations, recycle 1,
triangle, remat, fused_tri, flash), B=4 of the bundled PDBs cropped to 256
by K3's featurization of the whole crop:

* ``fold_loss_fn`` over the meshes (1, 4, 1), (1, 2, 2) and (1, 1, 4)
  against the unsharded model on each rank's card: the loss (the ranks'
  shares summed) within 1e-5 relative, the gradients (summed over dp x sp,
  the tp-partial leaves over tp, gathered whole) within 1e-4 of each leaf's
  largest plus 1e-6 of the model's;
* ``train --mesh 2,2,1 --zero1`` and ``train --mesh 1,2,2`` (with a
  held-out evaluation, unsharded on rank 0) for 3 steps against the same
  steps without a mesh on rank 0: the first step's loss within 1e-5
  relative, the later ones within 1e-4 (Adam turns the runs' rounding on
  entries whose gradient is all but 0 into up to +-lr);
* MoEMLP with its experts over dp on (4, 1, 1) (``moe_param_shardings``):
  each rank's output block, the aux and the gradients against one process;
* timings: a train step (``fold_loss_fn``, backward, ``TrainOptimizer``)
  at (1, 4, 1) and (1, 1, 4) against one card, crop 256, B=4, and 8gpi at
  crop 1024, B=1: ms/step (host clock around synchronised steps, after
  warm-up), peak GiB a rank, and one step under torch.profiler: the device
  time of the NCCL kernels against the step's busy time (rank 0); then
  each kind of collective the step issued, timed alone at its mean payload
  in runs of back-to-back calls (``exchange_estimate``).

With ``--device cpu`` the model checks run at a rehearsal size (crop 32, 1
block, B=2 of the 4) and the timings are skipped.  This module imports
torch and numpy only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = pathlib.Path(__file__).resolve().parents[2]
DATA = REPO / "tests" / "data"
PDBS = ("1REX.pdb", "1ad0_DC.pdb", "4EOT.pdb", "15c8_HL.pdb")
# four structures of one length bucket (229-232 residues): every batch holds
# all four, one a dp rank
TRAIN_PDBS = ("15c8_HL.pdb", "1a3r_HL.pdb", "1a6v_HL.pdb", "1a6v_JN.pdb")
TRAIN_ARGV = ("--batch-size", "4", "--crop", "64", "--node-dim", "64", "--pair-dim", "32",
              "--blocks", "2", "--recycle", "0", "--pair-update", "triangle", "--seed", "0",
              "--steps", "3", "--save-every", "3")
CALLS = ("all_reduce", "all_gather", "broadcast", "all_gather_object", "batch_isend_irecv")
# the tensor forms parallel/collectives.py issues (torch 2.13 names them
# *_single; older releases only *_tensor); counted where this torch has them
TENSOR_CALLS = ("all_gather_single", "all_gather_into_tensor", "reduce_scatter_single",
                "reduce_scatter_tensor", "all_to_all")
# fold_loo.py:57-63 with --flash-attn (4 heads and 6 IPA iterations are
# TrainConfig's defaults), f32; crop and batch set per run
FOLD = dict(node_dim=128, pair_dim=64, n_blocks=4, n_recycle=1, pair_update="triangle", remat=True,
            fused_tri=True, use_flash_attn=True, seed=0)
FOLD_PDBS = ("4uuj.pdb", "8dtk.pdb", "6dc4.pdb", "1ad0_DC.pdb")   # 434-545 residues: all cropped
FOLD_MESHES = ((1, 4, 1), (1, 2, 2), (1, 1, 4))
SMALL = dict(n_blocks=1, crop_len=32, batch_size=2)               # --device cpu rehearsal


def _payload(args) -> int:
    """Bytes of a collective call's largest buffer: a list of tensors
    summed (``all_to_all``'s chunks), a list of ``P2POp``s its largest (a
    send and its receive move one buffer each way)."""
    best = 0
    for a in args:
        if isinstance(a, (list, tuple)):
            sizes = [t.numel() * t.element_size() for t in (getattr(x, "tensor", x) for x in a)
                     if torch.is_tensor(t)]
            p2p = any(hasattr(x, "tensor") for x in a)
            best = max(best, (max(sizes, default=0) if p2p else sum(sizes)))
        elif torch.is_tensor(a):
            best = max(best, a.numel() * a.element_size())
    return best


@contextlib.contextmanager
def counted(moved=None):
    """Count the ``torch.distributed`` calls the port makes (it calls them
    through the module's attributes); ``moved`` (a dict), when given, gets
    each call kind's payload bytes summed (``_payload``)."""
    names = CALLS + tuple(n for n in TENSOR_CALLS if hasattr(dist, n))
    counts, saved = dict.fromkeys(names, 0), {n: getattr(dist, n) for n in names}

    def wrap(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            if moved is not None:
                moved[name] = moved.get(name, 0) + _payload(a)
            return fn(*a, **kw)
        return call

    for n in names:
        setattr(dist, n, wrap(n, saved[n]))
    try:
        yield counts
    finally:
        for n in names:
            setattr(dist, n, saved[n])


def check(ok, what):
    if not ok:
        raise AssertionError(f"rank {dist.get_rank()}: {what}")


def within(ref, got, tol, what):
    err = float((ref.detach().float() - got.detach().float()).abs().max())
    check(err <= tol, f"{what}: {err:.3e} > {tol:.3e}")
    return err


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ring_check(dev, say):
    from protstruc_tpu_torch.ops.flash_attn import flash_pair_bias_attention
    from protstruc_tpu_torch.ops.ring_attn import ring_attention_sharded
    from protstruc_tpu_torch.parallel.mesh import make_mesh

    n, (B, L, H, dh) = dist.get_world_size(), (2, 256, 4, 32)
    mesh = make_mesh(axis_shapes=(1, n, 1))
    g = torch.Generator().manual_seed(0)
    q, k, v, ct = (torch.randn(B, L, H, dh, generator=g).to(dev) for _ in range(4))
    bias = torch.randn(B, H, L, L, generator=g).to(dev)
    kmask = torch.ones(B, L, dtype=torch.bool, device=dev)
    kmask[1, 2 * L // n:3 * L // n] = False
    r = dist.get_rank()
    rows = slice(r * L // n, (r + 1) * L // n)
    ins = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    with counted() as calls:
        sync(dev)
        t0 = time.perf_counter()
        out = ring_attention_sharded(*ins, kmask, mesh)
        (out * ct[:, rows]).sum().backward()
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
    ref_in = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    ref = flash_pair_bias_attention(*ref_in, kmask)
    (ref * ct).sum().backward()
    scale = lambda t: max(1.0, float(t.detach().abs().max()))  # noqa: E731
    errs = [within(ref[:, rows], out, 2e-5 * scale(ref), "ring out")]
    for name, a, b, dim, tol in (("dq", ref_in[0], ins[0], 1, 5e-5), ("dk", ref_in[1], ins[1], 1, 5e-5),
                                 ("dv", ref_in[2], ins[2], 1, 5e-5), ("dbias", ref_in[3], ins[3], 2, 5e-4)):
        ra, ga = a.grad.narrow(dim, rows.start, L // n), b.grad.narrow(dim, rows.start, L // n)
        errs.append(within(ra, ga, tol * scale(a.grad), f"ring {name}"))
    check(calls["batch_isend_irecv"] == 3 * (n - 1), f"ring exchanges {calls}")
    say(f"ring_attention_sharded n={n} f32 B={B} L={L} H={H} dh={dh}: ok, max err {max(errs):.3e}; "
        f"forward + backward {ms:.2f} ms on rank 0 (first call); calls {calls}")


def featurize_check(dev, say):
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.ops.pair_maps import MAP_NAMES
    from protstruc_tpu_torch.parallel.mesh import featurize_sharded, make_mesh, shard_batch
    from protstruc_tpu_torch.utils.buckets import pad_batch_to_bucket

    mesh = make_mesh(axis_shapes=(2, 2, 1))
    sb = pad_batch_to_bucket(pt.StructureBatch.from_pdb([str(DATA / p) for p in PDBS], device=dev))
    with counted() as calls:
        maps, d, m, frames = featurize_sharded(shard_batch(sb, mesh), mesh, use_kernel=True)
    full = sb.inter_residue_geometry(use_kernel=True)
    d0, m0 = sb.backbone_dihedrals()
    x = sb.xyz
    from protstruc_tpu_torch import geometry as geom
    f0 = geom.gram_schmidt(x[:, :, 0], x[:, :, 1], x[:, :, 2])
    bi, si = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    B, L = sb.batch_size, sb.n_residues
    b, rows = slice(bi * B // 2, (bi + 1) * B // 2), slice(si * L // 2, (si + 1) * L // 2)
    for key in (*MAP_NAMES, "d_ca_mask", "d_cb_mask", "d_no_mask"):
        a, c = full[key][b, rows], maps[key]
        check(a.shape == c.shape and torch.equal(a.nan_to_num(), c.nan_to_num())
              and torch.equal(a.isnan(), c.isnan()), f"featurize_sharded {key}")
    check(torch.equal(d0[b, rows].nan_to_num(), d.nan_to_num()) and torch.equal(m0[b, rows], m),
          "featurize_sharded dihedrals")
    check(torch.equal(f0[b, rows].nan_to_num(), frames.nan_to_num()), "featurize_sharded frames")
    check(calls["all_gather"] == 3, f"featurize_sharded gathers {calls}")
    say(f"featurize_sharded (2, 2, 1) B={B} L={L}: ok, bitwise equal to the unsharded featurization's "
        f"blocks; calls {calls}")


def pipeline_check(dev, say):
    from protstruc_tpu_torch import StructureBatch
    from protstruc_tpu_torch.models import trfold
    from protstruc_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size()
    mesh = make_mesh(axis_shapes=(n,), axis_names=("pp",))
    xyz = np.random.RandomState(1).randn(4, 64, 15, 3).astype(np.float32) * 5.0
    feats = trfold.featurize_for_model(StructureBatch.from_xyz(xyz, device=dev))
    cfg = trfold.TrFoldConfig(node_dim=64, pair_dim=32, n_heads=4, n_blocks=n, pair_update="triangle",
                              fused_tri=True, use_flash_attn=True)
    res = []
    for piped in (False, True):
        model = trfold.TrFold(cfg, device=dev)
        model.reset_parameters(torch.Generator().manual_seed(0))
        params = dict(model.named_parameters())
        with counted() as calls:
            out = (trfold.pipeline_apply(params, model, feats, mesh, n_microbatches=4) if piped
                   else model(feats))
            loss = sum((out[k].float() ** 2).mean() for k in sorted(out) if k != "moe_aux_loss")
            loss.backward()
        res.append((out, float(loss.detach()), {k: p.grad for k, p in params.items() if p.grad is not None},
                    calls))
    (out_r, loss_r, grads_r, _), (out, loss, grads, calls) = res
    err = max(within(out_r[k], out[k], 1e-5 * max(1.0, float(out_r[k].detach().abs().max())), f"pipeline {k}")
              for k in out_r)
    check(abs(loss - loss_r) <= 1e-5 * abs(loss_r), f"pipeline loss {loss} vs {loss_r}")
    d = dist.get_rank()
    heads = ("distogram_head", "torsion_head", "omega_head", "theta_head", "phi_head",
             "final_node_norm", "final_pair_norm")
    mine = [k for k in grads_r if k.startswith(f"block_{d}.") or k.startswith(heads)
            or (d == 0 and not k.startswith("block_"))]
    top = max(float(g.abs().max()) for g in grads_r.values())
    gerr = 0.0
    for k in mine:
        check(k in grads, f"pipeline: no gradient for {k} on rank {d}")
        scale = float(grads_r[k].abs().max())
        gerr = max(gerr, within(grads_r[k], grads[k], 1e-4 * scale + 1e-6 * top, f"pipeline grad {k}")
                   / max(scale, 1e-30))
    check(calls["batch_isend_irecv"] > 0, f"pipeline exchanges {calls}")
    say(f"pipeline_apply pp={n} M=4 TrFold {n} blocks B=4 L=64: ok, outputs within {err:.3e}, rank 0's "
        f"{len(mine)} gradient leaves within {gerr:.2e} of each leaf's largest; calls {calls}")


def train_check(dev, say):
    from protstruc_tpu_torch.__main__ import main as cli
    from protstruc_tpu_torch.models.checkpoint import restore_train_state

    n = dist.get_world_size()
    paths = [str(DATA / p) for p in TRAIN_PDBS]
    tmp = [tempfile.mkdtemp(prefix="nccl_ranks_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(tmp)
    res = {}
    for mesh_args in ((), ("--mesh", f"{n},1,1", "--zero1")):
        ck = pathlib.Path(tmp[0]) / ("mesh" if mesh_args else "plain")
        if mesh_args or dist.get_rank() == 0:
            argv = ["train", *paths, "--checkpoint-dir", str(ck), *TRAIN_ARGV, *mesh_args,
                    "--device", str(dev)]
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()), \
                    counted() as calls:
                sync(dev)
                t0 = time.perf_counter()
                check(cli(argv) == 0, f"train {' '.join(mesh_args)} returned non-zero")
                sync(dev)
                sec = time.perf_counter() - t0
            res[bool(mesh_args)] = (calls, sec)
        dist.barrier()
    if dist.get_rank() == 0:
        rows = {m: [json.loads(ln) for ln in (pathlib.Path(tmp[0]) / ("mesh" if m else "plain")
                                              / "metrics.jsonl").read_text().splitlines()]
                for m in (False, True)}
        losses = {m: [r["loss"] for r in rs if "loss" in r] for m, rs in rows.items()}
        check(len(losses[True]) == 3, f"mesh losses {losses}")
        for a, b in zip(losses[True], losses[False]):
            check(abs(a - b) <= 1e-4 * abs(b), f"train losses {losses}")
        moments = {m: restore_train_state(str(pathlib.Path(tmp[0]) / ("mesh" if m else "plain")))[1]
                   ["adamw"]["state"] for m in (False, True)}
        check(sorted(moments[True]) == sorted(moments[False]), "zero1 checkpoint leaves")
        merr = 0.0
        for key in ("exp_avg", "exp_avg_sq"):
            top = max(float(st[key].abs().max()) for st in moments[False].values())
            for i, st in moments[False].items():
                tol = 1e-3 * float(st[key].abs().max()) + 1e-6 * top
                merr = max(merr, within(st[key], moments[True][i][key], tol,
                                        f"zero1 moment {i} {key}") / tol)
        calls = res[True][0]
        check(all(calls[c] > 0 for c in ("all_reduce", "broadcast", "all_gather_object")),
              f"train --mesh collectives {calls}")
        say(f"train --mesh {n},1,1 --zero1 vs no mesh, 3 steps: ok, losses {losses[True]} vs "
            f"{losses[False]}, moments at worst {merr:.2e} of their tolerance; {res[True][1]:.2f} s "
            f"against {res[False][1]:.2f} s (each with its set-up); calls on rank 0 {calls}")
        import shutil
        shutil.rmtree(tmp[0], ignore_errors=True)
    dist.barrier()


def _fold_cfg(dev, **kw):
    from protstruc_tpu_torch.train import TrainConfig

    size = dict(crop_len=256, batch_size=4) if dev.type == "cuda" else dict(SMALL)
    return TrainConfig(**{**FOLD, **size, **kw})


def _fold_batch(dev, cfg, files=FOLD_PDBS, crop_seed=7):
    """The whole crop's K3 features, target xyz and batch (every rank the
    same: one generator)."""
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.train import _featurize

    sb = pt.StructureBatch.from_pdb([str(DATA / f) for f in files[:cfg.batch_size]], device=dev)
    feats, _, crop = _featurize(sb, cfg, _trunk_cfg(cfg),
                                generator=torch.Generator().manual_seed(crop_seed))
    return feats, crop.xyz


def _trunk_cfg(cfg):
    from protstruc_tpu_torch.models.trfold import TrFoldConfig

    return TrFoldConfig(node_dim=cfg.node_dim, pair_dim=cfg.pair_dim)


def _loss_grads(model, feats, xyz):
    from protstruc_tpu_torch.models.ipa import fold_loss_fn

    model.zero_grad(set_to_none=True)
    params = dict(model.named_parameters())
    loss = fold_loss_fn(params, model, feats, xyz)
    loss.backward()
    return loss.detach(), {k: p.grad if p.grad is not None else torch.zeros_like(p)
                           for k, p in params.items()}


def _whole_grads(model, grads):
    """A sharded model's gradients as the trainer reduces them, gathered
    whole (a collective)."""
    from protstruc_tpu_torch.models.checkpoint import gather_tp
    from protstruc_tpu_torch.models.ipa import ipa_param_shardings, tp_partial_grads
    from protstruc_tpu_torch.parallel.zero import sum_sharded_grads_

    specs = ipa_param_shardings(grads)
    sum_sharded_grads_(grads, model.shard, tp_partial_grads(specs))
    return gather_tp(grads, specs, model.shard)


def fold_check(dev, say):
    """fold_loss_fn over each FOLD_MESHES mesh against the unsharded model."""
    from protstruc_tpu_torch.models.checkpoint import load_whole_state
    from protstruc_tpu_torch.parallel.mesh import cut, make_mesh, shard_feats
    from protstruc_tpu_torch.train import _build_model

    cfg = _fold_cfg(dev)
    feats, xyz = _fold_batch(dev, cfg)
    plain = _build_model(cfg, dev)
    plain.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    loss_r, grads_r = _loss_grads(plain, feats, xyz)
    grads_r = {k: g.clone() for k, g in grads_r.items()}
    top = max(float(g.abs().max()) for g in grads_r.values())
    for shape in FOLD_MESHES:
        mesh = make_mesh(axis_shapes=shape)
        model = _build_model(dataclasses.replace(cfg, mesh_shape=shape), dev, mesh)
        load_whole_state(model, plain.state_dict())
        with counted() as calls:
            loss, grads = _loss_grads(model, shard_feats(feats, mesh), cut(xyz, ("dp", "sp"), mesh))
            total = loss.clone()
            dist.all_reduce(total, group=model.shard.data_group)
            whole = _whole_grads(model, grads)
        rel = abs(float(total) - float(loss_r)) / abs(float(loss_r))
        check(rel <= 1e-5, f"fold {shape} loss {float(total)!r} vs {float(loss_r)!r}")
        worst, leaf = 0.0, None
        for k, r in grads_r.items():
            ratio = float((whole[k] - r).abs().max()) / (1e-4 * float(r.abs().max()) + 1e-6 * top)
            if ratio > worst:
                worst, leaf = ratio, k
        check(worst <= 1.0, f"fold {shape} gradient {leaf}: {worst:.3e} of its budget")
        say(f"fold_loss_fn {shape} D={cfg.node_dim} P={cfg.pair_dim} {cfg.n_blocks} blocks B="
            f"{cfg.batch_size} crop {cfg.crop_len}: ok, loss {float(total)!r} vs one process "
            f"{float(loss_r)!r} ({rel:.2e}), worst gradient leaf {leaf} at {worst:.2e} of its budget; "
            f"ring {model.trunk_cfg.ring_mesh is not None}; calls {calls}")
        del model, grads, whole
    del plain, grads_r


def train_mesh_check(dev, say):
    """train --mesh 2,2,1 --zero1 and --mesh 1,2,2 (eval on rank 0, unsharded)
    for 3 steps against the same steps without a mesh on rank 0."""
    from protstruc_tpu_torch.__main__ import main as cli

    cfg = _fold_cfg(dev)
    paths = [str(DATA / p) for p in TRAIN_PDBS]
    argv = ["--batch-size", str(cfg.batch_size), "--crop", str(cfg.crop_len), "--node-dim", "128",
            "--pair-dim", "64", "--blocks", str(cfg.n_blocks), "--recycle", "1", "--pair-update",
            "triangle", "--remat", "--fused-tri", "--flash-attn", "--seed", "0", "--steps", "3",
            "--save-every", "3", "--device", str(dev)]
    tmp = [tempfile.mkdtemp(prefix="nccl_ranks_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(tmp)
    runs = {"plain": (), "2,2,1": ("--mesh", "2,2,1", "--zero1"),
            "1,2,2": ("--mesh", "1,2,2", "--eval", str(DATA / "1REX.pdb"))}
    secs = {}
    for name, extra in runs.items():
        if extra or dist.get_rank() == 0:
            err = io.StringIO()
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
                sync(dev)
                t0 = time.perf_counter()
                check(cli(["train", *paths, "--checkpoint-dir", str(pathlib.Path(tmp[0]) / name),
                           *argv, *extra]) == 0, f"train {name}: {err.getvalue()[-2000:]}")
                sync(dev)
                secs[name] = time.perf_counter() - t0
        dist.barrier()
    if dist.get_rank() == 0:
        losses = {name: [json.loads(ln)["loss"] for ln in (pathlib.Path(tmp[0]) / name / "metrics.jsonl")
                         .read_text().splitlines() if '"loss"' in ln] for name in runs}
        ref = losses["plain"]
        for name in ("2,2,1", "1,2,2"):
            got = losses[name]
            check(len(got) == 3, f"train --mesh {name} losses {got}")
            check(abs(got[0] - ref[0]) <= 1e-5 * abs(ref[0]), f"train --mesh {name} step 1 {got} vs {ref}")
            check(all(abs(a - b) <= 1e-4 * abs(b) for a, b in zip(got, ref)),
                  f"train --mesh {name} losses {got} vs {ref}")
        say(f"train --mesh 2,2,1 --zero1 and --mesh 1,2,2 (eval) vs no mesh, 3 steps at fold_loo's "
            f"width, B={cfg.batch_size} crop {cfg.crop_len}: ok, losses {losses}; seconds (set-up "
            f"included) {secs}")
        import shutil
        shutil.rmtree(tmp[0], ignore_errors=True)
    dist.barrier()


def moe_check(dev, say):
    """MoEMLP with its experts over dp on (4, 1, 1) against one process."""
    from protstruc_tpu_torch.models.moe import MoEMLP, moe_param_shardings
    from protstruc_tpu_torch.parallel.mesh import cut, cut_params, make_mesh

    n = dist.get_world_size()
    mesh = make_mesh(axis_shapes=(n, 1, 1))
    g = torch.Generator().manual_seed(5)
    x, ct = (torch.randn(n, 256, 128, generator=g).to(dev) for _ in range(2))
    mask = (torch.rand(n, 256, generator=g) > 0.2).to(dev)
    res = {}
    for ep in (False, True):
        m = MoEMLP(128, n_experts=8, hidden_dim=512, device=dev,
                   mesh=mesh if ep else None, ep_axis="dp" if ep else None)
        whole = MoEMLP(128, n_experts=8, hidden_dim=512, device=dev)
        whole.reset_parameters(torch.Generator().manual_seed(6))
        sd = whole.state_dict()
        m.load_state_dict(cut_params(sd, moe_param_shardings(sd, mesh), mesh) if ep else sd)
        xi = (cut(x, ("dp",), mesh) if ep else x).clone().requires_grad_()
        out, aux = m(xi, cut(mask, ("dp",), mesh) if ep else mask)
        c = cut(ct, ("dp",), mesh) if ep else ct
        with counted() as calls:
            ((out * c).sum() + aux / (n if ep else 1)).backward()
        res[ep] = (out.detach(), float(aux.detach()), xi.grad, m.w1.grad, calls)
    (out_r, aux_r, dx_r, w1_r, _), (out, aux, dx, w1, calls) = res[False], res[True]
    r, El = dist.get_rank(), 8 // n
    blk = slice(r, r + 1)
    scale = lambda t: max(1.0, float(t.abs().max()))  # noqa: E731
    errs = [within(out_r[blk], out, 1e-5 * scale(out_r), "moe out"),
            within(dx_r[blk], dx, 1e-5 * scale(dx_r), "moe dx"),
            within(w1_r[r * El:(r + 1) * El], w1, 1e-5 * scale(w1_r), "moe w1 grad")]
    check(abs(aux - aux_r) <= 1e-6 * max(1.0, abs(aux_r)), f"moe aux {aux} vs {aux_r}")
    say(f"MoEMLP (8 experts, D=128, H=512) over dp={n} (moe_param_shardings) B={n} L=256: ok, max err "
        f"{max(errs):.3e}, aux {aux:.6f} vs {aux_r:.6f}; backward calls {calls}")


def _step_timing(dev, cfg, mesh, feats, xyz, reps):
    """ms/step of a train step on this rank (host clock around synchronised
    steps after two warm-ups; every rank steps together), peak GiB, one step
    under torch.profiler (NCCL device ms, busy device ms), and one step's
    collectives ({kind: calls}, {kind: payload bytes})."""
    from protstruc_tpu_torch.models.checkpoint import load_whole_state
    from protstruc_tpu_torch.parallel.mesh import cut, shard_feats
    from protstruc_tpu_torch.train import TrainOptimizer, _build_model, train_step

    plain = _build_model(cfg, dev)
    plain.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    model = plain if mesh is None else _build_model(cfg, dev, mesh)
    if mesh is not None:
        load_whole_state(model, plain.state_dict())
        del plain
        feats, xyz = shard_feats(feats, mesh), cut(xyz, ("dp", "sp"), mesh)
    params = dict(model.named_parameters())
    opt = TrainOptimizer(params, cfg, shard=model.shard)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        train_step(model, params, opt, feats, None, xyz)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        train_step(model, params, opt, feats, None, xyz)
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    moved = {}
    with counted(moved) as calls:
        train_step(model, params, opt, feats, None, xyz)
        sync(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_step(model, params, opt, feats, None, xyz)
        sync(dev)
    busy = sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
               for ev in prof.key_averages()) / 1e3
    nccl = _nccl_ms(prof)
    del model, params, opt
    torch.cuda.empty_cache()
    return ms, peak, nccl, busy, {k: n for k, n in calls.items() if n}, moved


#: how the port issues each call kind, to time it alone: (x of ``nbytes``
#: bytes, group) -> the call
def _alone(kind, x, group):
    n = dist.get_world_size(group)
    if kind in ("all_gather_into_tensor", "all_gather_single"):
        out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
        return lambda: getattr(dist, kind)(out, x, group=group)
    if kind in ("reduce_scatter_tensor", "reduce_scatter_single"):
        out = torch.empty(x.numel() // n, dtype=x.dtype, device=x.device)
        return lambda: getattr(dist, kind)(out, x[:out.numel() * n], group=group)
    if kind == "all_reduce":
        return lambda: dist.all_reduce(x, group=group)
    if kind == "all_to_all":
        chunks = list(x[:x.numel() // n * n].chunk(n))
        outs = [torch.empty_like(c) for c in chunks]
        return lambda: dist.all_to_all(outs, chunks, group=group)
    if kind == "batch_isend_irecv":   # the ring's exchange: to rank r - 1, from r + 1
        r = dist.get_rank(group)
        buf = torch.empty_like(x)
        to, frm = (dist.get_global_rank(group, (r + s) % n) for s in (-1, 1))

        def call():
            for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, to, group),
                                             dist.P2POp(dist.irecv, buf, frm, group)]):
                w.wait()
        return call
    return None


#: back-to-back calls in one timed run of a call kind, and the runs of each
EXCHANGE_ITERS, EXCHANGE_RUNS = 25, 3


def _nccl_ms(prof) -> float:
    """The NCCL kernels' device ms in a profile."""
    return sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
               for ev in prof.key_averages() if "nccl" in ev.key.lower()) / 1e3


def exchange_estimate(dev, calls, moved):
    """Each call kind of a step timed alone at its mean payload on the four
    ranks.  A run is ``EXCHANGE_ITERS`` back-to-back calls issued after a
    barrier and a device sync on every rank, so a rank's late start is
    spread over the run: CUDA events around each of ``EXCHANGE_RUNS`` runs
    (ms a call: the fastest run's mean and the slowest's), then one run under
    torch.profiler (the NCCL kernels' device ms a call).  Returns ({kind:
    (calls, mean MB, fastest ms, slowest ms, kernel ms)}, the step's transfer
    time: the sum of calls x fastest ms a call)."""
    out, total = {}, 0.0
    for kind, n in calls.items():
        nbytes = moved.get(kind, 0) // max(n, 1)
        x = torch.randn(max(nbytes // 4, 4 * dist.get_world_size()), device=dev)
        fn = _alone(kind, x, dist.group.WORLD)
        if fn is None or nbytes == 0:
            continue
        for _ in range(3):
            fn()
        runs = []
        for _ in range(EXCHANGE_RUNS):
            dist.barrier()
            sync(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(EXCHANGE_ITERS):
                fn()
            end.record()
            sync(dev)
            runs.append(start.elapsed_time(end) / EXCHANGE_ITERS)
        dist.barrier()
        sync(dev)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(EXCHANGE_ITERS):
                fn()
            sync(dev)
        out[kind] = (n, nbytes / 1e6, min(runs), max(runs), _nccl_ms(prof) / EXCHANGE_ITERS)
        total += n * min(runs)
    return out, total


def timing_check(dev, say, smi):
    """Train-step timings at (1, 4, 1) and (1, 1, 4) against one card, at
    crop 256 B=4 and for 8gpi at crop 1024 B=1."""
    from protstruc_tpu_torch.parallel.mesh import make_mesh

    for crop, files in ((256, FOLD_PDBS), (1024, ("8gpi.pdb",))):
        cfg = _fold_cfg(dev, crop_len=crop, batch_size=len(files))
        feats, xyz = _fold_batch(dev, cfg, files)
        rows, exch = {}, {}
        if dist.get_rank() == 0:
            rows["one card"] = _step_timing(dev, cfg, None, feats, xyz, 3)
        dist.barrier()
        for shape in ((1, 4, 1), (1, 1, 4)):
            mesh = make_mesh(axis_shapes=shape)
            rows[shape] = _step_timing(dev, dataclasses.replace(cfg, mesh_shape=shape), mesh,
                                       feats, xyz, 3)
            peaks = torch.tensor([rows[shape][1]], device=dev)
            dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
            rows[shape] = (rows[shape][0], float(peaks), *rows[shape][2:])
            exch[shape] = exchange_estimate(dev, *rows[shape][4:])
        say(f"timing train step D=128 P=64 4 blocks recycle 1 f32 B={cfg.batch_size} crop {crop} "
            f"({', '.join(files)}) [{smi.splitlines()[0]} x {dist.get_world_size()}]: " + "; ".join(
                f"{k}: {r[0]:.2f} ms/step, peak {r[1]:.2f} GiB a rank, profiled step NCCL {r[2]:.2f} "
                f"of {r[3]:.2f} ms device busy (rank 0)" for k, r in rows.items()))
        for shape, (kinds, total) in exch.items():
            say(f"  exchanges of one {shape} step (rank 0; alone, {EXCHANGE_ITERS} calls a run, "
                f"ms a call: fastest-slowest of {EXCHANGE_RUNS} runs by CUDA events, NCCL kernel "
                "time by torch.profiler): " + "; ".join(
                    f"{k} {n} calls of {mb:.3f} MB, {lo:.4f}-{hi:.4f} ms, kernel {kern:.4f} ms"
                    for k, (n, mb, lo, hi, kern) in kinds.items())
                + f"; transfer {total:.2f} ms of the {rows[shape][0]:.2f} ms step")
        del feats, xyz


def main(argv=()) -> int:
    from protstruc_tpu_torch.parallel.mesh import init_distributed

    device = "cpu" if list(argv) == ["--device", "cpu"] else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("nccl_ranks: no CUDA device (pass --device cpu for gloo ranks)", file=sys.stderr)
        return 1
    if device == "cpu":
        torch.set_num_threads(1)
    dev = init_distributed(device)
    rank = dist.get_rank()

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    if dev.type == "cuda":
        import subprocess

        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        say(f"{dist.get_world_size()} ranks on NCCL: {smi}")
    else:
        smi = None
        say(f"{dist.get_world_size()} ranks on gloo (CPU)")
    t0 = time.perf_counter()
    for fn in (ring_check, featurize_check, pipeline_check, train_check, fold_check,
               train_mesh_check, moe_check):
        fn(dev, say)
    if dev.type == "cuda":
        timing_check(dev, say, smi)
    say(f"nccl_ranks: every check passed in {time.perf_counter() - t0:.2f} s")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
