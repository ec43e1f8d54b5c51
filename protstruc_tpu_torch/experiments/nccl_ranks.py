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
the ring (forward and backward) and the two trainers' steps.  This module
imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def counted():
    """Count the ``torch.distributed`` calls the port makes (it calls them
    through the module's attributes)."""
    counts, saved = dict.fromkeys(CALLS, 0), {n: getattr(dist, n) for n in CALLS}

    def wrap(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call

    for n in CALLS:
        setattr(dist, n, wrap(n, saved[n]))
    try:
        yield counts
    finally:
        for n in CALLS:
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
        say(f"{dist.get_world_size()} ranks on gloo (CPU)")
    t0 = time.perf_counter()
    for fn in (ring_check, featurize_check, pipeline_check, train_check):
        fn(dev, say)
    say(f"nccl_ranks: every check passed in {time.perf_counter() - t0:.2f} s")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
