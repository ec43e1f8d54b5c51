"""Command-line interface: ``python -m protstruc_tpu_torch <command>``.

    python -m protstruc_tpu_torch featurize 1rex.pdb --out feats.npz
    python -m protstruc_tpu_torch info
    python -m protstruc_tpu_torch serve --buckets 256,512
    python -m protstruc_tpu_torch train tests/data --checkpoint-dir ck --steps 8
    python -m protstruc_tpu_torch fold --checkpoint-dir ck --seq MKV... --out fold.pdb

Commands run on ``--device`` (default ``cuda``, which raises without a card;
pass ``--device cpu`` for host runs).  Ported so far: ``featurize``, ``info``,
``train``, ``fold`` and ``serve`` with its ``ping``, ``featurize`` and
``shutdown`` ops; the server answers ``analyze`` and ``fold`` with ``{"ok":
false, ...}``.  ``train --mesh``/``--zero1`` and ``fold --relax`` raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import sys

#: serve ops of the JAX package that this package does not have yet
_NOT_PORTED_OPS = ("analyze", "fold")


def _features_to_numpy(g, d, m, frames):
    out = {k: v.cpu().numpy() for k, v in g.items()}
    out["dihedrals"] = d.cpu().numpy()
    out["dihedral_mask"] = m.cpu().numpy()
    out["frames"] = frames.cpu().numpy()
    return out


def cmd_featurize(args) -> int:
    import numpy as np

    import protstruc_tpu_torch as ps

    sb = ps.StructureBatch.from_pdb(list(args.inputs), device=args.device)
    out = _features_to_numpy(sb.inter_residue_geometry(use_kernel=args.pallas),
                             *sb.backbone_dihedrals(), sb.backbone_orientations())
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: "
          f"{', '.join(f'{k}{v.shape}' for k, v in sorted(out.items()))}")
    return 0


def cmd_info(args) -> int:
    import torch

    import protstruc_tpu_torch
    from protstruc_tpu_torch.ops.cuda_lib import find_nvcc

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "version": protstruc_tpu_torch.__version__,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())] if cuda else []),
        "nvcc": find_nvcc(),
    }, indent=2))
    return 0


def serve_loop(infile, outfile, batch_sizes=(1,), buckets=(256, 512),
               device="cuda") -> int:
    """JSONL request/response loop (one JSON object per line).

    Requests:
      {"op": "ping"}
      {"op": "featurize", "path": PDB, "out": NPZ}   # warmed bucketed path
      {"op": "shutdown"}
    Responses: {"ok": true, ...} / {"ok": false, "error": ...} per line.

    The featurizer is built and warmed for the given (batch, bucket) grid at
    startup (utils/aot.py), on ``device``: its pair maps go through K1 on a
    CUDA device and through the arccos form on the CPU.
    """
    import numpy as np

    import protstruc_tpu_torch as ps
    from protstruc_tpu_torch.utils.aot import precompile_featurizer

    feat = precompile_featurizer(batch_sizes=batch_sizes, buckets=buckets,
                                 device=device)
    print(json.dumps({"ok": True, "ready": True,
                      "shapes": sorted(map(list, feat.shapes))}),
          file=outfile, flush=True)

    for line in infile:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            op = req.get("op")
            if op == "ping":
                resp = {"ok": True}
            elif op == "featurize":
                sb = ps.StructureBatch.from_pdb(req["path"], device=feat.device)
                out = _features_to_numpy(*feat(sb))
                np.savez_compressed(req["out"], **out)
                resp = {"ok": True, "out": req["out"],
                        "n_residues": int(sb.get_total_lengths()[0])}
            elif op == "shutdown":
                print(json.dumps({"ok": True, "bye": True}),
                      file=outfile, flush=True)
                return 0
            elif op in _NOT_PORTED_OPS:
                raise NotImplementedError(f"op {op!r} is not yet ported")
            else:
                raise ValueError(f"unknown op {op!r}")
        except Exception as e:  # report per-request, keep serving
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(resp), file=outfile, flush=True)
    return 0


def cmd_serve(args) -> int:
    return serve_loop(sys.stdin, sys.stdout, batch_sizes=(1,),
                      buckets=tuple(int(b) for b in args.buckets.split(",")),
                      device=args.device)


def cmd_train(args) -> int:
    import glob
    import os

    from protstruc_tpu_torch.train import TrainConfig, train

    if args.mesh or args.zero1:
        raise NotImplementedError("--mesh and --zero1 (device meshes, ZeRO-1) are not yet ported")
    paths = []
    for inp in args.inputs:
        if os.path.isdir(inp):
            paths.extend(sorted(glob.glob(os.path.join(inp, "*.pdb"))))
            paths.extend(sorted(glob.glob(os.path.join(inp, "*.cif"))))
        else:
            paths.append(inp)
    if not paths:
        print("no input structures found", file=sys.stderr)
        return 2
    cfg = TrainConfig(
        steps=args.steps, batch_size=args.batch_size, node_dim=args.node_dim,
        pair_dim=args.pair_dim, n_blocks=args.blocks, n_recycle=args.recycle,
        sequence_only=args.sequence_only, learning_rate=args.lr, accum_steps=args.accum,
        lr_schedule=args.lr_schedule, warmup_steps=args.warmup, ema_decay=args.ema_decay,
        save_every=args.save_every, seed=args.seed, bf16=args.bf16,
        pair_update=args.pair_update, remat=args.remat, remat_policy=args.remat_policy,
        use_flash_attn=args.flash_attn, fused_tri=args.fused_tri, crop_len=args.crop)
    metrics = train(paths, args.checkpoint_dir, cfg, log_fn=lambda *a: print(*a, file=sys.stderr),
                    eval_paths=args.eval, device=args.device)
    print(json.dumps(metrics))
    return 0


def _step_arg(s):
    """argparse type for --step: 'best' or an integer checkpoint step."""
    if s == "best":
        return s
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"--step must be an integer step or 'best', got {s!r}")


def cmd_fold(args) -> int:
    import numpy as np

    from protstruc_tpu_torch.pdbio.writer import to_pdb
    from protstruc_tpu_torch.train import fold_sequence

    if args.relax:
        raise NotImplementedError("fold --relax (gradient relaxation) is not yet ported")
    coords, plddt, pae = fold_sequence(args.checkpoint_dir, args.seq, n_recycle=args.recycle,
                                       return_confidence=True, step=args.step,
                                       use_ema=not args.raw_params, device=args.device)
    coords, plddt, pae = (t.cpu().numpy() for t in (coords, plddt, pae))
    chains = args.seq.upper().split(":")
    chain_ids = [chr(ord("A") + i) for i in range(len(chains))]
    n_res = sum(len(c) for c in chains)
    # writer layout: (5, L, 3) N/CA/C/O/CB; pLDDT in the B-factor column
    to_pdb(args.out, coords.transpose(1, 0, 2), chains, chain_ids, bfactors=plddt)
    print(f"wrote {args.out} ({n_res} residues, {len(chains)} chain(s), "
          f"mean pLDDT {float(plddt.mean()):.1f}, mean PAE {float(pae.mean()):.1f} A)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="protstruc_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")

    f = sub.add_parser("featurize", help="6D maps + dihedrals + frames -> npz")
    f.add_argument("inputs", nargs="+")
    f.add_argument("--out", default="features.npz")
    f.add_argument("--pallas", action="store_true",
                   help="the pair maps through the K1 kernel (the JAX CLI's switch for its "
                        "Pallas kernel); default: the arccos-form path")
    device_arg(f)
    f.set_defaults(fn=cmd_featurize)

    i = sub.add_parser("info", help="torch / CUDA / nvcc status")
    i.set_defaults(fn=cmd_info)

    sv = sub.add_parser("serve", help="JSONL request loop over the warmed featurizer")
    sv.add_argument("--buckets", default="256,512",
                    help="length buckets to warm")
    device_arg(sv)
    sv.set_defaults(fn=cmd_serve)

    t = sub.add_parser("train", help="train FoldModel on PDB files/dirs")
    t.add_argument("inputs", nargs="+", help="PDB files or directories")
    t.add_argument("--checkpoint-dir", required=True)
    t.add_argument("--steps", type=int, default=1000)
    t.add_argument("--batch-size", type=int, default=4)
    t.add_argument("--node-dim", type=int, default=128)
    t.add_argument("--pair-dim", type=int, default=64)
    t.add_argument("--blocks", type=int, default=4)
    t.add_argument("--recycle", type=int, default=1)
    t.add_argument("--sequence-only", action="store_true",
                   help="train the sequence->structure path")
    t.add_argument("--lr", type=float, default=3e-4)
    t.add_argument("--save-every", type=int, default=500)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--bf16", action="store_true")
    t.add_argument("--pair-update", default="gated_mix", choices=("gated_mix", "triangle"),
                   help="trunk pair-update mechanism (triangle = Evoformer multiplicative "
                        "updates; pair with --remat)")
    t.add_argument("--remat", action="store_true",
                   help="recompute each trunk block in the backward pass")
    t.add_argument("--flash-attn", action="store_true",
                   help="flash pair-bias node attention (K8/K9 kernels, no (B,H,L,L) "
                        "probabilities in device memory)")
    t.add_argument("--fused-tri", action="store_true",
                   help="fused triangle-multiplication kernels (K4-K7, with --pair-update "
                        "triangle); same param tree as unfused")
    t.add_argument("--remat-policy", default="none", choices=("none", "tri_dots", "dots"),
                   help="with --remat: only 'none' is ported")
    t.add_argument("--mesh", default=None, help="dp,sp,tp device mesh (not yet ported)")
    t.add_argument("--zero1", action="store_true", help="ZeRO-1 (not yet ported)")
    t.add_argument("--accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer step "
                        "(effective batch = batch-size * accum)")
    t.add_argument("--lr-schedule", default="constant", choices=["constant", "warmup_cosine"],
                   help="learning-rate schedule over optimizer steps")
    t.add_argument("--warmup", type=int, default=0,
                   help="linear warmup steps for --lr-schedule warmup_cosine")
    t.add_argument("--ema-decay", type=float, default=0.0,
                   help="params EMA decay (e.g. 0.999; 0 = off); fold then uses the EMA weights")
    t.add_argument("--crop", type=int, default=None, metavar="LEN",
                   help="train on random contiguous crops of LEN residues")
    t.add_argument("--eval", nargs="+", default=None, metavar="PDB",
                   help="held-out structures: CA-lDDT/RMSD at each save")
    device_arg(t)
    t.set_defaults(fn=cmd_train)

    fd = sub.add_parser("fold", help="fold a sequence with a trained checkpoint")
    fd.add_argument("--checkpoint-dir", required=True)
    fd.add_argument("--seq", required=True, help="one-letter sequence")
    fd.add_argument("--out", default="fold.pdb")
    fd.add_argument("--recycle", type=int, default=None)
    fd.add_argument("--step", default=None, type=_step_arg,
                    help="checkpoint step to load: an int, or 'best' for the best held-out "
                         "eval_ca_lddt recorded in metrics.jsonl (default: latest)")
    fd.add_argument("--raw-params", action="store_true",
                    help="load the raw last-step params instead of the EMA weights")
    fd.add_argument("--relax", type=int, default=0, metavar="STEPS",
                    help="gradient-relax the output (not yet ported)")
    device_arg(fd)
    fd.set_defaults(fn=cmd_fold)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
