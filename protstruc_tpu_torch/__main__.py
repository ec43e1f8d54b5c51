"""Command-line interface: ``python -m protstruc_tpu_torch <command>``.

    python -m protstruc_tpu_torch featurize 1rex.pdb --out feats.npz
    python -m protstruc_tpu_torch analyze 1rex.pdb --ss8 --sasa
    python -m protstruc_tpu_torch convert in.pdb out.cif
    python -m protstruc_tpu_torch renumber in.pdb out.pdb --heavy H --light L --to imgt
    python -m protstruc_tpu_torch score model.pdb native.pdb
    python -m protstruc_tpu_torch info
    python -m protstruc_tpu_torch serve --buckets 256,512 --checkpoint-dir ck
    python -m protstruc_tpu_torch train tests/data --checkpoint-dir ck --steps 8
    python -m protstruc_tpu_torch fold --checkpoint-dir ck --seq MKV... --out fold.pdb --relax 20

Commands run on ``--device`` (default ``cuda``, which raises without a card;
pass ``--device cpu`` for host runs); ``renumber`` runs on the host alone.
``train --mesh dp,sp,tp [--zero1]`` trains under ``torchrun`` over dp * sp *
tp ranks (the mesh's product must be the world size): data parallel over
dp, the model sharded over sp and tp (``train.py``).
"""

from __future__ import annotations

import argparse
import json
import sys

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


def _frac(hits, valid) -> float:
    """Mean of ``hits`` over ``valid`` positions; 0.0 when none are valid
    (a mean over an empty slice is NaN, which json.dumps emits as invalid
    JSON, e.g. single-residue chains have no defined phi AND psi)."""
    import numpy as np

    n = int(np.sum(valid))
    if n == 0:
        return 0.0
    return float(np.sum(hits & valid) / n)


def _np(t):
    return t.detach().cpu().numpy()


def cmd_analyze(args) -> int:
    import protstruc_tpu_torch as ps

    sb = ps.StructureBatch.from_pdb(list(args.inputs), device=args.device)
    ss, rmask = _np(sb.secondary_structure()), _np(sb.residue_mask)
    rama, rv = map(_np, sb.ramachandran_classes())
    n = sb.batch_size
    report = {
        "n_structures": n,
        "n_residues": [int(x) for x in _np(sb.get_total_lengths())],
        "radius_of_gyration_A": [round(float(x), 2) for x in _np(sb.radius_of_gyration())],
        "relative_contact_order": [round(float(x), 4) for x in _np(sb.contact_order())],
        "clash_energy": [round(float(x), 3) for x in _np(sb.clash_energy())],
        "helix_frac": [round(_frac(ss[i] == 1, rmask[i]), 3) for i in range(n)],
        "strand_frac": [round(_frac(ss[i] == 2, rmask[i]), 3) for i in range(n)],
        "rama_favored_frac": [round(_frac(rama[i] == 0, rv[i]), 3) for i in range(n)],
        "rama_outlier_frac": [round(_frac(rama[i] == 2, rv[i]), 3) for i in range(n)],
    }
    if args.ss8:
        from protstruc_tpu_torch.ops.secondary import SS8_LETTERS

        ss8 = _np(sb.secondary_structure_8())
        report["dssp8"] = ["".join(SS8_LETTERS[k] for k in ss8[i][rmask[i]]) for i in range(n)]
    if args.sasa:
        report["total_sasa_A2"] = [round(float(x), 1) for x in _np(sb.sasa().sum(1))]
    print(json.dumps(report, indent=2))
    return 0


def cmd_convert(args) -> int:
    import protstruc_tpu_torch as ps
    from protstruc_tpu_torch.pdbio.writer import structure_batch_to_cif, structure_batch_to_pdb

    sb = ps.StructureBatch.from_pdb([args.input], device=args.device)
    writer = structure_batch_to_cif if args.output.endswith(".cif") else structure_batch_to_pdb
    writer(sb, args.output)
    print(f"wrote {args.output}")
    return 0


def cmd_renumber(args) -> int:
    from protstruc_tpu_torch.numbering import renumber_pdb

    if args.heavy is None and args.light is None:
        raise SystemExit("renumber needs --heavy and/or --light chain ids")
    summary = renumber_pdb(
        args.input, args.output,
        heavy_chain_id=args.heavy, light_chain_id=args.light,
        to_scheme=args.to_scheme, source_scheme=args.source_scheme)
    print(json.dumps({"output": args.output, "chains": summary}))
    return 0


def cmd_score(args) -> int:
    """Model-vs-native structure metrics (lDDT, TM-score, GDT-TS, RMSD, and
    DockQ for complexes)."""
    import numpy as np
    import torch

    import protstruc_tpu_torch as ps
    from protstruc_tpu_torch.ops import metrics as M

    model = ps.StructureBatch.from_pdb([args.model], device=args.device)
    native = ps.StructureBatch.from_pdb([args.native], device=args.device)
    if model.n_residues != native.n_residues:
        raise SystemExit(
            f"residue count mismatch: model has {model.n_residues}, "
            f"native has {native.n_residues} — score needs a 1:1 mapping")
    ca_m, ca_n = model.xyz[:, :, 1], native.xyz[:, :, 1]
    mask = (model.residue_mask & native.residue_mask
            & torch.isfinite(ca_m).all(-1) & torch.isfinite(ca_n).all(-1))
    ca_m, ca_n = torch.nan_to_num(ca_m, nan=1e6), torch.nan_to_num(ca_n, nan=1e6)
    report = {
        "n_residues": int(mask.sum()),
        "ca_rmsd": round(float(M.rmsd(ca_m, ca_n, mask=mask)[0]), 3),
        "ca_lddt": round(float(M.lddt(ca_m, ca_n, mask=mask)[0]), 4),
        "tm_score": round(float(M.tm_score(ca_m, ca_n, mask=mask)[0]), 4),
        "gdt_ts": round(float(M.gdt_ts(ca_m, ca_n, mask=mask)[0]), 4),
    }
    if int(native.chain_idx.max()) + 1 >= 2:
        rec_ids = {int(x) for x in args.receptor_chains.split(",")}
        # validate the split BEFORE computing: an empty receptor or ligand
        # group gives masked_kabsch a zero weight sum and DockQ NaN, which
        # json.dumps would emit as an unparseable token
        present = {int(x) for x in np.unique(_np(native.chain_idx)) if x >= 0}
        if not (rec_ids & present):
            print(f"--receptor-chains {sorted(rec_ids)} matches no chain "
                  f"(present: {sorted(present)})", file=sys.stderr)
            return 2
        if not (present - rec_ids):
            print(f"--receptor-chains {sorted(rec_ids)} leaves no ligand "
                  f"chain (present: {sorted(present)})", file=sys.stderr)
            return 2
        in_rec = torch.isin(native.chain_idx, torch.tensor(sorted(rec_ids), device=mask.device))
        q = float(M.dockq(model.xyz, native.xyz, model.atom_mask & native.atom_mask,
                          in_rec & mask, ~in_rec & mask)[0])
        report["dockq"] = round(q, 4)
        report["capri_band"] = M.capri_band(q)
    print(json.dumps(report))
    return 0


def cmd_info(args) -> int:
    import torch

    import protstruc_tpu_torch
    from protstruc_tpu_torch.ops.cuda_lib import find_nvcc
    from protstruc_tpu_torch.pdbio.native import native_available

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "version": protstruc_tpu_torch.__version__,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "devices": ([torch.cuda.get_device_name(i)
                     for i in range(torch.cuda.device_count())] if cuda else []),
        "nvcc": find_nvcc(),
        "native_parser": native_available(),
    }, indent=2))
    return 0


def serve_loop(infile, outfile, checkpoint_dir=None, batch_sizes=(1,), buckets=(256, 512),
               step=None, use_ema=True, device="cuda") -> int:
    """JSONL request/response loop (one JSON object per line).

    Requests:
      {"op": "ping"}
      {"op": "featurize", "path": PDB, "out": NPZ}   # warmed bucketed path
      {"op": "analyze", "path": PDB}                 # inline stats
      {"op": "fold", "seq": SEQ, "out": PDB}         # needs checkpoint_dir
      {"op": "shutdown"}
    Responses: {"ok": true, ...} / {"ok": false, "error": ...} per line.

    The featurizer is built and warmed for the given (batch, bucket) grid at
    startup (utils/aot.py), on ``device``: its pair maps go through K1 on a
    CUDA device and through the arccos form on the CPU.  The fold model
    (checkpoint ``step``, EMA weights when ``use_ema``) is loaded once, on
    the first ``fold``, onto the same device.
    """
    import numpy as np

    import protstruc_tpu_torch as ps
    from protstruc_tpu_torch.utils.aot import precompile_featurizer

    feat = precompile_featurizer(batch_sizes=batch_sizes, buckets=buckets,
                                 device=device)
    fold_model = None  # (model, params, cfg), loaded on the first fold op
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
            elif op == "analyze":
                sb = ps.StructureBatch.from_pdb(req["path"], device=feat.device)
                ss, rm = _np(sb.secondary_structure())[0], _np(sb.residue_mask)[0]
                resp = {"ok": True,
                        "n_residues": int(sb.get_total_lengths()[0]),
                        "helix_frac": round(_frac(ss == 1, rm), 3),
                        "strand_frac": round(_frac(ss == 2, rm), 3),
                        "rg": round(float(sb.radius_of_gyration()[0]), 2)}
            elif op == "fold":
                if checkpoint_dir is None:
                    raise ValueError("fold requires --checkpoint-dir")
                from protstruc_tpu_torch.pdbio.writer import to_pdb
                from protstruc_tpu_torch.train import fold_with_model, load_fold_model

                if fold_model is None:
                    fold_model = load_fold_model(checkpoint_dir, step=step, use_ema=use_ema,
                                                 device=feat.device)
                coords, plddt, _pae = map(_np, fold_with_model(*fold_model, req["seq"],
                                                               return_confidence=True))
                chains = req["seq"].upper().split(":")
                cids = [chr(ord("A") + i) for i in range(len(chains))]
                to_pdb(req["out"], coords.transpose(1, 0, 2), chains, cids, bfactors=plddt)
                resp = {"ok": True, "out": req["out"],
                        "mean_plddt": round(float(plddt.mean()), 1)}
            elif op == "shutdown":
                print(json.dumps({"ok": True, "bye": True}),
                      file=outfile, flush=True)
                return 0
            else:
                raise ValueError(f"unknown op {op!r}")
        except Exception as e:  # report per-request, keep serving
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(resp), file=outfile, flush=True)
    return 0


def cmd_serve(args) -> int:
    return serve_loop(sys.stdin, sys.stdout, checkpoint_dir=args.checkpoint_dir,
                      batch_sizes=(1,), buckets=tuple(int(b) for b in args.buckets.split(",")),
                      step=args.step, use_ema=not args.raw_params, device=args.device)


def cmd_train(args) -> int:
    import glob
    import os

    from protstruc_tpu_torch.train import TrainConfig, train

    mesh_shape = None
    if args.mesh:
        mesh_shape = tuple(int(x) for x in args.mesh.split(","))
        if len(mesh_shape) != 3 or min(mesh_shape) < 1:
            raise ValueError(f"--mesh takes dp,sp,tp (positive ints), got {args.mesh!r}")
        world = int(os.environ.get("WORLD_SIZE", 1))
        import math

        import torch.distributed as dist

        if dist.is_initialized():
            world = dist.get_world_size()
        n = math.prod(mesh_shape)
        if n != world:
            raise ValueError(f"--mesh {args.mesh} needs dp*sp*tp = {n} ranks, but the world "
                             f"size is {world}: run under torchrun --nproc-per-node {n}")
    elif args.zero1:
        raise ValueError("--zero1 requires --mesh: ZeRO-1 partitions optimizer state over the dp "
                         "mesh axis")
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
        use_flash_attn=args.flash_attn, fused_tri=args.fused_tri, crop_len=args.crop,
        mesh_shape=mesh_shape, zero1=args.zero1)
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
    import torch

    from protstruc_tpu_torch.pdbio.writer import to_pdb
    from protstruc_tpu_torch.train import fold_sequence

    coords, plddt, pae = fold_sequence(args.checkpoint_dir, args.seq, n_recycle=args.recycle,
                                       return_confidence=True, step=args.step,
                                       use_ema=not args.raw_params, device=args.device)
    chains = args.seq.upper().split(":")
    chain_ids = [chr(ord("A") + i) for i in range(len(chains))]
    n_res = sum(len(c) for c in chains)
    if args.relax:
        import protstruc_tpu_torch as ps

        L = coords.shape[0]
        full = torch.full((1, L, 15, 3), torch.nan, dtype=torch.float32, device=coords.device)
        full[0, :, :5] = coords
        cidx = [[k for k, ch in enumerate(chains) for _ in ch]]
        sb = ps.StructureBatch.from_xyz(full, chain_idx=cidx, chain_ids=[chain_ids],
                                        seq=[dict(zip(chain_ids, chains))],
                                        device=coords.device)
        relaxed, e = sb.relax(n_steps=args.relax)
        coords = relaxed.xyz[0, :, :5]
        print(f"relaxed {args.relax} steps: energy "
              f"{float(e['initial'][0]):.1f} -> {float(e['final'][0]):.1f}", file=sys.stderr)
    coords, plddt, pae = map(_np, (coords, plddt, pae))
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

    a = sub.add_parser("analyze", help="structure statistics as JSON")
    a.add_argument("inputs", nargs="+")
    a.add_argument("--sasa", action="store_true", help="include Shrake-Rupley SASA (slower)")
    a.add_argument("--ss8", action="store_true",
                   help="include the per-residue 8-class DSSP string")
    device_arg(a)
    a.set_defaults(fn=cmd_analyze)

    c = sub.add_parser("convert", help="PDB <-> mmCIF conversion")
    c.add_argument("input")
    c.add_argument("output")
    device_arg(c)
    c.set_defaults(fn=cmd_convert)

    rn = sub.add_parser(
        "renumber",
        help="convert antibody numbering scheme (chothia/kabat <-> imgt)")
    rn.add_argument("input")
    rn.add_argument("output")
    rn.add_argument("--heavy", default=None, help="heavy chain id")
    rn.add_argument("--light", default=None, help="light chain id")
    rn.add_argument("--to", dest="to_scheme", default="imgt",
                    choices=["chothia", "kabat", "imgt"])
    rn.add_argument("--from", dest="source_scheme", default="auto",
                    choices=["auto", "chothia", "kabat", "imgt"])
    rn.set_defaults(fn=cmd_renumber)

    i = sub.add_parser("info", help="torch / CUDA / nvcc / C++ PDB scanner status")
    i.set_defaults(fn=cmd_info)

    sv = sub.add_parser("serve", help="JSONL request loop over the warmed featurizer")
    sv.add_argument("--checkpoint-dir", default=None, help="enables the fold op")
    sv.add_argument("--buckets", default="256,512",
                    help="length buckets to warm")
    sv.add_argument("--step", default=None, type=_step_arg,
                    help="checkpoint step for the fold op: int or 'best' (default: latest)")
    sv.add_argument("--raw-params", action="store_true",
                    help="load raw params instead of EMA weights")
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
    t.add_argument("--mesh", default=None,
                   help="dp,sp,tp process mesh: data parallel over dp, the model's residue "
                        "rows over sp, its heads and MLP hidden dim over tp (run under "
                        "torchrun --nproc-per-node dp*sp*tp)")
    t.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: partition the AdamW moments over the dp ranks (needs --mesh)")
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
                    help="gradient-relax the output for STEPS steps")
    device_arg(fd)
    fd.set_defaults(fn=cmd_fold)

    sc = sub.add_parser("score", help="model-vs-native metrics (lDDT/TM/GDT/DockQ)")
    sc.add_argument("model", help="predicted-structure PDB/mmCIF")
    sc.add_argument("native", help="reference-structure PDB/mmCIF")
    sc.add_argument("--receptor-chains", default="0",
                    help="comma-separated chain indices forming the DockQ receptor "
                         "(default: chain 0; the rest is the ligand)")
    device_arg(sc)
    sc.set_defaults(fn=cmd_score)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
