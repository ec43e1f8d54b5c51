"""Command-line interface: ``python -m protstruc_tpu_torch <command>``.

    python -m protstruc_tpu_torch featurize 1rex.pdb --out feats.npz
    python -m protstruc_tpu_torch info
    python -m protstruc_tpu_torch serve --buckets 256,512

Commands run on ``--device`` (default ``cuda``, which raises without a card;
pass ``--device cpu`` for host runs).  Ported so far: ``featurize``, ``info``
and ``serve`` with its ``ping``, ``featurize`` and ``shutdown`` ops; the
server answers ``analyze`` and ``fold`` with ``{"ok": false, ...}``.
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
    out = _features_to_numpy(sb.inter_residue_geometry(), *sb.backbone_dihedrals(),
                             sb.backbone_orientations())
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
    startup (utils/aot.py), on ``device``.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="protstruc_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda)")

    f = sub.add_parser("featurize", help="6D maps + dihedrals + frames -> npz")
    f.add_argument("inputs", nargs="+")
    f.add_argument("--out", default="features.npz")
    device_arg(f)
    f.set_defaults(fn=cmd_featurize)

    i = sub.add_parser("info", help="torch / CUDA / nvcc status")
    i.set_defaults(fn=cmd_info)

    sv = sub.add_parser("serve", help="JSONL request loop over the warmed featurizer")
    sv.add_argument("--buckets", default="256,512",
                    help="length buckets to warm")
    device_arg(sv)
    sv.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
