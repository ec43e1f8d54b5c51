"""Structure -> 6D features -> reconstructed backbone -> PDB, end to end.

Inter-residue geometry, the trRosetta distance-matrix decode, MDS, then
``steps`` steps of ``idealize_backbone``; writes ``out/reconstructed.pdb``::

    python -m protstruc_tpu_torch.examples.reconstruct_pipeline tests/data/1REX.pdb 300 [--device cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from protstruc_tpu_torch.examples import parse


def main(argv=None):
    args = parse(argv, __doc__, "tests/data/1REX.pdb", 300)
    import protstruc_tpu_torch as pt
    from protstruc_tpu_torch.ops.idealize import idealize_backbone
    from protstruc_tpu_torch.ops.reconstruct import (
        initialize_backbone_with_mds, reconstruct_backbone_distmat_from_interresidue_geometry)
    from protstruc_tpu_torch.pdbio.writer import to_pdb

    dev = torch.device(args.device)
    sb = pt.StructureBatch.from_pdb(args.pdb, device=dev)
    print(f"loaded {args.pdb}: {sb.n_residues} residues")
    g = sb.inter_residue_geometry()
    dist = reconstruct_backbone_distmat_from_interresidue_geometry(
        g["d_cb"][0], g["omega"][0], g["theta"][0], g["phi"][0], mask=g["d_cb_mask"][0])
    coords = initialize_backbone_with_mds(dist, max_iter=200)

    # refine covalent geometry (bond lengths and angles) toward ideal values
    refined, ideality = idealize_backbone(coords[:4].transpose(0, 1), n_steps=args.steps)
    coords = torch.cat([refined.transpose(0, 1), coords[4:]], dim=0)
    print(f"idealized: residual geometry loss {float(ideality):.2f}")

    rec = coords[1].cpu().numpy()
    true = sb.get_xyz()[0, :, 1].cpu().numpy()
    d_rec = np.linalg.norm(rec[:, None] - rec[None], axis=-1)
    d_true = np.linalg.norm(true[:, None] - true[None], axis=-1)
    m = g["d_cb_mask"][0].cpu().numpy()
    print(f"CA distance-matrix RMS error: {float(np.sqrt(((d_rec - d_true)[m] ** 2).mean())):.2f} A")

    seq = "".join(s for _, s in sorted(dict(sb.seq[0]).items()))
    seq = seq[:sb.n_residues].ljust(sb.n_residues, "X").replace("X", "A")
    os.makedirs("out", exist_ok=True)
    path = "out/reconstructed.pdb"
    to_pdb(path, coords.cpu().numpy(), [seq], ["A"])
    print(f"wrote {path}")
    return [path]


if __name__ == "__main__":
    main(sys.argv[1:])
