"""End-to-end TrFold training over a PDB directory.

The whole framework path: streaming bucketed ingest (the C++ scanner in the
dataset's parse threads) -> featurization on the device -> training steps::

    python -m protstruc_tpu_torch.examples.train_trfold --data tests/data --steps 20 [--device cpu]

Writes nothing; ``main`` returns the list of files it wrote (none), as the
other drivers do, and prints one line a step.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", default="tests/data")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from protstruc_tpu_torch.batch import resolve_device
    from protstruc_tpu_torch.models.trfold import (TrFold, TrFoldConfig, featurize_for_model,
                                                   make_train_state, train_step)
    from protstruc_tpu_torch.pdbio.dataset import StructureDataset

    dev = resolve_device(args.device)
    paths = sorted(glob.glob(os.path.join(args.data, "*.pdb")))
    if not paths:
        sys.exit(f"no PDB files under {args.data}")
    print(f"{len(paths)} structures, backend={dev.type}")

    # a small config so the example runs anywhere; scale node/pair dims up
    # for real training
    cfg = TrFoldConfig(node_dim=64, pair_dim=32, n_heads=4, n_blocks=2)
    model = TrFold(cfg, device=dev)

    ds = StructureDataset(paths, batch_size=args.batch_size, shuffle=True,
                          buckets=(256, 512, 1024, 2048, 2560), device=dev)

    params = opt_state = tx = None
    step = 0
    t0 = time.perf_counter()
    while step < args.steps:
        for batch in ds:
            feats = featurize_for_model(batch)
            if params is None:
                params, opt_state, tx = make_train_state(model, feats, torch.Generator().manual_seed(0),
                                                         args.lr, device=dev)
            params, opt_state, loss = train_step(params, opt_state, feats, model, tx)
            step += 1
            print(f"step {step:4d}  L={batch.n_residues:4d}  loss={float(loss):.4f}")
            if step >= args.steps:
                break
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.1f}s ({dt / args.steps * 1e3:.0f} ms/step)")
    return []


if __name__ == "__main__":
    main(sys.argv[1:])
