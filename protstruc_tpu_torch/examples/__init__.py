"""Runnable drivers of the design and generation path, ports of the JAX
package's ``examples/`` scripts::

    python -m protstruc_tpu_torch.examples.design_pipeline tests/data/1REX.pdb 150
    python -m protstruc_tpu_torch.examples.design_cdr tests/data/6dc4.pdb 100
    python -m protstruc_tpu_torch.examples.framediff_backbones tests/data/1REX.pdb 200
    python -m protstruc_tpu_torch.examples.generate_backbones tests/data/1REX.pdb 100
    python -m protstruc_tpu_torch.examples.reconstruct_pipeline tests/data/1REX.pdb 300
    python -m protstruc_tpu_torch.examples.train_trfold --data tests/data --steps 20

Each but ``train_trfold`` takes ``<pdb> [steps] [--device cpu] [--seed N]``
and writes under ``out/`` in the working directory; ``train_trfold`` takes
``--data DIR --steps N --batch-size B --lr LR --device D`` and writes
nothing.  Each runs on the card by default, and every ``main`` returns what
it wrote.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import numpy as np
import torch


def parse(argv: Optional[Sequence[str]], doc: str, pdb: str, steps: int, extra=None):
    """``<pdb> [steps] [--device D] [--seed N]`` and any ``extra(parser)``
    options."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("pdb", nargs="?", default=pdb)
    p.add_argument("steps", nargs="?", type=int, default=steps)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    if extra is not None:
        extra(p)
    return p.parse_args(argv)


def fragments(xyz: np.ndarray, frag_len: int) -> np.ndarray:
    """Complete-backbone windows of ``frag_len`` residues of ``xyz (L, A, 3)``,
    overlapping by half: ``(n, frag_len, A, 3)``."""
    ok = np.isfinite(xyz[:, :3]).all((1, 2))
    out: List[np.ndarray] = []
    i = 0
    while i + frag_len <= len(ok):
        if ok[i:i + frag_len].all():
            out.append(xyz[i:i + frag_len])
            i += frag_len // 2
        else:
            i += 1
    return np.stack(out)


def adam(params, lr: float) -> torch.optim.Adam:
    """optax ``adam``'s defaults (b1 0.9, b2 0.999, eps 1e-8)."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
