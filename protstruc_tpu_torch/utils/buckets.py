"""Bucketed padding of the residue axis (port of ``protstruc_tpu/utils/buckets.py``).

Serving pads every request's residue axis up to one of a few bucket lengths,
so the featurizer sees a bounded set of shapes (``utils/aot.py``); the
training dataset groups structures by bucket (``pdbio/dataset.py``) and
evaluation pads each batch to its bucket.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = ["DEFAULT_BUCKETS", "bucket_length", "pad_batch_to_bucket", "concat_batches"]

#: Default residue-length buckets: fine-grained at common protein sizes,
#: multiples of 128 from 256 up.
DEFAULT_BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; rounds up to a multiple of 128 beyond the table."""
    for b in buckets:
        if n <= b:
            return b
    return (n + 127) // 128 * 128


def pad_batch_to_bucket(batch, buckets: Sequence[int] = DEFAULT_BUCKETS):
    """A StructureBatch with its residue axis padded up to its bucket: zero
    coordinates, False masks, -1 indices.  The batch itself when L already is
    a bucket length."""
    from protstruc_tpu_torch.batch import PAD_IDX

    L = batch.n_residues
    extra = bucket_length(L, buckets) - L
    if extra == 0:
        return batch

    def pad(x, value):
        widths = [0, 0] * (x.dim() - 2) + [0, extra]
        return torch.nn.functional.pad(x, widths, value=value)

    return dataclasses.replace(
        batch,
        xyz=pad(batch.xyz, 0.0),
        atom_mask=pad(batch.atom_mask, False),
        chain_idx=pad(batch.chain_idx, PAD_IDX),
        residue_idx=pad(batch.residue_idx, PAD_IDX),
    )


def concat_batches(batches, buckets: Sequence[int] = DEFAULT_BUCKETS):
    """StructureBatches concatenated along B, L padded to a common bucket.
    ``chain_ids``/``seq`` concatenate when every input has them, else None."""
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    target = bucket_length(max(b.n_residues for b in batches), buckets)
    padded = [pad_batch_to_bucket(b, (target,)) if b.n_residues != target else b
              for b in batches]

    def cat(field):
        return torch.cat([getattr(b, field) for b in padded], dim=0)

    chain_ids = (sum((b.chain_ids for b in batches), ())
                 if all(b.chain_ids is not None for b in batches) else None)
    seq = sum((b.seq for b in batches), ()) if all(b.seq is not None for b in batches) else None
    return dataclasses.replace(padded[0], xyz=cat("xyz"), atom_mask=cat("atom_mask"),
                               chain_idx=cat("chain_idx"), residue_idx=cat("residue_idx"),
                               chain_ids=chain_ids, seq=seq)
