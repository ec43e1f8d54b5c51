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
    coordinates, False masks (an antibody batch's named masks too), -1
    indices.  The batch itself when L already is a bucket length."""
    from protstruc_tpu_torch.batch import PAD_IDX

    L = batch.n_residues
    extra = bucket_length(L, buckets) - L
    if extra == 0:
        return batch

    def pad(x, value):
        widths = [0, 0] * (x.dim() - 2) + [0, extra]
        return torch.nn.functional.pad(x, widths, value=value)

    out = dataclasses.replace(
        batch,
        xyz=pad(batch.xyz, 0.0),
        atom_mask=pad(batch.atom_mask, False),
        chain_idx=pad(batch.chain_idx, PAD_IDX),
        residue_idx=pad(batch.residue_idx, PAD_IDX),
    )
    if getattr(batch, "residue_masks", None):
        out = dataclasses.replace(
            out, residue_masks={k: pad(v, False) for k, v in batch.residue_masks.items()})
    return out


def concat_batches(batches, buckets: Sequence[int] = DEFAULT_BUCKETS):
    """StructureBatches concatenated along B, L padded to a common bucket.

    ``chain_ids``/``seq`` concatenate when every input has them, else None;
    ``mu``/``std`` concatenate, and standardized batches cannot be mixed
    with raw ones.  Antibody batches concatenate their named masks and
    chain-role tuples; they cannot be mixed with plain batches.
    """
    if not batches:
        raise ValueError("concat_batches needs at least one batch")
    if len({b.standardized for b in batches}) > 1:
        raise ValueError("cannot concat standardized with unstandardized batches")
    target = bucket_length(max(b.n_residues for b in batches), buckets)
    padded = [pad_batch_to_bucket(b, (target,)) if b.n_residues != target else b
              for b in batches]

    def cat(field):
        return torch.cat([getattr(b, field) for b in padded], dim=0)

    first = padded[0]
    out = dataclasses.replace(
        first, xyz=cat("xyz"), atom_mask=cat("atom_mask"), chain_idx=cat("chain_idx"),
        residue_idx=cat("residue_idx"),
        mu=cat("mu") if first.mu is not None else None,
        std=cat("std") if first.std is not None else None,
        chain_ids=_cat_tuples(batches, "chain_ids"), seq=_cat_tuples(batches, "seq"))
    # antibody batches: either every input carries residue_masks or none
    have_masks = [bool(getattr(b, "residue_masks", None)) for b in padded]
    if any(have_masks):
        if not all(have_masks):
            raise ValueError("cannot concat antibody batches with plain batches")
        out = dataclasses.replace(
            out,
            residue_masks={k: torch.cat([b.residue_masks[k] for b in padded], dim=0)
                           for k in first.residue_masks},
            heavy_chain_id=_cat_tuples(padded, "heavy_chain_id"),
            light_chain_id=_cat_tuples(padded, "light_chain_id"),
            antigen_chain_ids=_cat_tuples(padded, "antigen_chain_ids"),
        )
    return out


def _cat_tuples(batches, field):
    """Concatenate per-structure tuple metadata; None if absent anywhere."""
    vals = [getattr(b, field, None) for b in batches]
    if any(v is None for v in vals):
        return None
    return sum(vals, ())
