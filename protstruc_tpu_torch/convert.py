"""State carried between the JAX package and the port.

The featurization path has no parameters: the state that must match is the
batch itself.  :func:`structure_batch_from_numpy` builds the port's batch from
the JAX batch's arrays taken as numpy (``np.asarray(sb.xyz)``, ...), and
:func:`to_numpy` goes back, returning the same keyword arguments.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from protstruc_tpu_torch.batch import (
    DeviceLike,
    StructureBatch,
    _freeze_chain_ids,
    _freeze_seq,
    resolve_device,
)

__all__ = ["structure_batch_from_numpy", "to_numpy"]


def structure_batch_from_numpy(xyz, atom_mask, chain_idx, residue_idx,
                               chain_ids=None, seq=None,
                               device: DeviceLike = "cpu") -> StructureBatch:
    """The port's batch holding exactly these arrays (no re-validation).

    ``xyz`` is cast to float32, ``atom_mask`` to bool and the index arrays to
    int32; values, NaNs and padding are kept as given.
    """
    return StructureBatch._from_numpy(
        np.asarray(xyz), np.asarray(atom_mask), np.asarray(chain_idx),
        np.asarray(residue_idx), _freeze_chain_ids(chain_ids), _freeze_seq(seq),
        resolve_device(device))


def to_numpy(sb: StructureBatch) -> Dict[str, Any]:
    """The batch's arrays on the host, as keyword arguments of
    :func:`structure_batch_from_numpy`."""
    return {
        "xyz": sb.xyz.cpu().numpy(),
        "atom_mask": sb.atom_mask.cpu().numpy(),
        "chain_idx": sb.chain_idx.cpu().numpy(),
        "residue_idx": sb.residue_idx.cpu().numpy(),
        "chain_ids": sb.chain_ids,
        "seq": sb.seq,
    }
