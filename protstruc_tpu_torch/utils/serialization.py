"""StructureBatch persistence (port of ``protstruc_tpu/utils/serialization.py``).

The same file format as the JAX package, so a file either package writes
loads in the other: the tensors go to an ``.npz`` (``np.savez_compressed``)
as host arrays, the static metadata to a JSON sidecar inside the same file
(the ``__meta__`` key, UTF-8 bytes as uint8), an antibody batch's named masks
under ``residue_masks/<name>``.  A string path without the ``.npz`` suffix
gets it, on save and on load.
"""

from __future__ import annotations

import json
import os
from typing import Union

import numpy as np
import torch

__all__ = ["save_structure_batch", "load_structure_batch"]

_ARRAY_FIELDS = ["xyz", "atom_mask", "chain_idx", "residue_idx", "mu", "std"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_structure_batch(batch, path: Union[str, "io.IOBase"]) -> None:
    arrays = {}
    for f in _ARRAY_FIELDS:
        v = getattr(batch, f)
        if v is not None:
            arrays[f] = _host(v)
    meta = {
        "chain_ids": batch.chain_ids,
        "seq": batch.seq,
        "standardized": batch.standardized,
        "class": type(batch).__name__,
    }
    # keyed on the class, as the loader is: an AntibodyStructureBatch with
    # residue_masks=None still writes the chain-role metadata the loader reads
    if hasattr(batch, "heavy_chain_id"):
        for k, v in (getattr(batch, "residue_masks", None) or {}).items():
            arrays[f"residue_masks/{k}"] = _host(v)
        meta.update(
            heavy_chain_id=batch.heavy_chain_id,
            light_chain_id=batch.light_chain_id,
            antigen_chain_ids=batch.antigen_chain_ids,
            numbering_scheme=batch.numbering_scheme,
            keep_fv_only=batch.keep_fv_only,
        )
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    # np.savez_compressed appends '.npz' to a suffix-less string path and the
    # loader opens the path verbatim: normalize so that save and load agree
    if isinstance(path, str) and not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, **arrays)


def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def load_structure_batch(path: Union[str, "io.IOBase"], device="cuda"):
    """Read a batch written by either package onto ``device`` (default the
    card, which raises without one)."""
    from protstruc_tpu_torch.antibody import AntibodyStructureBatch
    from protstruc_tpu_torch.batch import StructureBatch, resolve_device

    dev = resolve_device(device)
    if isinstance(path, str) and not path.endswith(".npz"):
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    kwargs = dict(
        xyz=tensor(arrays["xyz"]),
        atom_mask=tensor(arrays["atom_mask"]),
        chain_idx=tensor(arrays["chain_idx"]),
        residue_idx=tensor(arrays["residue_idx"]),
        mu=tensor(arrays["mu"]) if "mu" in arrays else None,
        std=tensor(arrays["std"]) if "std" in arrays else None,
        chain_ids=_tuplify(meta["chain_ids"]),
        seq=_tuplify(meta["seq"]),
        standardized=meta["standardized"],
    )
    if meta["class"] == "AntibodyStructureBatch":
        masks = {k.split("/", 1)[1]: tensor(v) for k, v in arrays.items()
                 if k.startswith("residue_masks/")}
        return AntibodyStructureBatch(
            residue_masks=masks,
            heavy_chain_id=_tuplify(meta["heavy_chain_id"]),
            light_chain_id=_tuplify(meta["light_chain_id"]),
            antigen_chain_ids=_tuplify(meta["antigen_chain_ids"]),
            numbering_scheme=meta["numbering_scheme"],
            keep_fv_only=meta["keep_fv_only"],
            **kwargs,
        )
    return StructureBatch(**kwargs)
