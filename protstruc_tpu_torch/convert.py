"""State carried between the JAX package and the port.

* The batch: :func:`structure_batch_from_numpy` builds the port's batch from
  the JAX batch's arrays taken as numpy (``np.asarray(sb.xyz)``, ...), and
  :func:`to_numpy` goes back, returning the same keyword arguments.
* TrFold parameters: :func:`trfold_params_from_flax` turns a flax parameter
  tree (nested dicts of numpy arrays) into a ``state_dict`` of
  ``protstruc_tpu_torch.models.trfold.TrFold``, and
  :func:`trfold_params_to_flax` goes back, from a ``state_dict`` or from a
  dict of gradients with the same keys.  The port stores every leaf with
  flax's name and shape, Dense kernels included (``(in, out)``, not
  ``torch.nn.Linear``'s ``(out, in)``; ``qkv`` ``(D, 3, h, dh)``,
  ``pair_bias`` ``(P, h)``, ``out`` ``(h, dh, D)``), so a leaf is copied as
  it is and its path is joined with dots: ``block_0/attn/qkv/kernel`` ->
  ``block_0.attn.qkv.kernel``.
* FoldModel parameters: :func:`foldmodel_params_from_flax` and back, the same
  walk over the FoldModel tree: ``trunk`` (TrFold's tree), ``structure``
  (``structure.ipa.q_point.kernel``, ``structure.backbone_update.update.kernel``,
  ``structure.ipa.point_weight``, ...), ``recycle_node_ln``,
  ``recycle_pair_ln``, ``recycle_dist_embed``, ``plddt_head`` and
  ``pae_head``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from protstruc_tpu_torch.batch import (
    DeviceLike,
    StructureBatch,
    _freeze_chain_ids,
    _freeze_seq,
    resolve_device,
)

__all__ = ["structure_batch_from_numpy", "to_numpy", "trfold_params_from_flax",
           "trfold_params_to_flax", "foldmodel_params_from_flax", "foldmodel_params_to_flax"]


def structure_batch_from_numpy(xyz, atom_mask, chain_idx, residue_idx,
                               chain_ids=None, seq=None,
                               device: DeviceLike = "cuda") -> StructureBatch:
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


def trfold_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax TrFold parameter tree (nested dicts of arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) -> the port's
    ``state_dict``: each leaf copied into a tensor of the same shape and
    dtype, under its dotted path."""
    out: Dict[str, torch.Tensor] = {}

    def walk(prefix: str, node: Mapping[str, Any]) -> None:
        for name, v in node.items():
            if isinstance(v, Mapping):
                walk(f"{prefix}{name}.", v)
            else:
                out[prefix + name] = torch.from_numpy(np.array(v))

    walk("", tree)
    return out


def trfold_params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`trfold_params_from_flax`: a ``state_dict`` (or
    gradients keyed like it) -> nested dicts of numpy arrays, flax's tree."""
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        *path, leaf = key.split(".")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = t.detach().cpu().numpy()
    return tree


def foldmodel_params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax FoldModel parameter tree -> the ``state_dict`` of
    ``protstruc_tpu_torch.models.ipa.FoldModel`` (leaves copied, paths
    dotted: ``structure/ipa/q_point/kernel`` -> ``structure.ipa.q_point.kernel``)."""
    return trfold_params_from_flax(tree)


def foldmodel_params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`foldmodel_params_from_flax`."""
    return trfold_params_to_flax(state)
