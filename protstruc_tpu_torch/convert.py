"""State carried between the JAX package and the port.

* The batch: :func:`structure_batch_from_numpy` builds the port's batch from
  the JAX batch's arrays taken as numpy (``np.asarray(sb.xyz)``, ...), with
  its standardization state and, for an antibody batch, its named masks and
  chain roles, and :func:`to_numpy` goes back, returning the same keyword
  arguments.
* TrFold parameters: :func:`trfold_params_from_flax` turns a flax parameter
  tree (nested dicts of numpy arrays) into a ``state_dict`` of
  ``protstruc_tpu_torch.models.trfold.TrFold``, and
  :func:`trfold_params_to_flax` goes back, from a ``state_dict`` or from a
  dict of gradients with the same keys.  The port stores every leaf with
  flax's name and shape, Dense kernels included (``(in, out)``, not
  ``torch.nn.Linear``'s ``(out, in)``; ``qkv`` ``(D, 3, h, dh)``,
  ``pair_bias`` ``(P, h)``, ``out`` ``(h, dh, D)``), so a leaf is copied as
  it is and its path is joined with dots: ``block_0/attn/qkv/kernel`` ->
  ``block_0.attn.qkv.kernel``.  MoE blocks carry ``block_i.moe.router.
  {kernel, bias}`` and ``block_i.moe.{w1, b1, w2, b2}`` in flax's ``(E, D,
  H)`` / ``(E, H, D)`` layout; a pipeline's stacked stage parameters (the
  JAX package's ``stack_stage_params`` of block trees, a leading stage axis
  on every leaf) map leaf for leaf onto
  ``parallel.pipeline.stack_stage_params`` of the blocks' ``state_dict``s.
* FoldModel parameters: :func:`foldmodel_params_from_flax` and back, the same
  walk over the FoldModel tree: ``trunk`` (TrFold's tree), ``structure``
  (``structure.ipa.q_point.kernel``, ``structure.backbone_update.update.kernel``,
  ``structure.ipa.point_weight``, ...), ``recycle_node_ln``,
  ``recycle_pair_ln``, ``recycle_dist_embed``, ``plddt_head`` and
  ``pae_head``.
* The design models' parameters: :func:`inverse_fold_params_from_flax`
  (``InverseFold``: ``node_in``, ``rbf_embed``, ``attn_0``, ``LayerNorm_0``,
  ``seq_ctx``, ``dec_attn_0``, ``logits``, ...),
  :func:`framediff_params_from_flax` (``FrameDenoiser``: ``t_in``,
  ``summ_in``, ``pos_in``, ``dist_embed``, ``relpos_embed``, ``structure``)
  and :func:`diffusion_denoiser_params_from_flax` (``DiffusionDenoiser``:
  ``seq_embed``, ``coord_in``, ``t_in``, ``dist_in``, ``attn_0``, ...), each
  with its inverse: the same leaf-for-leaf walk.
"""

from __future__ import annotations

import dataclasses
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
           "trfold_params_to_flax", "foldmodel_params_from_flax", "foldmodel_params_to_flax",
           "inverse_fold_params_from_flax", "inverse_fold_params_to_flax",
           "framediff_params_from_flax", "framediff_params_to_flax",
           "diffusion_denoiser_params_from_flax", "diffusion_denoiser_params_to_flax"]


#: The antibody batch's host metadata, carried as it is.
_ANTIBODY_META = ("heavy_chain_id", "light_chain_id", "antigen_chain_ids",
                  "numbering_scheme", "keep_fv_only")


def structure_batch_from_numpy(xyz, atom_mask, chain_idx, residue_idx,
                               chain_ids=None, seq=None, mu=None, std=None,
                               standardized: bool = False, residue_masks=None,
                               device: DeviceLike = "cuda", **antibody) -> StructureBatch:
    """The port's batch holding exactly these arrays (no re-validation).

    ``xyz`` (and ``mu``/``std`` when given) is cast to float32,
    ``atom_mask`` to bool and the index arrays to int32; values, NaNs and
    padding are kept as given.  With ``residue_masks`` (a dict of ``(B, L)``
    bool arrays) the result is an ``AntibodyStructureBatch``, and
    ``antibody`` takes its ``heavy_chain_id``, ``light_chain_id``,
    ``antigen_chain_ids``, ``numbering_scheme`` and ``keep_fv_only``.
    """
    dev = resolve_device(device)
    unknown = set(antibody) - set(_ANTIBODY_META)
    if unknown or (antibody and residue_masks is None):
        raise TypeError(f"unexpected keyword arguments {sorted(antibody)}")
    sb = StructureBatch._from_numpy(
        np.asarray(xyz), np.asarray(atom_mask), np.asarray(chain_idx),
        np.asarray(residue_idx), _freeze_chain_ids(chain_ids), _freeze_seq(seq), dev)

    def f32(a):
        return None if a is None else torch.from_numpy(np.asarray(a, np.float32).copy()).to(dev)

    sb = sb.replace(mu=f32(mu), std=f32(std), standardized=bool(standardized))
    if residue_masks is None:
        return sb
    from protstruc_tpu_torch.antibody import AntibodyStructureBatch

    masks = {k: torch.from_numpy(np.asarray(v, bool).copy()).to(dev)
             for k, v in residue_masks.items()}
    meta = {k: _freeze_meta(k, v) for k, v in antibody.items()}
    return AntibodyStructureBatch(**{f.name: getattr(sb, f.name)
                                     for f in dataclasses.fields(sb)},
                                  residue_masks=masks, **meta)


def _freeze_meta(name, value):
    if name == "antigen_chain_ids" and value is not None:
        return tuple(tuple(a) for a in value)
    if name in ("heavy_chain_id", "light_chain_id") and value is not None:
        return tuple(value)
    return value


def to_numpy(sb: StructureBatch) -> Dict[str, Any]:
    """The batch's arrays on the host, as keyword arguments of
    :func:`structure_batch_from_numpy` (an antibody batch's masks and
    metadata included)."""
    def host(t):
        return None if t is None else t.cpu().numpy()

    out = {
        "xyz": host(sb.xyz),
        "atom_mask": host(sb.atom_mask),
        "chain_idx": host(sb.chain_idx),
        "residue_idx": host(sb.residue_idx),
        "chain_ids": sb.chain_ids,
        "seq": sb.seq,
        "mu": host(sb.mu),
        "std": host(sb.std),
        "standardized": sb.standardized,
    }
    if getattr(sb, "residue_masks", None) is not None:
        out["residue_masks"] = {k: host(v) for k, v in sb.residue_masks.items()}
        out.update({k: getattr(sb, k) for k in _ANTIBODY_META})
    return out


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


#: The design models keep flax's tree as TrFold does: the same walk.
inverse_fold_params_from_flax = framediff_params_from_flax = trfold_params_from_flax
diffusion_denoiser_params_from_flax = trfold_params_from_flax
inverse_fold_params_to_flax = framediff_params_to_flax = trfold_params_to_flax
diffusion_denoiser_params_to_flax = trfold_params_to_flax
