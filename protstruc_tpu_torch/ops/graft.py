"""Sidechain grafting: all-atom structures from backbones and a sequence,
port of ``protstruc_tpu/ops/graft.py``.

Template sidechains, stored in each residue's local backbone frame, are
placed onto the frames of a backbone: a minimal rotamer library taken from
a reference batch (one complete instance per residue type), with no
hard-coded tables.  With ``pack.pack_sidechains`` it completes the design
path: frames -> sequence -> all-atom -> repack.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from protstruc_tpu_torch import geometry as geom

__all__ = ["sidechain_library", "build_sidechains"]


def sidechain_library(batch) -> Tuple[np.ndarray, np.ndarray]:
    """Per-residue-type template sidechains from a StructureBatch.

    For each of the 20 standard types, the first instance with its whole
    heavy-atom set (OXT aside) and its N/CA/C, stored as ``R^T (x - CA)``
    with ``R = gram_schmidt(N, CA, C)``.  Returns ``(library (21, 15, 3)
    float32, lib_mask (21, 15) bool)``, numpy on the host.
    """
    from protstruc_tpu_torch.vocab import AA, RESTYPE_HEAVY_ATOMS

    xyz = batch.xyz.detach().cpu().numpy()
    am = batch.atom_mask.cpu().numpy()
    seq = batch.get_seq_idx().cpu().numpy()
    lib = np.zeros((21, 15, 3), np.float32)
    lib_mask = np.zeros((21, 15), bool)
    for aa in range(20):
        want = np.array([bool(n) and n != "OXT" for n in RESTYPE_HEAVY_ATOMS[AA(aa)]])
        for b, l in np.argwhere(seq == aa):
            have = am[b, l] & np.isfinite(xyz[b, l]).all(-1)
            if not (have >= want).all() or not have[:3].all():
                continue
            x = torch.from_numpy(xyz[b, l])
            r = geom.gram_schmidt(x[0], x[1], x[2]).numpy()
            lib[aa] = np.nan_to_num((xyz[b, l] - xyz[b, l, 1]) @ r)  # R^T (x - CA), rows
            lib_mask[aa] = want
            break
    return lib, lib_mask


def build_sidechains(backbone_xyz: torch.Tensor, seq_idx: torch.Tensor,
                     library: Tuple[np.ndarray, np.ndarray],
                     residue_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Place the library's sidechains onto backbone frames.

    ``backbone_xyz (B, L, >=3, 3)``: slots 0/1/2 N/CA/C (further given slots,
    O and CB, are kept where finite); ``seq_idx (B, L)`` the target types.
    Returns ``(xyz (B, L, 15, 3), atom_mask (B, L, 15))``: the given
    backbone atoms, the rest placed in each residue's ``gram_schmidt(N, CA,
    C)`` frame; NaN (and mask False) where the library has no template, the
    residue is masked out, or the frame is incomplete.
    """
    dev = backbone_xyz.device
    lib = torch.as_tensor(library[0], dtype=torch.float32).to(dev)
    lib_mask = torch.as_tensor(library[1], dtype=torch.bool).to(dev)
    aa = seq_idx.long().clamp(0, 20)
    r = geom.gram_schmidt(backbone_xyz[:, :, 0], backbone_xyz[:, :, 1], backbone_xyz[:, :, 2])
    placed = torch.einsum("blij,blaj->blai", r, lib[aa]) + backbone_xyz[:, :, 1][:, :, None]
    mask = lib_mask[aa]
    if residue_mask is not None:
        mask = mask & residue_mask[..., None]
    out = torch.where(mask[..., None], placed, torch.nan)
    n_given = backbone_xyz.shape[2]
    given = torch.isfinite(backbone_xyz).all(-1)
    out = torch.cat([torch.where(given[..., None], backbone_xyz, out[:, :, :n_given]),
                     out[:, :, n_given:]], dim=2)
    mask = torch.cat([mask[:, :, :n_given] | given, mask[:, :, n_given:]], dim=2)
    if residue_mask is not None:
        mask = mask & residue_mask[..., None]
    # mask True => the atom exists: a missing N/CA/C makes every placed atom NaN
    mask = mask & torch.isfinite(out).all(-1)
    return torch.where(mask[..., None], out, torch.nan), mask
