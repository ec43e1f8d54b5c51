"""StructureBatch: a batch of padded protein structures as torch tensors.

Port of the featurization part of ``protstruc_tpu/batch.py``.  The batch is a
frozen dataclass of tensors that all live on one explicit ``device``;
manipulators (``to``) return a new batch, as in the JAX package.

* constructors put the batch on ``"cuda"`` unless told otherwise (without a
  card that raises, see :func:`resolve_device`);
* ``chain_idx``/``residue_idx`` are int32 with ``-1`` padding; missing-atom
  coordinates are NaN with ``atom_mask`` False.
* ``inter_residue_geometry`` computes each ``(B, L, L)`` map directly: by
  default through the K1 pair-map kernel (its plain version on the CPU), or
  with ``use_kernel=False`` through the arccos-form broadcast path
  (``ops/pairwise.py``), the port of the JAX package's jnp path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.constants import MAX_N_ATOMS_PER_RESIDUE
from protstruc_tpu_torch.ops import pairwise as pairwise_ops
from protstruc_tpu_torch.vocab import AA, ATOM, ressymb_to_resindex

__all__ = ["StructureBatch", "PAD_IDX", "resolve_device"]

#: Padding sentinel for integer per-residue annotations.
PAD_IDX = -1
#: Fill value used when shifting chain_idx for terminal detection; must
#: differ from both PAD_IDX and any valid chain index.
_SHIFT_FILL = -2

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device(device)`` with a concrete CUDA index.

    Raises if it names CUDA and there is none: there is no silent retreat to
    the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _freeze_chain_ids(chain_ids) -> Optional[Tuple[Tuple[str, ...], ...]]:
    if chain_ids is None:
        return None
    return tuple(tuple(c) for c in chain_ids)


def _freeze_seq(seq) -> Optional[Tuple[Tuple[Tuple[str, str], ...], ...]]:
    if seq is None:
        return None
    return tuple(tuple(sorted(d.items())) if isinstance(d, dict) else tuple(d) for d in seq)


def _int_or_pad(x, default: np.ndarray) -> np.ndarray:
    """Host int32 (B, L) annotation: NaN -> PAD_IDX, None -> ``default``."""
    if x is None:
        return default
    raw = np.asarray(x)
    return np.where(np.isnan(raw.astype(np.float64)), PAD_IDX, raw).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class StructureBatch:
    """A batch of (padded) protein structures, all tensors on one device.

    Tensor fields:
        xyz: ``(B, L, A, 3)`` float32 atom coordinates; NaN where an atom is
            absent from the source structure.
        atom_mask: ``(B, L, A)`` bool; True where the atom exists.
        chain_idx: ``(B, L)`` int32 chain index per residue (0-based within
            each structure), ``-1`` at padding.
        residue_idx: ``(B, L)`` int32 residue numbering, ``-1`` at padding.

    Host metadata:
        chain_ids: per-structure tuple of chain-ID strings.
        seq: per-structure tuple of ``(chain_id, sequence)`` pairs.
    """

    xyz: torch.Tensor
    atom_mask: torch.Tensor
    chain_idx: torch.Tensor
    residue_idx: torch.Tensor
    chain_ids: Optional[Tuple[Tuple[str, ...], ...]] = None
    seq: Optional[Tuple[Tuple[Tuple[str, str], ...], ...]] = None

    def __post_init__(self):
        devices = {t.device for t in (self.xyz, self.atom_mask, self.chain_idx,
                                      self.residue_idx)}
        if len(devices) != 1:
            raise ValueError(f"StructureBatch tensors span devices {sorted(map(str, devices))}")

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_xyz(
        cls,
        xyz,
        atom_mask=None,
        chain_idx=None,
        chain_ids: Optional[List[List[str]]] = None,
        seq: Optional[List[Dict[str, str]]] = None,
        residue_idx=None,
        device: DeviceLike = "cuda",
    ) -> "StructureBatch":
        """Build a batch from a raw coordinate array (numpy or tensor).

        ``xyz``: ``(B, L, A, 3)``; ``atom_mask`` defaults to all-True;
        ``chain_idx`` must start at 0 per structure and defaults to zeros.
        ``chain_idx`` and ``chain_ids`` must be passed together.
        """
        dev = resolve_device(device)
        if (chain_idx is None) != (chain_ids is None):
            raise ValueError(
                "Both `chain_idx` and `chain_ids` should be provided or None."
            )
        xyz_np = _to_numpy(xyz).astype(np.float32)
        bsz, n_res, n_atoms = xyz_np.shape[:3]

        if atom_mask is None:
            am = np.ones((bsz, n_res, n_atoms), dtype=bool)
        else:
            am = _to_numpy(atom_mask).astype(bool)

        ci = _int_or_pad(_to_numpy(chain_idx), np.zeros((bsz, n_res), dtype=np.int32))
        for i in range(bsz):
            valid = ci[i][ci[i] != PAD_IDX]
            if valid.size and valid.min() != 0:
                raise ValueError(f"Protein {i}: Chain index should start from zero")
        ri = _int_or_pad(
            _to_numpy(residue_idx),
            np.broadcast_to(np.arange(n_res, dtype=np.int32), (bsz, n_res)).copy())

        return cls._from_numpy(xyz_np, am, ci, ri, _freeze_chain_ids(chain_ids),
                               _freeze_seq(seq), dev)

    @classmethod
    def from_pdb(cls, pdb_path: Union[str, List[str]],
                 device: DeviceLike = "cuda") -> "StructureBatch":
        """Parse one or more PDB/mmCIF files into a padded batch (A = 15).

        Parse and pad on the host, then one transfer to ``device``.
        """
        from protstruc_tpu_torch.pdbio.parser import parse_pdb_files

        dev = resolve_device(device)
        paths = pdb_path if isinstance(pdb_path, list) else [pdb_path]
        return cls._from_parsed(parse_pdb_files(paths), device=dev)

    @classmethod
    def _from_parsed(cls, parsed, target_length=None,
                     device: DeviceLike = "cuda") -> "StructureBatch":
        """Pad a list of parsed single structures into one batch.

        ``target_length`` pads to a fixed residue count instead of the batch max.
        """
        bsz = len(parsed)
        max_l = target_length or max(p.n_residues for p in parsed)
        A = MAX_N_ATOMS_PER_RESIDUE

        xyz = np.zeros((bsz, max_l, A, 3), dtype=np.float32)
        atom_mask = np.zeros((bsz, max_l, A), dtype=bool)
        chain_idx = np.full((bsz, max_l), PAD_IDX, dtype=np.int32)
        residue_idx = np.full((bsz, max_l), PAD_IDX, dtype=np.int32)

        chain_ids, seqs = [], []
        for i, p in enumerate(parsed):
            n = p.n_residues
            xyz[i, :n] = p.atom_xyz
            atom_mask[i, :n] = p.atom_mask
            chain_idx[i, :n] = p.chain_idx
            residue_idx[i, :n] = p.residue_idx
            chain_ids.append(p.chain_order)
            seqs.append(p.seq_dict())

        return cls._from_numpy(xyz, atom_mask, chain_idx, residue_idx,
                               _freeze_chain_ids(chain_ids), _freeze_seq(seqs),
                               resolve_device(device))

    @classmethod
    def _from_numpy(cls, xyz, atom_mask, chain_idx, residue_idx, chain_ids, seq,
                    device: torch.device) -> "StructureBatch":
        def t(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        return cls(
            xyz=t(xyz, np.float32),
            atom_mask=t(atom_mask, bool),
            chain_idx=t(chain_idx, np.int32),
            residue_idx=t(residue_idx, np.int32),
            chain_ids=chain_ids,
            seq=seq,
        )

    def to(self, device: DeviceLike) -> "StructureBatch":
        """A new batch with every tensor on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self,
            xyz=self.xyz.to(dev),
            atom_mask=self.atom_mask.to(dev),
            chain_idx=self.chain_idx.to(dev),
            residue_idx=self.residue_idx.to(dev),
        )

    def random_crop(self, size: int, generator: Optional[torch.Generator] = None,
                    extras=(), starts=None):
        """A contiguous window of ``size`` residues per structure.

        Each structure's window starts uniformly inside its valid span:
        ``start = min(int(u * (max_start + 1)), max_start)`` with ``u`` drawn
        from ``generator`` (on the CPU, then moved) and ``max_start =
        max(length - size, 0)``, as the JAX package draws it from a key.
        ``starts`` (``(B,)`` ints) replaces the draw.  ``seq`` is dropped (it
        cannot follow the crop); pass ``get_seq_idx()`` through ``extras``
        (``(B, L, ...)`` tensors cropped alike) to keep it.  Returns the
        cropped batch, or ``(batch, cropped_extras)`` with ``extras``.
        """
        if size > self.n_residues:
            raise ValueError(f"crop size {size} > padded length {self.n_residues}")
        max_start = torch.clamp_min(self.get_total_lengths() - size, 0)
        if starts is None:
            u = torch.rand(self.batch_size, generator=generator).to(self.device)
            starts = (u * (max_start + 1).to(u.dtype)).to(torch.int64)
        starts = torch.minimum(torch.as_tensor(starts, device=self.device).long(), max_start)
        idx = starts[:, None] + torch.arange(size, device=self.device)[None, :]
        rows = torch.arange(self.batch_size, device=self.device)[:, None]

        def crop(x):
            return x[rows, idx]

        cropped = dataclasses.replace(
            self, xyz=crop(self.xyz), atom_mask=crop(self.atom_mask),
            chain_idx=crop(self.chain_idx), residue_idx=crop(self.residue_idx), seq=None)
        if extras:
            return cropped, tuple(crop(torch.as_tensor(e, device=self.device)) for e in extras)
        return cropped

    # ------------------------------------------------------------------
    # basic accessors
    # ------------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    @property
    def batch_size(self) -> int:
        return self.xyz.shape[0]

    @property
    def n_residues(self) -> int:
        return self.xyz.shape[1]

    @property
    def max_n_atoms_per_residue(self) -> int:
        return self.xyz.shape[2]

    @property
    def residue_mask(self) -> torch.Tensor:
        """``(B, L)`` bool: any atom present."""
        return self.atom_mask.any(dim=-1)

    def get_batch_size(self) -> int:
        return self.batch_size

    def get_xyz(self) -> torch.Tensor:
        return self.xyz

    def get_atom_mask(self) -> torch.Tensor:
        return self.atom_mask

    def get_residue_mask(self) -> torch.Tensor:
        """CA-slot mask — *not* the any-atom mask (reference parity)."""
        return self.atom_mask[:, :, int(ATOM.CA)]

    def get_chain_idx(self) -> torch.Tensor:
        return self.chain_idx

    def get_chain_ids(self) -> Optional[List[List[str]]]:
        if self.chain_ids is None:
            return None
        return [list(c) for c in self.chain_ids]

    def get_seq(self) -> Optional[List[Dict[str, str]]]:
        if self.seq is None:
            return None
        return [dict(s) for s in self.seq]

    def get_max_n_residues(self) -> int:
        return self.n_residues

    def get_max_n_atoms_per_residue(self) -> int:
        return self.max_n_atoms_per_residue

    def get_seq_idx(self) -> torch.Tensor:
        """``(B, L)`` int32 residue-type indices, UNK at padding."""
        if self.seq is None or self.chain_ids is None:
            raise ValueError("sequence information not available")
        out = np.full((self.batch_size, self.n_residues), int(AA.UNK), np.int32)
        for i, (seq_pairs, cids) in enumerate(zip(self.seq, self.chain_ids)):
            d = dict(seq_pairs)
            concat = "".join(d[c] for c in cids)
            n = min(len(concat), self.n_residues)
            out[i, :n] = [ressymb_to_resindex[r] for r in concat[:n]]
        return torch.from_numpy(out).to(self.device)

    def get_total_lengths(self) -> torch.Tensor:
        """Index of last valid residue + 1 per structure, ``(B,)`` int64."""
        rm = self.residue_mask.to(torch.int32)
        return torch.argmax(torch.cumsum(rm, dim=1), dim=1) + 1

    # ------------------------------------------------------------------
    # terminal masks
    # ------------------------------------------------------------------

    def get_n_terminal_mask(self) -> torch.Tensor:
        """True at the first residue of every chain. ``(B, L)`` bool."""
        return _terminal_masks(self.chain_idx, self.residue_mask)[0]

    def get_c_terminal_mask(self) -> torch.Tensor:
        """True at the last residue of every chain. ``(B, L)`` bool."""
        return _terminal_masks(self.chain_idx, self.residue_mask)[1]

    # ------------------------------------------------------------------
    # featurization
    # ------------------------------------------------------------------

    def backbone_dihedrals(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Backbone (phi, psi, omega) per residue ``(B, L, 3)`` + definedness mask.

        Zero-filled at undefined positions, zeroed at chain N-terms (phi) /
        C-terms (psi, omega); the mask is ``~[nterm, cterm, cterm] & residue_mask``.
        """
        return _backbone_dihedrals(self.xyz, self.chain_idx, self.atom_mask)

    def backbone_orientations(
        self, a1: str = "N", a2: str = "CA", a3: str = "C"
    ) -> torch.Tensor:
        """Per-residue Gram-Schmidt frames ``(B, L, 3, 3)``."""
        return geom.gram_schmidt(
            self.xyz[:, :, int(ATOM[a1])],
            self.xyz[:, :, int(ATOM[a2])],
            self.xyz[:, :, int(ATOM[a3])],
        )

    def backbone_translations(self, atom: str = "CA") -> torch.Tensor:
        """Coordinates of a backbone atom per residue ``(B, L, 3)``."""
        return self.xyz[:, :, int(ATOM[atom])]

    def inter_residue_geometry(self, use_kernel: bool = True) -> Dict[str, torch.Tensor]:
        """trRosetta 6D inter-residue geometry, each map ``(B, L, L)``.

        d_ca/d_cb/d_no distance maps (+ masks), omega/theta pair dihedrals and
        phi planar angles.  ``use_kernel=True`` takes the K1 pair-map kernel
        on a CUDA batch and its plain version on a CPU batch
        (``ops/pair_maps.py``, atan2 form for phi); ``use_kernel=False`` takes
        the arccos-form broadcast path (``ops/pairwise.py``).
        """
        if use_kernel:
            from protstruc_tpu_torch.ops.pair_maps import trrosetta_features

            return trrosetta_features(self.xyz, self.atom_mask)
        return _inter_residue_geometry(self.xyz, self.atom_mask)


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# compute cores
# ---------------------------------------------------------------------------


def _shift(x: torch.Tensor, step: int, fill: int) -> torch.Tensor:
    """Shift a ``(B, L)`` tensor along L by ``step`` (+1 right, -1 left), filling."""
    col = torch.full_like(x[:, :1], fill)
    if step > 0:
        return torch.cat([col, x[:, :-1]], dim=1)
    return torch.cat([x[:, 1:], col], dim=1)


def _terminal_masks(chain_idx: torch.Tensor, residue_mask: torch.Tensor):
    nterm = (chain_idx != _shift(chain_idx, 1, _SHIFT_FILL)) & residue_mask
    cterm = (chain_idx != _shift(chain_idx, -1, _SHIFT_FILL)) & residue_mask
    return nterm, cterm


def _backbone_dihedrals(xyz, chain_idx, atom_mask):
    n = xyz[:, :, int(ATOM.N)]
    ca = xyz[:, :, int(ATOM.CA)]
    c = xyz[:, :, int(ATOM.C)]

    residue_mask = atom_mask.any(dim=-1)
    nterm, cterm = _terminal_masks(chain_idx, residue_mask)
    pad = torch.nn.functional.pad

    # phi_i = dih(C_{i-1}, N_i, CA_i, C_i); undefined at i=0 -> left pad
    phi = pad(geom.dihedral(c[:, :-1], n[:, 1:], ca[:, 1:], c[:, 1:]), (1, 0))
    phi = torch.where(nterm, 0.0, phi)

    # psi_i = dih(N_i, CA_i, C_i, N_{i+1}); undefined at i=L-1 -> right pad
    psi = pad(geom.dihedral(n[:, :-1], ca[:, :-1], c[:, :-1], n[:, 1:]), (0, 1))
    psi = torch.where(cterm, 0.0, psi)

    # omega_i = dih(CA_i, C_i, N_{i+1}, CA_{i+1})
    omega = pad(geom.dihedral(ca[:, :-1], c[:, :-1], n[:, 1:], ca[:, 1:]), (0, 1))
    omega = torch.where(cterm, 0.0, omega)

    dihedrals = torch.stack([phi, psi, omega], dim=-1)
    dihedral_mask = ~torch.stack([nterm, cterm, cterm], dim=-1)
    return dihedrals, dihedral_mask & residue_mask[:, :, None]


def _inter_residue_geometry(xyz, atom_mask):
    ret = {}
    for key, (ai, aj) in (("d_ca", ("CA", "CA")), ("d_cb", ("CB", "CB")),
                          ("d_no", ("N", "O"))):
        ret[key], ret[f"{key}_mask"] = pairwise_ops.pairwise_atom_distance(
            xyz, atom_mask, ai, aj)
    ret["omega"] = pairwise_ops.pairwise_dihedral_maps(xyz, ("CA", "CB"), ("CA", "CB"))
    ret["theta"] = pairwise_ops.pairwise_dihedral_maps(xyz, ("N", "CA", "CB"), ("CB",))
    ret["phi"] = pairwise_ops.pairwise_planar_angle_maps(xyz, ("CA", "CB"), ("CB",))
    return ret
