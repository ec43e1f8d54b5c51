"""StructureBatch: a batch of padded protein structures as torch tensors.

Port of ``protstruc_tpu/batch.py``.  The batch is a frozen dataclass of
tensors that all live on one explicit ``device``; manipulators (``to``,
``translate``, ``rotate``, ``standardize``, ``center_at``, ``align``,
``diffuse_xyz``, the selections) return a new batch, as in the JAX package.

* constructors put the batch on ``"cuda"`` unless told otherwise (without a
  card that raises, see :func:`resolve_device`);
* ``chain_idx``/``residue_idx`` are int32 with ``-1`` padding; missing-atom
  coordinates are NaN with ``atom_mask`` False.
* the analysis methods (``secondary_structure``, ``sasa``, ``clash_energy``,
  ``relax``, ...) run the plain PyTorch ops of ``ops/`` on the batch's device.
* the 3x3 rotations (``rotate``, ``get_local_xyz``,
  ``from_backbone_orientations_translations``) are written out as sums of
  three products (``geometry.dot``), not as matrix products, so no TF32
  setting can lower their precision (the JAX package asks for
  ``precision="highest"``).
* randomness (``diffuse_xyz``, ``random_crop``) comes from an explicit
  ``torch.Generator`` where the JAX package takes a PRNG key.
* ``inter_residue_geometry`` computes each ``(B, L, L)`` map directly: by
  default through the arccos-form broadcast path (``ops/pairwise.py``), the
  port of the JAX package's jnp path and its default, or with
  ``use_kernel=True`` (the JAX ``use_pallas=True``) through the K1 pair-map
  kernel (its plain version on the CPU), differentiable in ``xyz`` through
  K2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
        mu, std: ``(B, 3)`` standardization statistics (present only after
            ``standardize``).

    Host metadata:
        chain_ids: per-structure tuple of chain-ID strings.
        seq: per-structure tuple of ``(chain_id, sequence)`` pairs.
        standardized: whether coordinates are in standardized space.
    """

    xyz: torch.Tensor
    atom_mask: torch.Tensor
    chain_idx: torch.Tensor
    residue_idx: torch.Tensor
    mu: Optional[torch.Tensor] = None
    std: Optional[torch.Tensor] = None
    chain_ids: Optional[Tuple[Tuple[str, ...], ...]] = None
    seq: Optional[Tuple[Tuple[Tuple[str, str], ...], ...]] = None
    standardized: bool = False

    def _tensor_fields(self) -> Dict[str, object]:
        """Every tensor-valued field (a dict of tensors counts as one), by name."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor) or (isinstance(v, dict) and v
                                               and all(isinstance(t, torch.Tensor)
                                                       for t in v.values())):
                out[f.name] = v
        return out

    def __post_init__(self):
        devices = set()
        for v in self._tensor_fields().values():
            devices |= {t.device for t in (v.values() if isinstance(v, dict) else (v,))}
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
        # coordinates and atom mask go to ``device`` directly (a tensor
        # already there is not copied through the host)
        xyz_t = _device_tensor(xyz, torch.float32, dev)
        bsz, n_res, n_atoms = xyz_t.shape[:3]

        if atom_mask is None:
            am = torch.ones((bsz, n_res, n_atoms), dtype=torch.bool, device=dev)
        else:
            am = _device_tensor(atom_mask, torch.bool, dev)

        ci = _int_or_pad(_to_numpy(chain_idx), np.zeros((bsz, n_res), dtype=np.int32))
        for i in range(bsz):
            valid = ci[i][ci[i] != PAD_IDX]
            if valid.size and valid.min() != 0:
                raise ValueError(f"Protein {i}: Chain index should start from zero")
        ri = _int_or_pad(
            _to_numpy(residue_idx),
            np.broadcast_to(np.arange(n_res, dtype=np.int32), (bsz, n_res)).copy())

        return cls(xyz=xyz_t.contiguous(), atom_mask=am.contiguous(),
                   chain_idx=torch.from_numpy(ci).to(dev),
                   residue_idx=torch.from_numpy(np.ascontiguousarray(ri)).to(dev),
                   chain_ids=_freeze_chain_ids(chain_ids), seq=_freeze_seq(seq))

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
    def from_pdb_id(cls, pdb_id: Union[str, List[str]],
                    device: DeviceLike = "cuda") -> "StructureBatch":
        """Fetch PDB entries (local cache first, ``pdbio/fetch.py``) and build
        a batch on ``device``, as :meth:`from_pdb` does from the files."""
        from protstruc_tpu_torch.pdbio.fetch import fetch_pdb

        ids = pdb_id if isinstance(pdb_id, list) else [pdb_id]
        return cls.from_pdb([fetch_pdb(i) for i in ids], device=device)

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

    @classmethod
    def from_backbone_orientations_translations(
        cls,
        orientations,
        translations,
        chain_idx=None,
        chain_ids=None,
        seq=None,
        residue_idx=None,
        include_cb: bool = False,
        device: DeviceLike = "cuda",
    ) -> "StructureBatch":
        """Place ideal backbones under per-residue rigid frames.

        ``orientations``: ``(B, L, 3, 3)``, ``translations``: ``(B, L, 3)``;
        atoms padded to A = 15 with zero coordinates and a False mask.
        """
        dev = resolve_device(device)
        rot = torch.as_tensor(orientations, dtype=torch.float32, device=dev)
        trans = torch.as_tensor(translations, dtype=torch.float32, device=dev)
        bsz, n_res = rot.shape[:2]

        ideal_bb = geom.ideal_backbone_coordinates((bsz, n_res), include_cb, device=dev)
        n_atoms = ideal_bb.shape[2]
        atom_xyz = _apply_rotation(rot[:, :, None], ideal_bb) + trans[:, :, None, :]

        pad_a = MAX_N_ATOMS_PER_RESIDUE - n_atoms
        atom_xyz = torch.cat([atom_xyz, atom_xyz.new_zeros((bsz, n_res, pad_a, 3))], dim=-2)
        atom_mask = torch.zeros((bsz, n_res, MAX_N_ATOMS_PER_RESIDUE), dtype=torch.bool,
                                device=dev)
        atom_mask[:, :, :n_atoms] = True
        return cls.from_xyz(atom_xyz, atom_mask, chain_idx=chain_idx, chain_ids=chain_ids,
                            seq=seq, residue_idx=residue_idx, device=dev)

    @classmethod
    def from_sequence(
        cls,
        seqs: Union[str, List[str]],
        phi: float = -2.094,
        psi: float = 2.094,
        omega: float = math.pi,
        device: DeviceLike = "cuda",
    ) -> "StructureBatch":
        """Extended-chain backbones from amino-acid sequences.

        Uniform (phi, psi, omega) torsions (by default the extended/beta
        conformation) folded by the NeRF chain, with sequence metadata so
        that ``get_seq_idx`` works.  Ragged sequences are padded to the
        longest; the padding carries the class invariants (no atoms,
        ``PAD_IDX`` in ``chain_idx``/``residue_idx``), so each shorter
        structure's C-terminus is detected and ``get_chain_mask`` never
        matches padding.
        """
        seqs = [seqs] if isinstance(seqs, str) else list(seqs)
        bsz = len(seqs)
        max_l = max(len(s) for s in seqs)

        tor = np.zeros((bsz, max_l, 3), np.float32)
        tor[..., 0], tor[..., 1], tor[..., 2] = phi, psi, omega
        base = cls.from_dihedrals(tor, device=device)

        pad = torch.from_numpy(np.arange(max_l)[None, :] >= np.array(
            [len(s) for s in seqs])[:, None]).to(base.device)
        return base.replace(
            atom_mask=base.atom_mask & ~pad[:, :, None],
            chain_idx=torch.where(pad, PAD_IDX, base.chain_idx),
            residue_idx=torch.where(pad, PAD_IDX, base.residue_idx),
            chain_ids=_freeze_chain_ids([["A"]] * bsz),
            seq=_freeze_seq([{"A": s} for s in seqs]),
        )

    @classmethod
    def from_dihedrals(
        cls,
        dihedrals,
        chain_idx=None,
        chain_ids=None,
        seq=None,
        device: DeviceLike = "cuda",
    ) -> "StructureBatch":
        """Fold a backbone from ``(B, L, 3)`` (phi, psi, omega) torsions in
        radians with the NeRF chain (``ops/nerf.py``), on ``device``: N, CA,
        C and O present, the other 11 atom slots zero and masked."""
        from protstruc_tpu_torch.ops.nerf import backbone_from_dihedrals

        dev = resolve_device(device)
        xyz4 = backbone_from_dihedrals(torch.as_tensor(dihedrals, dtype=torch.float32,
                                                       device=dev))
        bsz, n_res, n4 = xyz4.shape[:3]
        pad_a = MAX_N_ATOMS_PER_RESIDUE - n4
        xyz = torch.cat([xyz4, xyz4.new_zeros((bsz, n_res, pad_a, 3))], dim=-2)
        atom_mask = torch.zeros((bsz, n_res, MAX_N_ATOMS_PER_RESIDUE), dtype=torch.bool,
                                device=dev)
        atom_mask[:, :, :n4] = True
        return cls.from_xyz(xyz, atom_mask, chain_idx=chain_idx, chain_ids=chain_ids,
                            seq=seq, device=dev)

    def replace(self, **changes) -> "StructureBatch":
        """A new batch with the given fields replaced (functional update)."""
        return dataclasses.replace(self, **changes)

    def to(self, device: DeviceLike) -> "StructureBatch":
        """A new batch with every tensor on ``device`` (``mu``/``std`` and an
        antibody batch's named masks included)."""
        dev = resolve_device(device)
        moved = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
                 for k, v in self._tensor_fields().items()}
        return dataclasses.replace(self, **moved)

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

    def get_chain_mask(self, chain_id: str) -> torch.Tensor:
        """``(B, L)`` bool: residues of the named chain in each structure."""
        if self.chain_ids is None:
            raise ValueError("chain ids not available")
        codes = torch.tensor([cids.index(chain_id) if chain_id in cids else -99
                              for cids in self.chain_ids], dtype=torch.int32, device=self.device)
        return self.chain_idx == codes[:, None]

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

    def inter_residue_geometry(self, use_kernel: bool = False) -> Dict[str, torch.Tensor]:
        """trRosetta 6D inter-residue geometry, each map ``(B, L, L)``.

        d_ca/d_cb/d_no distance maps (+ masks), omega/theta pair dihedrals and
        phi planar angles.  ``use_kernel=False`` (the default, as the JAX
        ``use_pallas=False``) takes the arccos-form broadcast path
        (``ops/pairwise.py``); ``use_kernel=True`` takes the K1 pair-map
        kernel on a CUDA batch and its plain version on a CPU batch
        (``ops/pair_maps.py``, atan2 form for phi), with K2 (or its plain
        version) as the backward.
        """
        if use_kernel:
            from protstruc_tpu_torch.ops.pair_maps import trrosetta_features

            return trrosetta_features(self.xyz, self.atom_mask)
        return _inter_residue_geometry(self.xyz, self.atom_mask)

    def pairwise_distance_matrix(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full ``(B, L, L, A, A)`` all-atom distance tensor + mask.

        Memory-heavy parity escape hatch: prefer ``pairwise_atom_distance``
        / ``inter_residue_geometry``, which never build the A x A axis.
        """
        return pairwise_ops.full_pairwise_distance_matrix(self.xyz, self.atom_mask)

    def pairwise_atom_distance(self, atom_i: str = "CA",
                               atom_j: str = "CA") -> Tuple[torch.Tensor, torch.Tensor]:
        """One ``(B, L, L)`` distance map between two atom slots + mask."""
        return pairwise_ops.pairwise_atom_distance(self.xyz, self.atom_mask, atom_i, atom_j)

    def pairwise_dihedrals(self, atoms_i: Sequence[str], atoms_j: Sequence[str]) -> torch.Tensor:
        """``(B, L, L)`` inter-residue dihedral map: ``atoms_i`` of residue i
        then ``atoms_j`` of residue j (four in all)."""
        return pairwise_ops.pairwise_dihedral_maps(self.xyz, tuple(atoms_i), tuple(atoms_j))

    def pairwise_planar_angles(self, atoms_i: Sequence[str],
                               atoms_j: Sequence[str]) -> torch.Tensor:
        """``(B, L, L)`` inter-residue planar-angle map (three atoms in all)."""
        return pairwise_ops.pairwise_planar_angle_maps(self.xyz, tuple(atoms_i), tuple(atoms_j))

    def get_local_xyz(self) -> torch.Tensor:
        """Atom coordinates rotated into each residue's local frame,
        ``(B, L, A, 3)``.  Keeps the reference's quirk of subtracting the CA
        coordinate after the rotation (``R^T x - x_CA``, not
        ``R^T (x - x_CA)``)."""
        r_t = self.backbone_orientations().transpose(-1, -2)  # (B, L, 3, 3)
        return _apply_rotation(r_t[:, :, None], self.xyz) - self.xyz[:, :, int(ATOM.CA), None, :]

    # ------------------------------------------------------------------
    # rigid manipulation (functional)
    # ------------------------------------------------------------------

    def translate(self, translation, atomwise: bool = False) -> "StructureBatch":
        """Translate by ``(B, L, 3)`` (residue-wise) or ``(B, L, A, 3)`` (atomwise)."""
        t = torch.as_tensor(translation, dtype=self.xyz.dtype, device=self.device)
        if not atomwise:
            t = t[:, :, None, :]
        return self.replace(xyz=self.xyz + t)

    def rotate(self, rotation) -> "StructureBatch":
        """Rotate by ``(3, 3)`` (shared) or ``(B, 3, 3)`` (per-structure)."""
        r = torch.as_tensor(rotation, dtype=self.xyz.dtype, device=self.device)
        if r.dim() == 2:
            r = r[None]
        return self.replace(xyz=_apply_rotation(r[:, None, None], self.xyz))

    def standardize(self, atom_mask=None, residue_mask=None) -> "StructureBatch":
        """Shift and scale coordinates to zero mean and unit per-component
        std over the masked atoms (``mu``, ``std``: ``(B, 3)``, kept on the
        batch).  ``atom_mask`` ``(B, L, A)`` or ``residue_mask`` ``(B, L)``
        (not both) narrows the atoms the statistics are taken over."""
        if atom_mask is not None and residue_mask is not None:
            raise ValueError("Only one of atom_mask and residue_mask can be specified.")
        if self.standardized:
            raise ValueError("Coordinates are already standardized.")

        if atom_mask is not None:
            am = torch.as_tensor(atom_mask, device=self.device).bool() & self.atom_mask
        elif residue_mask is not None:
            am = torch.as_tensor(residue_mask, device=self.device).bool()[:, :, None] & self.atom_mask
        else:
            am = self.atom_mask

        new_xyz, mu, std = _standardize(self.xyz, am)
        return self.replace(xyz=new_xyz, mu=mu, std=std, standardized=True)

    def unstandardize(self) -> "StructureBatch":
        """Invert ``standardize``."""
        if not self.standardized:
            raise ValueError("Cannot unstandardize structures that are not standardized.")
        new_xyz = self.xyz * self.std[:, None, None, :] + self.mu[:, None, None, :]
        return self.replace(xyz=new_xyz, mu=None, std=None, standardized=False)

    def center_of_mass(self) -> torch.Tensor:
        """CA-only center of mass, NaN ignored, ``(B, 3)``."""
        return torch.nanmean(self.xyz[:, :, int(ATOM.CA)], dim=1)

    def center_at(self, center=None) -> "StructureBatch":
        """Translate so that the CA center of mass lands at ``center``
        (``(3,)`` or ``(1 | B, 3)``; default the origin)."""
        if center is None:
            center = torch.zeros((1, 3))
        center = torch.as_tensor(center, dtype=self.xyz.dtype, device=self.device)
        if center.dim() > 2 or center.shape[-1] != 3:
            raise ValueError(
                f"`center` must have a shape of (batch_size, 3) or (3,), got {tuple(center.shape)}.")
        if center.dim() == 2 and center.shape[0] not in (1, self.batch_size):
            raise ValueError(
                f"`center` must have a shape of (batch_size, 3) or (3,), got {tuple(center.shape)}.")
        if center.dim() == 1:
            center = center[None]
        translation = center - self.center_of_mass()
        return self.replace(xyz=self.xyz + translation[:, None, None, :])

    # ------------------------------------------------------------------
    # diffusion / alignment / selection
    # ------------------------------------------------------------------

    def diffuse_xyz(self, beta, generator: Optional[torch.Generator] = None) -> "StructureBatch":
        """One DDPM forward step ``xyz' = sqrt(1-beta) xyz + sqrt(beta) eps``
        with ``beta`` ``(B,)`` and eps standard normal from ``generator``
        (on the batch's device, or None for the global one)."""
        eps = torch.randn(self.xyz.shape, generator=generator, dtype=self.xyz.dtype,
                          device=self.device)
        return self._diffused(eps, beta)

    def _diffused(self, eps: torch.Tensor, beta) -> "StructureBatch":
        from protstruc_tpu_torch.ops.diffusion import _diffuse_step

        beta = torch.as_tensor(beta, dtype=self.xyz.dtype, device=self.device).reshape(-1)
        return self.replace(xyz=_diffuse_step(self.xyz, eps, beta))

    def align(self, target: "StructureBatch", atom_mask=None
              ) -> Tuple["StructureBatch", Tuple[torch.Tensor, torch.Tensor]]:
        """Kabsch-align onto ``target`` (batch size 1, broadcast, or equal),
        weighting the atoms by ``atom_mask`` (default: present in both);
        returns ``(aligned_batch, (R, t))``."""
        if target.batch_size != 1 and self.batch_size != target.batch_size:
            raise ValueError("Batch size of the two structures must be the same.")
        if atom_mask is None:
            am = self.atom_mask & target.atom_mask
        else:
            am = torch.as_tensor(atom_mask, device=self.device).bool()

        bsz = self.batch_size
        src = self.xyz.reshape(bsz, -1, 3)
        tgt = target.xyz.expand((bsz,) + target.xyz.shape[1:]).reshape(bsz, -1, 3)
        w = am.expand((bsz,) + am.shape[1:]).reshape(bsz, -1)
        r, t = geom.masked_kabsch(src, tgt, w)
        aligned = self.rotate(r).translate(t[:, None, :])
        return aligned, (r, t)

    def get_topk_nearest_residue_mask(self, query_xyz, k: int = 128, mask=None) -> torch.Tensor:
        """Top-k nearest residues (CA distance) to a set of query points.

        ``query_xyz``: ``(Q, 3)`` or ``(B, Q, 3)``; ``mask``: optional
        ``(B, L)`` candidate restriction.  A residue's distance is its
        nearest query's; residues without a valid, finite distance are never
        picked, so fewer than ``k`` may be True.  Ties go to the lower
        residue index.  Returns ``(B, L)`` bool.
        """
        q = torch.as_tensor(query_xyz, dtype=self.xyz.dtype, device=self.device)
        if q.dim() == 2:
            q = q[None]
        ca = self.xyz[:, :, int(ATOM.CA)]
        dist = geom.norm(ca[:, :, None, :] - q[:, None, :, :]).squeeze(-1).amin(dim=-1)

        valid = self.residue_mask
        if mask is not None:
            valid = valid & torch.as_tensor(mask, device=self.device).bool()
        big = 1e9
        # residues with atoms but no CA have NaN distances: send them to the
        # excluded band with the masked ones
        dist = torch.where(valid & torch.isfinite(dist), dist, big)

        k = min(k, self.n_residues)
        idx = torch.argsort(dist, dim=1, stable=True)[:, :k]
        picked = dist.gather(1, idx) < big
        return torch.zeros_like(valid).scatter(1, idx, picked)

    def residue_masked_select(self, mask) -> "StructureBatch":
        """Gather the residues selected by ``mask`` into a smaller batch.

        Ragged, B = 1 only; ``chain_ids``/``seq`` are left as they are (stale,
        like the reference's), the standardization state is kept.  For a
        fixed-shape alternative see ``residue_compact``.
        """
        if self.batch_size > 1:
            raise ValueError(
                "residue_masked_select method is not defined "
                "for a StructureBatch with batch size > 1.")
        m = _to_numpy(mask)
        if m.dtype != bool:
            raise ValueError("Mask must be a boolean tensor.")
        if m.ndim == 1:
            m = m[None]
        if m.shape != (self.batch_size, self.n_residues):
            raise ValueError(
                f"Mask shape {m.shape} does not match residue mask shape "
                f"{(self.batch_size, self.n_residues)}.")
        sel = torch.from_numpy(np.nonzero(m[0])[0]).to(self.device)
        return StructureBatch(
            xyz=self.xyz[:, sel], atom_mask=self.atom_mask[:, sel],
            chain_idx=self.chain_idx[:, sel], residue_idx=self.residue_idx[:, sel],
            chain_ids=self.chain_ids, seq=self.seq,
            mu=self.mu, std=self.std, standardized=self.standardized,
        )

    def residue_compact(self, mask) -> "StructureBatch":
        """Selected residues moved to the front, in order, at the same padded
        length; the rest masked out (``PAD_IDX`` indices).  Any batch size."""
        m, order, keep = _compact_order(mask, self)

        def take(x):
            return x.gather(1, order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
                order.shape + x.shape[2:]))

        return self.replace(
            xyz=take(self.xyz),
            atom_mask=take(self.atom_mask) & keep[:, :, None],
            chain_idx=torch.where(keep, take(self.chain_idx), PAD_IDX),
            residue_idx=torch.where(keep, take(self.residue_idx), PAD_IDX),
        )

    def split_chains(self) -> List["StructureBatch"]:
        """Split a B = 1 batch into one batch per chain, each with
        ``chain_idx`` 0 and its own chain's metadata."""
        if self.batch_size != 1:
            raise ValueError("split_chains is defined for batch size 1")
        if self.chain_ids is None:
            raise ValueError("chain ids not available")

        out = []
        ci = self.chain_idx[0].cpu().numpy()
        for code, cid in enumerate(self.chain_ids[0]):
            sub = self.residue_masked_select((ci == code)[None])
            out.append(sub.replace(
                chain_idx=torch.zeros_like(sub.chain_idx),
                chain_ids=((cid,),),
                seq=(((cid, dict(self.seq[0])[cid]),),) if self.seq is not None else None,
            ))
        return out

    def interface_residues(self, cutoff: float = 8.0, atom: str = "CB") -> torch.Tensor:
        """``(B, L)`` bool: residues with ``atom`` within ``cutoff`` A of the
        same atom of a residue of another chain (CB by default, so glycines
        count only with ``atom="CA"``)."""
        d, m = self.pairwise_atom_distance(atom, atom)
        other_chain = self.chain_idx[:, :, None] != self.chain_idx[:, None, :]
        valid = m & other_chain & (self.chain_idx >= 0)[:, None, :]
        contact = torch.nan_to_num(d, nan=math.inf) < cutoff
        return (contact & valid).any(dim=2) & self.residue_mask

    # ------------------------------------------------------------------
    # analysis (plain PyTorch ops on the batch's device)
    # ------------------------------------------------------------------

    def _backbone_nan0(self):
        xyz = torch.nan_to_num(self.xyz, nan=0.0)
        return [xyz[:, :, int(ATOM[a])] for a in ("N", "CA", "C", "O")]

    def secondary_structure(self) -> torch.Tensor:
        """DSSP-style 3-class secondary structure per residue, ``(B, L)``
        int32: 0 coil, 1 helix, 2 strand (``ops/secondary.py``)."""
        from protstruc_tpu_torch.ops.secondary import assign_secondary_structure

        ss, _ = assign_secondary_structure(*self._backbone_nan0(), self.residue_mask,
                                           chain_idx=self.chain_idx)
        return ss

    def secondary_structure_8(self) -> torch.Tensor:
        """Full 8-class DSSP assignment per residue, ``(B, L)`` int32, codes
        per ``ops.secondary.SS8_LETTERS`` ("CHEGIBTS")."""
        from protstruc_tpu_torch.ops.secondary import assign_secondary_structure_8

        return assign_secondary_structure_8(*self._backbone_nan0(), self.residue_mask,
                                            chain_idx=self.chain_idx)

    def sasa(self, probe: float = 1.4, n_points: int = 92,
             per_atom: bool = False) -> torch.Tensor:
        """Shrake-Rupley solvent-accessible surface area, ``(B, L)`` A^2
        (``ops/surface.py``); needs sequences for the per-slot radii."""
        from protstruc_tpu_torch.ops.surface import sasa as _sasa

        return _sasa(self.xyz, self.atom_mask, self.get_seq_idx(), probe=probe,
                     n_points=n_points, per_atom=per_atom)

    def radius_of_gyration(self) -> torch.Tensor:
        """Radius of gyration over valid atoms, ``(B,)`` angstrom."""
        from protstruc_tpu_torch.ops.surface import radius_of_gyration as _rg

        return _rg(self.xyz, self.atom_mask)

    def contact_order(self, cutoff: float = 8.0, relative: bool = True) -> torch.Tensor:
        """(Relative) contact order from CA coordinates, ``(B,)``, same-chain
        pairs only."""
        from protstruc_tpu_torch.ops.surface import contact_order as _co

        return _co(self.xyz[:, :, int(ATOM.CA)], self.residue_mask, cutoff=cutoff,
                   relative=relative, chain_idx=self.chain_idx)

    def lddt_to(self, other: "StructureBatch", per_residue: bool = False,
                cutoff: float = 15.0) -> torch.Tensor:
        """CA lDDT of self against a reference batch (superposition-free)."""
        from protstruc_tpu_torch.ops.metrics import lddt as _lddt

        ca_s, ca_o = self.xyz[:, :, int(ATOM.CA)], other.xyz[:, :, int(ATOM.CA)]
        mask = (self.get_residue_mask() & other.get_residue_mask()
                & torch.isfinite(ca_s).all(-1) & torch.isfinite(ca_o).all(-1))
        return _lddt(torch.nan_to_num(ca_s, nan=1e6), torch.nan_to_num(ca_o, nan=1e6),
                     mask=mask, cutoff=cutoff, per_residue=per_residue)

    def ramachandran_classes(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-residue Ramachandran classes (``ops/rama.py``): ``(classes
        (B, L) int32, valid (B, L) bool)``, 0 favored / 1 allowed / 2
        outlier over residues with defined phi AND psi."""
        from protstruc_tpu_torch.ops.rama import ramachandran_classes as _rama

        d, m = self.backbone_dihedrals()
        phi, psi = d[..., 0], d[..., 1]
        valid = m[..., 0] & m[..., 1] & torch.isfinite(phi) & torch.isfinite(psi)
        cls = _rama(torch.nan_to_num(phi), torch.nan_to_num(psi), self.get_seq_idx(), valid)
        return cls, valid

    def clash_energy(self, tolerance: float = 0.4) -> torch.Tensor:
        """Inter-residue vdW-overlap clash energy, ``(B,)`` (``ops/pack.py``)."""
        from protstruc_tpu_torch.ops.pack import clash_energy as _clash

        return _clash(self.xyz, self.atom_mask, self.get_seq_idx(), tolerance=tolerance)

    def chi_angles(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sidechain chi1-chi4 torsions ``(B, L, 4)`` and their mask (``ops/chi.py``)."""
        from protstruc_tpu_torch.ops.chi import chi_angles as _chi

        return _chi(self.xyz, self.get_seq_idx(), self.atom_mask)

    def rotate_chi(self, delta: torch.Tensor) -> "StructureBatch":
        """Rigidly rotate sidechains by ``delta (B, L, 4)`` radians per chi;
        returns a new batch."""
        from protstruc_tpu_torch.ops.chi import rotate_chi as _rot

        return self.replace(xyz=_rot(self.xyz, self.get_seq_idx(), delta, self.atom_mask))

    def pack_sidechains(self, generator: Optional[torch.Generator] = None,
                        **kwargs) -> "StructureBatch":
        """Repack sidechain chis against clashes (``ops/pack.py``), proposals
        from ``generator``; returns a new batch."""
        from protstruc_tpu_torch.ops.pack import pack_sidechains as _pack

        xyz, _ = _pack(self.xyz, self.get_seq_idx(), self.atom_mask, generator=generator, **kwargs)
        return self.replace(xyz=xyz)

    def relax(self, **kwargs) -> Tuple["StructureBatch", dict]:
        """Gradient-relax coordinates against bonded + clash energy
        (``ops/relax.py``); returns ``(relaxed_batch, energies)``."""
        from protstruc_tpu_torch.ops.relax import relax_structure

        xyz, energies = relax_structure(self.xyz, self.atom_mask, self.get_seq_idx(),
                                        self.chain_idx, **kwargs)
        return self.replace(xyz=xyz), energies


def _device_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``: a tensor is moved (or kept),
    anything else is copied from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    np_dtype = {torch.float32: np.float32, torch.bool: bool}[dtype]
    return torch.from_numpy(np.array(x, dtype=np_dtype)).to(device)


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# compute cores
# ---------------------------------------------------------------------------


def _apply_rotation(r: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``out[..., i] = sum_j r[..., i, j] x[..., j]`` as three products
    (``geometry.dot``), broadcasting ``r (..., 3, 3)`` against ``x (..., 3)``."""
    return geom.dot(r, x[..., None, :]).squeeze(-1)


def _compact_order(mask, batch):
    """The bool mask, the stable selected-first residue order and the
    ``keep`` columns (``(B, L)`` each) of a residue compaction."""
    m = torch.as_tensor(mask, device=batch.device).bool()
    order = torch.argsort((~m).to(torch.int8), dim=1, stable=True)
    keep = torch.arange(batch.n_residues, device=batch.device)[None, :] < m.sum(1, keepdim=True)
    return m, order, keep


def _standardize(xyz: torch.Tensor, atom_mask: torch.Tensor):
    am = atom_mask[..., None]  # (B, L, A, 1)
    counts = am.sum(dim=(1, 2))  # (B, 1)
    safe = torch.where(am, torch.nan_to_num(xyz, nan=0.0), 0.0)
    mu = safe.sum(dim=(1, 2)) / counts  # (B, 3)
    centered = torch.nan_to_num(xyz, nan=0.0) - mu[:, None, None, :]
    var = torch.where(am, centered ** 2, 0.0).sum(dim=(1, 2)) / counts
    std = torch.sqrt(var)
    new_xyz = (xyz - mu[:, None, None, :]) / std[:, None, None, :]
    return new_xyz, mu, std


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
