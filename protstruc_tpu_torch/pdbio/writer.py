"""PDB writer for backbone coordinates (port of ``to_pdb`` from
``protstruc_tpu/pdbio/writer.py``, numpy only): ``(5, L, 3)`` N/CA/C/O/CB
as fixed-format ATOM lines, CB skipped for glycine, an optional per-residue
B-factor column (pLDDT)."""

from __future__ import annotations

from typing import List

import numpy as np

from protstruc_tpu_torch.vocab import one2three

__all__ = ["to_pdb"]


def _atom_line(serial, atom, aa3, chain_id, res_num, x, y, z, bfactor=0.0) -> str:
    return (f"ATOM  {serial:5d}  {atom:4s}{aa3} {chain_id}{res_num:4d}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00{bfactor:6.2f}\n")


def to_pdb(filename: str, coords: np.ndarray, sequences: List[str], chain_ids: List[str],
           atoms: List[str] = ("N", "CA", "C", "O", "CB"), bfactors: np.ndarray = None) -> None:
    """Write ``(n_atoms, L, 3)`` per-atom-type coordinates: one-letter
    ``sequences`` and ``chain_ids`` per chain; ``bfactors``: optional ``(L,)``."""
    coords = np.asarray(coords)
    if bfactors is not None:
        bfactors = np.asarray(bfactors)
    with open(filename, "w") as out:
        coord_idx, serial = 0, 1
        for seq, chain_id in zip(sequences, chain_ids):
            for res_num, aa1 in enumerate(seq, start=1):
                aa3 = one2three[aa1]
                b = float(bfactors[coord_idx]) if bfactors is not None else 0.0
                for atom_idx, atom in enumerate(atoms):
                    if atom == "CB" and aa1 == "G":
                        continue
                    x, y, z = coords[atom_idx, coord_idx]
                    out.write(_atom_line(serial, atom, aa3, chain_id, res_num, x, y, z, b))
                    serial += 1
                coord_idx += 1
