"""PDB and mmCIF writers (port of ``protstruc_tpu/pdbio/writer.py``, numpy
only).

* ``to_pdb``: ``(5, L, 3)`` N/CA/C/O/CB backbone coordinates as fixed-format
  ATOM lines, CB skipped for glycine, an optional per-residue B-factor
  column (pLDDT);
* ``structure_batch_to_pdb`` / ``structure_batch_to_cif``: one member of a
  ``StructureBatch``, every present atom slot, its chain ids and residue
  numbering (the tensors are read back to the host).
"""

from __future__ import annotations

from typing import List

import numpy as np

from protstruc_tpu_torch.vocab import AA, RESTYPE_HEAVY_ATOMS, one2three

__all__ = ["to_pdb", "structure_batch_to_pdb", "structure_batch_to_cif"]


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


_CIF_HEADER = "\n".join([
    "data_protstruc_tpu",
    "#",
    "loop_",
    "_atom_site.group_PDB",
    "_atom_site.id",
    "_atom_site.label_atom_id",
    "_atom_site.label_alt_id",
    "_atom_site.auth_comp_id",
    "_atom_site.auth_asym_id",
    "_atom_site.auth_seq_id",
    "_atom_site.pdbx_PDB_ins_code",
    "_atom_site.Cartn_x",
    "_atom_site.Cartn_y",
    "_atom_site.Cartn_z",
    "_atom_site.pdbx_PDB_model_num",
]) + "\n"


def _atoms(batch, index: int):
    """Yield ``(serial, atom name, residue name, chain id, residue number,
    x, y, z)`` for every present, named atom slot of member ``index``."""
    xyz = batch.get_xyz()[index].detach().cpu().numpy()
    mask = batch.get_atom_mask()[index].cpu().numpy()
    chain_idx = batch.get_chain_idx()[index].cpu().numpy()
    residue_idx = batch.residue_idx[index].cpu().numpy()
    chain_ids = batch.get_chain_ids()[index] if batch.get_chain_ids() else ["A"]
    seq_idx = batch.get_seq_idx()[index].cpu().numpy() if batch.seq else None
    serial = 1
    for i in range(xyz.shape[0]):
        ci = int(chain_idx[i])
        if ci < 0 or not mask[i].any():
            continue
        aa = AA(int(seq_idx[i])) if seq_idx is not None else AA.UNK
        aa3 = aa.name if aa is not AA.UNK else "UNK"
        atom_names = RESTYPE_HEAVY_ATOMS.get(aa, [""] * xyz.shape[1])
        res_num = int(residue_idx[i]) if residue_idx[i] >= 0 else i + 1
        cid = chain_ids[ci] if ci < len(chain_ids) else "A"
        for a in range(xyz.shape[1]):
            if not mask[i, a] or not atom_names[a]:
                continue
            yield (serial, atom_names[a], aa3, cid, res_num, *xyz[i, a])
            serial += 1


def structure_batch_to_cif(batch, filename: str, index: int = 0) -> None:
    """Write one member of a StructureBatch as minimal mmCIF (PDBx): the
    ``_atom_site`` loop that ``pdbio/cif.py`` reads."""
    with open(filename, "w") as out:
        out.write(_CIF_HEADER)
        for serial, atom, aa3, cid, res_num, x, y, z in _atoms(batch, index):
            out.write(f"ATOM {serial} {atom} . {aa3} {cid} {res_num} ? "
                      f"{x:.3f} {y:.3f} {z:.3f} 1\n")
        out.write("#\n")


def structure_batch_to_pdb(batch, filename: str, index: int = 0) -> None:
    """Write one member of a StructureBatch to a PDB file (all atom slots)."""
    with open(filename, "w") as out:
        for fields in _atoms(batch, index):
            out.write(_atom_line(*fields))
