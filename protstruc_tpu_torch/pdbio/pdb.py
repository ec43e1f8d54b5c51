"""Reference-shaped ``PDB`` / ``ChothiaAntibodyPDB`` classes (a copy of
``protstruc_tpu/pdbio/pdb.py`` over the port's parser and numbering schemes).

Thin object wrappers over :class:`ParsedStructure` exposing the getter API
of the reference's pdb.py (PDB: pdb.py:55-179; ChothiaAntibodyPDB:
pdb.py:182-329) so code written against the reference ports directly.
Arrays come back as NumPy (the reference returned torch tensors; the batch
API is the device-side surface).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from protstruc_tpu_torch.antibody import NUMBERING_SCHEMES
from protstruc_tpu_torch.pdbio.parser import ParsedStructure, parse_pdb
from protstruc_tpu_torch.vocab import CDR_NAMES, ressymb_to_resindex

__all__ = ["PDB", "ChothiaAntibodyPDB"]


def _always_list(x):
    return x if isinstance(x, list) else [x]


class PDB:
    """Single parsed structure with reference-style getters."""

    def __init__(self, parsed: ParsedStructure):
        self.parsed = parsed
        self.n_residues = parsed.n_residues

    @classmethod
    def read_pdb(cls, fp) -> "PDB":
        return cls(parse_pdb(fp))

    def get_atom_xyz(self):
        """(atom_xyz (L, 15, 3) with NaN for missing atoms, atom_mask (L, 15))."""
        return self.parsed.atom_xyz, self.parsed.atom_mask

    def get_chain_idx(self) -> np.ndarray:
        return self.parsed.chain_idx

    def get_chain_ids(self) -> List[str]:
        return list(self.parsed.chain_order)

    def get_residue_idx(self) -> np.ndarray:
        return self.parsed.residue_idx

    def get_seq(self) -> str:
        return self.parsed.get_seq()

    def get_seq_dict(self) -> Dict[str, str]:
        return self.parsed.seq_dict()

    def get_seq_idx(self) -> np.ndarray:
        """Integer residue types (the reference's version is dead code that
        reads a nonexistent column, pdb.py:165-167 — implemented properly)."""
        return np.array(
            [ressymb_to_resindex[c] for c in self.parsed.oneletter], dtype=np.int64
        )


class ChothiaAntibodyPDB(PDB):
    """Antibody-aware parse with chain filtering and Chothia masks."""

    fv_heavy_range = NUMBERING_SCHEMES["chothia"]["fv_heavy"]
    fv_light_range = NUMBERING_SCHEMES["chothia"]["fv_light"]
    h1_range = NUMBERING_SCHEMES["chothia"]["H1"]
    h2_range = NUMBERING_SCHEMES["chothia"]["H2"]
    h3_range = NUMBERING_SCHEMES["chothia"]["H3"]
    l1_range = NUMBERING_SCHEMES["chothia"]["L1"]
    l2_range = NUMBERING_SCHEMES["chothia"]["L2"]
    l3_range = NUMBERING_SCHEMES["chothia"]["L3"]

    def __init__(
        self,
        parsed: ParsedStructure,
        heavy_chain_id: Optional[str],
        light_chain_id: Optional[str],
        antigen_chain_ids: Optional[List[str]] = None,
        keep_fv_only: bool = False,
    ):
        super().__init__(parsed)
        self.heavy_chain_id = heavy_chain_id
        self.light_chain_id = light_chain_id
        self.antigen_chain_ids = antigen_chain_ids
        self.keep_fv_only = keep_fv_only

    @classmethod
    def read_pdb(
        cls,
        fp,
        heavy_chain_id: Optional[str] = None,
        light_chain_id: Optional[str] = None,
        antigen_chain_ids: Union[str, List[str], None] = None,
        keep_fv_only: bool = False,
    ) -> "ChothiaAntibodyPDB":
        aids = [] if antigen_chain_ids is None else _always_list(antigen_chain_ids)
        chains = [c for c in [heavy_chain_id, light_chain_id] if c] + aids

        ranges = None
        if keep_fv_only:
            ranges = {}
            if heavy_chain_id:
                ranges[heavy_chain_id] = cls.fv_heavy_range
            if light_chain_id:
                ranges[light_chain_id] = cls.fv_light_range

        parsed = parse_pdb(fp, chains=chains or None, residue_range_by_chain=ranges)
        return cls(parsed, heavy_chain_id, light_chain_id, aids or None, keep_fv_only)

    # masks ----------------------------------------------------------------

    def get_heavy_chain_mask(self) -> np.ndarray:
        return self.parsed.chain_id_per_res == self.heavy_chain_id

    def get_light_chain_mask(self) -> np.ndarray:
        return self.parsed.chain_id_per_res == self.light_chain_id

    def get_antigen_mask(self) -> np.ndarray:
        if not self.antigen_chain_ids:
            return np.zeros(self.n_residues, dtype=bool)
        return np.isin(self.parsed.chain_id_per_res, self.antigen_chain_ids)

    def get_fv_mask(self) -> np.ndarray:
        num = self.parsed.residue_number
        h = self.get_heavy_chain_mask() & (num >= self.fv_heavy_range[0]) & (
            num <= self.fv_heavy_range[1]
        )
        l = self.get_light_chain_mask() & (num >= self.fv_light_range[0]) & (
            num <= self.fv_light_range[1]
        )
        return h | l

    def get_cdr_mask(self, subset: Union[str, List[str], None] = None) -> np.ndarray:
        """Union of the selected CDR masks.

        Unlike the reference — whose ``subset=None`` branch is unreachable
        (pdb.py:322-324 after ``_always_list`` crashes on None) — passing
        None selects all six loops.
        """
        subset = list(CDR_NAMES) if subset is None else _always_list(subset)
        subset = [s.upper() for s in subset]

        num = self.parsed.residue_number
        chain_of = {"H": self.get_heavy_chain_mask(), "L": self.get_light_chain_mask()}
        out = np.zeros(self.n_residues, dtype=bool)
        for loop in subset:
            if loop not in CDR_NAMES:
                raise ValueError(f"CDR {loop} is not valid.")
            lo, hi = NUMBERING_SCHEMES["chothia"][loop]
            out |= chain_of[loop[0]] & (num >= lo) & (num <= hi)
        return out

    # substructures --------------------------------------------------------

    def _sub(self, mask: np.ndarray) -> ParsedStructure:
        idx = np.flatnonzero(mask)
        sel = self.parsed
        kept = [c for c in sel.chain_order if c in set(sel.chain_id_per_res[idx])]
        return ParsedStructure(
            atom_xyz=sel.atom_xyz[idx],
            atom_mask=sel.atom_mask[idx],
            chain_idx=sel.chain_idx[idx],
            residue_idx=np.arange(len(idx), dtype=np.int32),
            chain_id_per_res=sel.chain_id_per_res[idx],
            residue_number=sel.residue_number[idx],
            insertion=sel.insertion[idx],
            oneletter=sel.oneletter[idx],
            chain_order=kept,
        )

    def get_heavy_chain_structure(self) -> ParsedStructure:
        return self._sub(self.get_heavy_chain_mask())

    def get_light_chain_structure(self) -> ParsedStructure:
        return self._sub(self.get_light_chain_mask())

    def get_antigen_chains_structure(self) -> Optional[ParsedStructure]:
        if not self.antigen_chain_ids:
            return None
        return self._sub(self.get_antigen_mask())
