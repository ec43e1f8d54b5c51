"""Residue / atom vocabulary for the PyTorch port of protstruc-tpu.

A NumPy-only copy of ``protstruc_tpu/vocab.py``: the port never imports the
JAX package (its ``__init__`` pulls in jax and flax), so the host tables are
carried here verbatim.  Keep the two in step.

This module defines the integer vocabularies that give meaning to the dense
tensor axes used throughout the library:

* ``ATOM`` — backbone atom-slot indices (N/CA/C/O/CB occupy slots 0..4 of the
  per-residue atom axis).
* ``AA`` — the 21-way residue-type vocabulary (20 standard amino acids + UNK).
* ``RESTYPE_HEAVY_ATOMS`` — for every residue type, the ordered names of its
  (up to 15) heavy atoms.  This table *defines* the meaning of the A=15 atom
  axis of ``(B, L, A, 3)`` coordinate tensors.

Behavioral parity: dohlee/protstruc general.py:4-178 (enums, tables) and
alphabet.py (3<->1 letter maps).  The atom-slot
table is the AlphaFold heavy-atom layout; the non-standard-residue
substitution map is the standard OpenMM-derived table.  Both are domain facts
shared by every protein-structure library.

In addition to the reference's Python-level tables, this module precomputes
NumPy integer lookup arrays (``HEAVY_ATOM_SLOT``, ``RESTYPE_ATOM_EXISTS``)
used by the host-side PDB ingest path and by device-side featurization, so no
per-atom Python string matching happens in hot loops.
"""

from __future__ import annotations

import enum
from typing import Dict, List

import numpy as np

__all__ = [
    "ATOM",
    "AA",
    "MAX_ATOMS_PER_RESIDUE",
    "CDR_NAMES",
    "RESTYPE_HEAVY_ATOMS",
    "restype_to_heavyatom_names",
    "standard_aa_names",
    "standard_heavy_atom_names",
    "non_standard_residue_substitutions",
    "ressymb_to_resindex",
    "resindex_to_oneletter",
    "three2one",
    "one2three",
    "HEAVY_ATOM_SLOT",
    "RESTYPE_ATOM_EXISTS",
    "atom_slot_of",
]

#: Number of heavy-atom slots on the per-residue atom axis.
#: cf. dohlee/protstruc constants/__init__.py:1
MAX_ATOMS_PER_RESIDUE = 15

#: Antibody CDR loop names (cf. general.py:178).
CDR_NAMES = ("H1", "H2", "H3", "L1", "L2", "L3")


class ATOM(enum.IntEnum):
    """Backbone atom-slot indices into the atom axis.

    Slots 0..4 are N, CA, C, O, CB for every residue type (see
    ``RESTYPE_HEAVY_ATOMS``).  Lower/mixed-case aliases are accepted like the
    reference enum (general.py:4-23).
    """

    N = 0
    n = 0
    CA = 1
    Ca = 1
    ca = 1
    C = 2
    c = 2
    O = 3  # noqa: E741
    o = 3
    CB = 4
    Cb = 4
    cb = 4

    @classmethod
    def is_valid(cls, name: str) -> bool:
        return name.upper() in cls.__members__

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


# One-letter symbol -> residue index (general.py:126-132).
ressymb_to_resindex: Dict[str, int] = {
    "A": 0, "C": 1, "D": 2, "E": 3, "F": 4,
    "G": 5, "H": 6, "I": 7, "K": 8, "L": 9,
    "M": 10, "N": 11, "P": 12, "Q": 13, "R": 14,
    "S": 15, "T": 16, "V": 17, "W": 18, "Y": 19,
    "X": 20,
}
resindex_to_oneletter: Dict[int, str] = {v: k for k, v in ressymb_to_resindex.items()}

# Modified/non-standard residue -> canonical residue (OpenMM-derived table;
# general.py:109-124).  Pure data: required for parsing real PDB files.
non_standard_residue_substitutions: Dict[str, str] = {
    "2AS": "ASP", "3AH": "HIS", "5HP": "GLU", "ACL": "ARG", "AGM": "ARG",
    "AIB": "ALA", "ALM": "ALA", "ALO": "THR", "ALY": "LYS", "ARM": "ARG",
    "ASA": "ASP", "ASB": "ASP", "ASK": "ASP", "ASL": "ASP", "ASQ": "ASP",
    "AYA": "ALA", "BCS": "CYS", "BHD": "ASP", "BMT": "THR", "BNN": "ALA",
    "BUC": "CYS", "BUG": "LEU", "C5C": "CYS", "C6C": "CYS", "CAS": "CYS",
    "CCS": "CYS", "CEA": "CYS", "CGU": "GLU", "CHG": "ALA", "CLE": "LEU",
    "CME": "CYS", "CSD": "ALA", "CSO": "CYS", "CSP": "CYS", "CSS": "CYS",
    "CSW": "CYS", "CSX": "CYS", "CXM": "MET", "CY1": "CYS", "CY3": "CYS",
    "CYG": "CYS", "CYM": "CYS", "CYQ": "CYS", "DAH": "PHE", "DAL": "ALA",
    "DAR": "ARG", "DAS": "ASP", "DCY": "CYS", "DGL": "GLU", "DGN": "GLN",
    "DHA": "ALA", "DHI": "HIS", "DIL": "ILE", "DIV": "VAL", "DLE": "LEU",
    "DLY": "LYS", "DNP": "ALA", "DPN": "PHE", "DPR": "PRO", "DSN": "SER",
    "DSP": "ASP", "DTH": "THR", "DTR": "TRP", "DTY": "TYR", "DVA": "VAL",
    "EFC": "CYS", "FLA": "ALA", "FME": "MET", "GGL": "GLU", "GL3": "GLY",
    "GLZ": "GLY", "GMA": "GLU", "GSC": "GLY", "HAC": "ALA", "HAR": "ARG",
    "HIC": "HIS", "HIP": "HIS", "HMR": "ARG", "HPQ": "PHE", "HTR": "TRP",
    "HYP": "PRO", "IAS": "ASP", "IIL": "ILE", "IYR": "TYR", "KCX": "LYS",
    "LLP": "LYS", "LLY": "LYS", "LTR": "TRP", "LYM": "LYS", "LYZ": "LYS",
    "MAA": "ALA", "MEN": "ASN", "MHS": "HIS", "MIS": "SER", "MLE": "LEU",
    "MPQ": "GLY", "MSA": "GLY", "MSE": "MET", "MVA": "VAL", "NEM": "HIS",
    "NEP": "HIS", "NLE": "LEU", "NLN": "LEU", "NLP": "LEU", "NMC": "GLY",
    "OAS": "SER", "OCS": "CYS", "OMT": "MET", "PAQ": "TYR", "PCA": "GLU",
    "PEC": "CYS", "PHI": "PHE", "PHL": "PHE", "PR3": "CYS", "PRR": "ALA",
    "PTR": "TYR", "PYX": "CYS", "SAC": "SER", "SAR": "GLY", "SCH": "CYS",
    "SCS": "CYS", "SCY": "CYS", "SEL": "SER", "SEP": "SER", "SET": "SER",
    "SHC": "CYS", "SHR": "LYS", "SMC": "CYS", "SOC": "CYS", "STY": "TYR",
    "SVA": "SER", "TIH": "ALA", "TPL": "TRP", "TPO": "THR", "TPQ": "ALA",
    "TRG": "LYS", "TRO": "TRP", "TYB": "TYR", "TYI": "TYR", "TYQ": "TYR",
    "TYS": "TYR", "TYY": "TYR",
}


class AA(enum.IntEnum):
    """21-way residue-type vocabulary (general.py:26-75).

    Construction accepts the integer index, a 3-letter code (with
    non-standard-residue substitution applied) or a 1-letter code:
    ``AA("MSE") is AA.MET``, ``AA("K") is AA.LYS``.
    """

    ALA = 0
    CYS = 1
    ASP = 2
    GLU = 3
    PHE = 4
    GLY = 5
    HIS = 6
    ILE = 7
    LYS = 8
    LEU = 9
    MET = 10
    ASN = 11
    PRO = 12
    GLN = 13
    ARG = 14
    SER = 15
    THR = 16
    VAL = 17
    TRP = 18
    TYR = 19
    UNK = 20

    @classmethod
    def _missing_(cls, value):
        if isinstance(value, str):
            if len(value) == 3:
                canon = non_standard_residue_substitutions.get(value, value)
                if canon in cls.__members__:
                    return cls.__members__[canon]
            elif len(value) == 1 and value in ressymb_to_resindex:
                return cls(ressymb_to_resindex[value])
        return super()._missing_(value)

    def oneletter(self) -> str:
        return resindex_to_oneletter[int(self)]

    @classmethod
    def is_aa(cls, value) -> bool:
        return (
            value in ressymb_to_resindex
            or value in non_standard_residue_substitutions
            or value in cls.__members__
            or isinstance(value, cls)
        )

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name


standard_aa_names: List[str] = [AA(i).name for i in range(20)]

# 3-letter <-> 1-letter maps (alphabet.py:1-24).
three2one: Dict[str, str] = {AA(i).name: AA(i).oneletter() for i in range(20)}
one2three: Dict[str, str] = {v: k for k, v in three2one.items()}


def _pad15(names: List[str]) -> List[str]:
    assert len(names) <= MAX_ATOMS_PER_RESIDUE
    return names + [""] * (MAX_ATOMS_PER_RESIDUE - len(names))


# Heavy-atom slot layout per residue type (AlphaFold layout; general.py:149-171).
# Slot 0-3 = N/CA/C/O, slot 4 = CB, middle slots = sidechain, slot 14 = OXT.
_SIDECHAIN: Dict[str, List[str]] = {
    "ALA": [],
    "ARG": ["CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "ASN": ["CG", "OD1", "ND2"],
    "ASP": ["CG", "OD1", "OD2"],
    "CYS": ["SG"],
    "GLN": ["CG", "CD", "OE1", "NE2"],
    "GLU": ["CG", "CD", "OE1", "OE2"],
    "GLY": [],
    "HIS": ["CG", "ND1", "CD2", "CE1", "NE2"],
    "ILE": ["CG1", "CG2", "CD1"],
    "LEU": ["CG", "CD1", "CD2"],
    "LYS": ["CG", "CD", "CE", "NZ"],
    "MET": ["CG", "SD", "CE"],
    "PHE": ["CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "PRO": ["CG", "CD"],
    "SER": ["OG"],
    "THR": ["OG1", "CG2"],
    "TRP": ["CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"],
    "TYR": ["CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"],
    "VAL": ["CG1", "CG2"],
}

RESTYPE_HEAVY_ATOMS: Dict[AA, List[str]] = {}
for _name, _side in _SIDECHAIN.items():
    _aa = AA.__members__[_name]
    if _name == "GLY":
        _atoms = ["N", "CA", "C", "O"] + [""] * 10 + ["OXT"]
    else:
        _atoms = _pad15(["N", "CA", "C", "O", "CB"] + _side)
        _atoms[14] = "OXT"
    RESTYPE_HEAVY_ATOMS[_aa] = _atoms
RESTYPE_HEAVY_ATOMS[AA.UNK] = [""] * MAX_ATOMS_PER_RESIDUE

#: Alias with the reference's name for drop-in compatibility.
restype_to_heavyatom_names = RESTYPE_HEAVY_ATOMS

standard_heavy_atom_names: List[str] = sorted(
    {a for atoms in RESTYPE_HEAVY_ATOMS.values() for a in atoms if a}
)

# ---------------------------------------------------------------------------
# Precomputed integer lookups (new in the TPU rebuild; the reference does
# per-atom Python `list.index` calls in its ingest loop, pdb.py:148).
# ---------------------------------------------------------------------------

#: (restype, atom_name) -> slot index, or -1 if the atom does not belong.
HEAVY_ATOM_SLOT: Dict[str, Dict[str, int]] = {
    aa.name: {a: i for i, a in enumerate(atoms) if a}
    for aa, atoms in RESTYPE_HEAVY_ATOMS.items()
}

#: bool[21, 15] — which slots exist for each residue type.
RESTYPE_ATOM_EXISTS = np.zeros((21, MAX_ATOMS_PER_RESIDUE), dtype=bool)
for _aa, _atoms in RESTYPE_HEAVY_ATOMS.items():
    for _i, _a in enumerate(_atoms):
        RESTYPE_ATOM_EXISTS[int(_aa), _i] = bool(_a)


def atom_slot_of(res_name: str, atom_name: str) -> int:
    """Slot index of ``atom_name`` within residue type ``res_name`` (or -1)."""
    canon = non_standard_residue_substitutions.get(res_name, res_name)
    table = HEAVY_ATOM_SLOT.get(canon)
    if table is None:
        return -1
    return table.get(atom_name, -1)
