"""Minimal mmCIF (PDBx) atom_site parser.

A verbatim copy of ``protstruc_tpu/pdbio/cif.py`` (the port never imports
the JAX package).

New capability beyond the reference (which reads legacy PDB only via
biotite): parses the ``_atom_site`` loop of mmCIF files into the same field
dict as the PDB scanners, so the whole downstream pipeline (tidy, residue
walk, slot scatter, batching) is shared.  Handles the constructs that occur
in real PDBx files: column order from the loop header, '.'/'?' null tokens,
quoted tokens, multi-model files (first model only).
"""

from __future__ import annotations

import shlex
from typing import Dict, List

import numpy as np

__all__ = ["parse_atom_records_cif", "looks_like_cif"]


def looks_like_cif(data: bytes) -> bool:
    head = data[:4096].lstrip()
    return head.startswith(b"data_") or b"_atom_site." in data[:65536]


def _split_tokens(line: str) -> List[str]:
    if "'" in line or '"' in line:
        try:
            return shlex.split(line)
        except ValueError:
            # unbalanced quote (truncated/hand-edited row): fall back to
            # whitespace split rather than aborting the whole parse — the
            # row is then judged by the same too-few-tokens skip as any
            # other malformed body row
            return line.split()
    return line.split()


def parse_atom_records_cif(data: bytes) -> Dict[str, np.ndarray]:
    """Parse mmCIF bytes -> field-array dict (same keys as the PDB scanner)."""
    text = data.decode("utf-8", errors="replace")
    lines = text.splitlines()

    # locate the _atom_site loop header
    header: List[str] = []
    body_start = None
    i = 0
    while i < len(lines):
        if lines[i].strip() == "loop_":
            j = i + 1
            cols = []
            while j < len(lines) and lines[j].strip().startswith("_"):
                cols.append(lines[j].strip().split(".", 1))
                j += 1
            if cols and cols[0][0] == "_atom_site":
                # malformed header entries without a '.' contribute no column
                header = [c[1].strip() if len(c) > 1 else "" for c in cols]
                body_start = j
                break
            i = j
        else:
            i += 1
    if body_start is None:
        raise ValueError("no _atom_site loop found in mmCIF input")

    idx = {name: k for k, name in enumerate(header)}

    def col(name, default=None):
        return idx.get(name, default)

    need = ["label_atom_id", "Cartn_x", "Cartn_y", "Cartn_z"]
    for n in need:
        if n not in idx:
            raise ValueError(f"mmCIF _atom_site loop missing {n}")

    c_group = col("group_PDB")
    c_atom = idx["label_atom_id"]
    c_alt = col("label_alt_id")
    c_res = col("auth_comp_id", col("label_comp_id"))
    c_chain = col("auth_asym_id", col("label_asym_id"))
    c_num = col("auth_seq_id", col("label_seq_id"))
    c_ins = col("pdbx_PDB_ins_code")
    c_model = col("pdbx_PDB_model_num")

    atom_name, altloc, res_name, chain_id, res_num, icode = [], [], [], [], [], []
    xyz = []
    first_model = None

    for ln in lines[body_start:]:
        s = ln.strip()
        if not s:
            continue
        if s.startswith(("#", "loop_", "_", "data_")):
            break
        t = _split_tokens(s)
        if len(t) < len(header):
            continue
        if c_group is not None and t[c_group] not in ("ATOM", "HETATM"):
            continue
        if c_model is not None:
            if first_model is None:
                first_model = t[c_model]
            elif t[c_model] != first_model:
                break  # only the first model

        def clean(v, blank=""):
            return blank if v in (".", "?") else v

        atom_name.append(t[c_atom].strip('"'))
        altloc.append(clean(t[c_alt]) if c_alt is not None else "")
        res_name.append(t[c_res] if c_res is not None else "UNK")
        chain_id.append(clean(t[c_chain]) if c_chain is not None else "A")
        num = clean(t[c_num], "0") if c_num is not None else "0"
        res_num.append(int(num) if num not in ("",) else 0)
        icode.append(clean(t[c_ins]) if c_ins is not None else "")
        def coord(v):
            # mmCIF encodes unknown values as '.'/'?' in any column: a
            # null coordinate is a missing atom -> NaN (the load-bearing
            # missing-atom convention), not a parse abort
            return float("nan") if v in (".", "?") else float(v)

        xyz.append(
            (coord(t[idx["Cartn_x"]]), coord(t[idx["Cartn_y"]]),
             coord(t[idx["Cartn_z"]]))
        )

    if not atom_name:
        raise ValueError("no ATOM/HETATM records found")

    return {
        "atom_name": np.array(atom_name),
        "altloc": np.array([a if a else " " for a in altloc]),
        "res_name": np.array(res_name),
        "chain_id": np.array(chain_id),
        "res_num": np.array(res_num, dtype=np.int32),
        "icode": np.array(icode),
        "xyz": np.array(xyz, dtype=np.float32),
    }
