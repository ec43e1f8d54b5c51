"""Fixed-column PDB parser with reference-equivalent tidy semantics.

A NumPy-only copy of ``protstruc_tpu/pdbio/parser.py`` with the NumPy atom
scanner only (the C++ scanner is not ported yet, so there is no
``use_native`` switch).  Keep the two in step.

Pipeline parity with the reference's biotite-based layer
(dohlee/protstruc pdb.py):

1. Model 1 only (pdb.py:66); ATOM and HETATM records.
2. Per-residue first-altloc filtering (biotite ``altloc="first"`` default).
3. Tidy (pdb.py:24-40): substitute non-standard residue names to canonical,
   drop non-canonical residues (waters/ligands/nucleotides), drop atoms whose
   names are not standard heavy atoms (hydrogens, exotic atoms).
4. Residue walk in file order keyed by (chain_id, residue_number, insertion),
   filling numbering gaps *within* a chain with atom-less UNK dummies
   (pdb.py:102-111); ``chain_idx`` = first-appearance categorical codes
   (pdb.py:123-125).
5. Coordinates scattered to the AlphaFold 15-slot atom axis; missing atoms
   are NaN with mask False (pdb.py:132-151).  Unlike the reference — which
   crashes via ``list.index`` on an atom name foreign to its residue type —
   such atoms are skipped (robustness divergence, documented).

The hot atom-record scan is vectorized with NumPy on the raw byte buffer
(the reference does O(atoms) Python iterations, pdb.py:140-151).
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import Dict, List, Sequence, Union

import numpy as np

from protstruc_tpu_torch.constants import MAX_N_ATOMS_PER_RESIDUE
from protstruc_tpu_torch.vocab import (
    AA,
    HEAVY_ATOM_SLOT,
    non_standard_residue_substitutions,
    standard_aa_names,
    standard_heavy_atom_names,
)

__all__ = ["ParsedStructure", "parse_pdb", "parse_pdb_files"]

_STANDARD_ATOMS = frozenset(standard_heavy_atom_names)
_CANONICAL = frozenset(standard_aa_names)
_STANDARD_ATOM_ARR = np.sort(np.array(sorted(_STANDARD_ATOMS), dtype="S4"))
_CANONICAL_ARR = np.sort(np.array(sorted(_CANONICAL), dtype="S3"))

# vectorized (res_name, atom_name) -> slot lookup via sorted-key searchsorted
# (byte-string keys: the whole atom-level pipeline runs on S dtype)
_SLOT_KEYS, _SLOT_VALS = (lambda items: (
    np.array([k for k, _ in items], dtype="S8"),
    np.array([v for _, v in items], np.int64),
))(sorted(
    (f"{res}|{atom}".encode(), slot)
    for res, table in HEAVY_ATOM_SLOT.items()
    for atom, slot in table.items()
))


def _lookup_slots(res_name: np.ndarray, atom_name: np.ndarray) -> np.ndarray:
    """Slot index per atom record, -1 where the atom is foreign to its residue."""
    query = np.char.add(np.char.add(res_name.astype("S3"), b"|"), atom_name)
    idx = np.searchsorted(_SLOT_KEYS, query.astype("S8"))
    idx = np.clip(idx, 0, len(_SLOT_KEYS) - 1)
    ok = _SLOT_KEYS[idx] == query
    return np.where(ok, _SLOT_VALS[idx], -1)


@dataclasses.dataclass
class ParsedStructure:
    """One tidied structure in dense per-residue form (host-side, ragged L)."""

    atom_xyz: np.ndarray        # (L, 15, 3) float32; NaN where atom absent
    atom_mask: np.ndarray       # (L, 15) bool
    chain_idx: np.ndarray       # (L,) int32 first-appearance chain codes
    residue_idx: np.ndarray     # (L,) int32 internal index 0..L-1
    chain_id_per_res: np.ndarray  # (L,) unicode chain identifiers
    residue_number: np.ndarray  # (L,) int32 author residue numbers
    insertion: np.ndarray       # (L,) unicode insertion codes
    oneletter: np.ndarray       # (L,) unicode one-letter residue codes
    chain_order: List[str]      # unique chain ids in first-appearance order

    @property
    def n_residues(self) -> int:
        return len(self.chain_idx)

    def get_seq(self) -> str:
        """Full one-letter sequence incl. UNK gap dummies as 'X' (pdb.py:169-170)."""
        return "".join(self.oneletter)

    def seq_dict(self) -> Dict[str, str]:
        """Per-chain one-letter sequences in chain order (pdb.py:172-179)."""
        out = {}
        for cid in self.chain_order:
            sel = self.chain_id_per_res == cid
            out[cid] = "".join(self.oneletter[sel])
        return out


def _read_bytes(source: Union[str, os.PathLike, _io.IOBase]) -> bytes:
    if hasattr(source, "read"):
        data = source.read()
        if isinstance(data, str):
            data = data.encode()
    else:
        with open(source, "rb") as f:
            data = f.read()
    if data[:2] == b"\x1f\x8b":  # gzipped archive entry (.pdb.gz / .cif.gz)
        import gzip

        data = gzip.decompress(data)
    return data


def _read_model1_lines(data: bytes) -> List[bytes]:
    """Return the raw lines of the first model's coordinate section."""
    lines = data.splitlines()
    out = []
    in_model = 0  # 0 = before any MODEL record; N = inside model N
    for ln in lines:
        rec = ln[:6]
        if rec.startswith(b"MODEL"):
            in_model += 1
            if in_model > 1:
                break
            continue
        if rec.startswith(b"ENDMDL"):
            break
        if rec == b"ATOM  " or rec == b"HETATM":
            out.append(ln)
    return out


def _parse_atom_records(lines: List[bytes]):
    """Vectorized fixed-column field extraction from ATOM/HETATM lines.

    Returns dict of numpy arrays: atom_name, altloc, res_name, chain_id,
    res_num, icode, xyz.
    """
    n = len(lines)
    if n == 0:
        raise ValueError("no ATOM/HETATM records found")

    # Pad lines to 80 columns and view as a (n, 80) byte matrix.
    buf = np.zeros((n, 80), dtype=np.uint8)
    for i, ln in enumerate(lines):
        b = ln[:80]
        buf[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)

    chars = buf.view("S1")

    # byte-string (S) columns — no per-atom unicode conversion (unicode
    # happens once per residue in _build_structure)
    def col_str(a, b):
        return chars[:, a:b].view(f"S{b - a}").reshape(n)

    atom_name = np.char.strip(col_str(12, 16))
    altloc = col_str(16, 17)
    res_name = np.char.strip(col_str(17, 20))
    chain_id = np.char.strip(col_str(21, 22))
    icode = np.char.strip(col_str(26, 27))

    res_num_i = np.char.strip(col_str(22, 26)).astype(np.int32)

    xyz = np.stack(
        [
            col_str(30, 38).astype(np.float32),
            col_str(38, 46).astype(np.float32),
            col_str(46, 54).astype(np.float32),
        ],
        axis=1,
    )

    return {
        "atom_name": atom_name,
        "altloc": altloc,
        "res_name": res_name,
        "chain_id": chain_id,
        "res_num": res_num_i,
        "icode": icode,
        "xyz": xyz,
    }


def _tidy(rec):
    """Substitute non-standard residues, keep canonical AAs + standard atoms.

    All lookups run at unique-value level (a structure has ~20-160 distinct
    residue/atom names vs 10^4-10^5 atoms), so this is O(atoms) numpy
    indexing, not O(atoms) Python dict calls.
    """
    uniq_res, inv_res = np.unique(rec["res_name"], return_inverse=True)
    subst_uniq = np.array(
        [
            non_standard_residue_substitutions.get(r.decode(), r.decode())
            for r in uniq_res
        ],
        dtype="S3",
    )
    res_ok = np.isin(subst_uniq, _CANONICAL_ARR)[inv_res]

    uniq_atom, inv_atom = np.unique(rec["atom_name"], return_inverse=True)
    atom_ok = np.isin(uniq_atom, _STANDARD_ATOM_ARR)[inv_atom]

    keep = res_ok & atom_ok
    out = {k: v[keep] for k, v in rec.items()}
    out["res_name"] = subst_uniq[inv_res][keep]
    return out


def _filter_first_altloc(rec):
    """Per residue, keep blank-altloc atoms plus the first altloc id seen."""
    altloc = rec["altloc"]
    if not np.any((altloc != b" ") & (altloc != b"")):
        return rec

    res_key = np.stack(
        [rec["chain_id"].astype("S8"), rec["res_num"].astype("S8"),
         rec["icode"].astype("S8")], axis=1,
    )
    keep = np.ones(len(altloc), dtype=bool)
    first_by_res: Dict[tuple, bytes] = {}
    for i, al in enumerate(altloc):
        if al in (b" ", b""):
            continue
        key = tuple(res_key[i])
        chosen = first_by_res.setdefault(key, al)
        keep[i] = al == chosen
    return {k: v[keep] for k, v in rec.items()}


def parse_pdb(
    source: Union[str, os.PathLike, _io.IOBase],
    chains: Sequence[str] = None,
    residue_range_by_chain: Dict[str, tuple] = None,
) -> ParsedStructure:
    """Parse one PDB file/handle into a :class:`ParsedStructure`.

    Args:
        chains: optional whitelist of chain ids to retain (applied before the
            residue walk, like ChothiaAntibodyPDB._retain_only_relevant_chains,
            pdb.py:233-240).
        residue_range_by_chain: optional ``{chain_id: (lo, hi)}`` inclusive
            author-numbering filter; chains listed in ``chains`` but absent
            here are kept whole (Fv-region filtering, pdb.py:242-259).
    """
    data = _read_bytes(source)

    from protstruc_tpu_torch.pdbio.cif import looks_like_cif, parse_atom_records_cif

    if looks_like_cif(data):
        rec = parse_atom_records_cif(data)
        # normalize to the byte-string dtype regime of the PDB scanner
        for k in ("atom_name", "altloc", "res_name", "chain_id", "icode"):
            rec[k] = np.char.encode(rec[k], "ascii")
    else:
        rec = _parse_atom_records(_read_model1_lines(data))

    rec = _filter_first_altloc(rec)
    rec = _tidy(rec)

    if chains is not None:
        keep = np.isin(rec["chain_id"], [str(c).encode() for c in chains])
        rec = {k: v[keep] for k, v in rec.items()}
    if residue_range_by_chain:
        keep = np.ones(len(rec["chain_id"]), dtype=bool)
        for cid, (lo, hi) in residue_range_by_chain.items():
            on_chain = rec["chain_id"] == str(cid).encode()
            keep &= ~on_chain | ((rec["res_num"] >= lo) & (rec["res_num"] <= hi))
        rec = {k: v[keep] for k, v in rec.items()}

    return _build_structure(rec)


def _build_structure(rec) -> ParsedStructure:
    chain_id = rec["chain_id"]
    res_num = rec["res_num"]
    icode = rec["icode"]
    res_name = rec["res_name"]
    atom_name = rec["atom_name"]
    xyz = rec["xyz"]
    n_atoms = len(chain_id)

    # group boundaries: a new residue whenever (chain, resnum, icode) changes
    if n_atoms == 0:
        raise ValueError("structure contains no standard residues")
    change = np.ones(n_atoms, dtype=bool)
    change[1:] = (
        (chain_id[1:] != chain_id[:-1])
        | (res_num[1:] != res_num[:-1])
        | (icode[1:] != icode[:-1])
    )
    group_starts = np.flatnonzero(change)

    # Residue walk with intra-chain gap filling (pdb.py:82-120), fully
    # vectorized: gap counts via a shifted compare, row offsets via prefix
    # sums, filled UNK rows constructed with repeat/arange arithmetic.
    G = len(group_starts)
    # unicode conversion happens here, at residue level (G rows, not atoms)
    cid_g = chain_id[group_starts].astype("U4")
    num_g = res_num[group_starts].astype(np.int64)
    ic_g = icode[group_starts].astype("U1")

    # one-letter codes at unique-residue-name level (<= 21 uniques)
    uniq_res, inv_res = np.unique(res_name[group_starts], return_inverse=True)
    one_uniq = np.array([AA(r.decode()).oneletter() for r in uniq_res])
    one_g = one_uniq[inv_res]

    # UNK dummies inserted before group g for forward numbering jumps
    # within a chain (never at a chain start / backward jump / icode twin)
    gap = np.zeros(G, dtype=np.int64)
    same_chain = cid_g[1:] == cid_g[:-1]
    gap[1:] = np.where(same_chain, np.maximum(num_g[1:] - num_g[:-1] - 1, 0), 0)

    rows_before = np.concatenate([[0], np.cumsum(1 + gap)[:-1]])
    group_internal_idx = rows_before + gap
    L = int(rows_before[-1] + gap[-1] + 1) if G else 0

    chain_arr = np.empty(L, dtype=cid_g.dtype)
    res_number = np.empty(L, dtype=np.int64)
    res_icode = np.empty(L, dtype=ic_g.dtype)
    res_one = np.full(L, "X", dtype=one_g.dtype)
    chain_arr[group_internal_idx] = cid_g
    res_number[group_internal_idx] = num_g
    res_icode[group_internal_idx] = ic_g
    res_one[group_internal_idx] = one_g

    filled = gap > 0
    if filled.any():
        reps = gap[filled]
        # per-fill-row offset 0..reps_g-1 within its group's gap run
        local = np.arange(reps.sum()) - np.repeat(
            np.concatenate([[0], np.cumsum(reps)[:-1]]), reps
        )
        fill_pos = np.repeat(rows_before[filled], reps) + local
        chain_arr[fill_pos] = np.repeat(cid_g[filled], reps)
        # numbering continues from the previous group's author number
        prev_num = np.empty(G, dtype=np.int64)
        prev_num[1:] = num_g[:-1]
        res_number[fill_pos] = np.repeat(prev_num[filled] + 1, reps) + local
        res_icode[fill_pos] = np.repeat(ic_g[filled], reps)

    # first-appearance chain codes (pdb.py:123-125)
    uniq_c, first_idx, inv_c = np.unique(
        chain_arr, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx)
    rank = np.empty(len(uniq_c), dtype=np.int32)
    rank[order] = np.arange(len(uniq_c), dtype=np.int32)
    chain_idx = rank[inv_c]
    chain_order = [str(c) for c in uniq_c[order]]

    # per-atom (residue internal index, slot) then vectorized scatter
    group_of_atom = np.cumsum(change) - 1
    res_internal = group_internal_idx[group_of_atom]

    slots = _lookup_slots(res_name, atom_name)
    ok = slots >= 0

    atom_xyz = np.full((L, MAX_N_ATOMS_PER_RESIDUE, 3), np.nan, dtype=np.float32)
    atom_mask = np.zeros((L, MAX_N_ATOMS_PER_RESIDUE), dtype=bool)
    atom_xyz[res_internal[ok], slots[ok]] = xyz[ok]
    atom_mask[res_internal[ok], slots[ok]] = True

    return ParsedStructure(
        atom_xyz=atom_xyz,
        atom_mask=atom_mask,
        chain_idx=chain_idx,
        residue_idx=np.arange(L, dtype=np.int32),
        chain_id_per_res=chain_arr,
        residue_number=np.array(res_number, dtype=np.int32),
        insertion=np.array(res_icode),
        oneletter=np.array(res_one),
        chain_order=chain_order,
    )


def parse_pdb_files(paths: Sequence[Union[str, os.PathLike]]) -> List[ParsedStructure]:
    """Parse several PDB files (the from_pdb ingest hot loop)."""
    return [parse_pdb(p) for p in paths]
