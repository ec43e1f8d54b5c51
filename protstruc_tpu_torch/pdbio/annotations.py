"""Author secondary-structure annotations from PDB headers (a copy of
``protstruc_tpu/pdbio/annotations.py``).

``HELIX`` / ``SHEET`` records are curator/author-assigned secondary
structure (PDB format v3.3, sections 5.4-5.5) — an external ground truth
for :mod:`protstruc_tpu_torch.ops.secondary`'s device-side DSSP-style assignment.
The reference library has no annotation reader (its biotite parse drops
header records); this is additive surface.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import List, Union

import numpy as np

__all__ = ["SSRecord", "parse_ss_records", "author_ss_classes"]

# classes aligned with ops/secondary.py
_COIL, _HELIX, _STRAND = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class SSRecord:
    kind: str           # "helix" | "sheet"
    chain_id: str
    start: int          # author residue number (inclusive)
    end: int            # author residue number (inclusive)
    helix_class: int    # PDB helix class (1 = alpha, 5 = 3-10, ...); 0 for sheets


def parse_ss_records(source: Union[str, os.PathLike, _io.IOBase]) -> List[SSRecord]:
    """Read HELIX/SHEET records from a PDB file (header section).

    Column layout per the wwPDB format spec: HELIX initChainID col 20,
    initSeqNum 22-25, endSeqNum 34-37, helixClass 39-40; SHEET initChainID
    col 22, initSeqNum 23-26, endSeqNum 34-37.
    """
    if hasattr(source, "read"):
        text = source.read()
        if isinstance(text, bytes):
            text = text.decode("ascii", "replace")
    else:
        # reuse the parser's byte reader: parse_pdb transparently handles
        # .pdb.gz via gzip sniffing, and the annotations for the same file
        # must not silently diverge by compression
        from protstruc_tpu_torch.pdbio.parser import _read_bytes

        text = _read_bytes(source).decode("ascii", "replace")

    out: List[SSRecord] = []
    for line in text.splitlines():
        if line.startswith("HELIX"):
            try:
                out.append(SSRecord(
                    kind="helix",
                    chain_id=line[19].strip(),
                    start=int(line[21:25]),
                    end=int(line[33:37]),
                    # blank class columns (older/tool-generated files)
                    # default to 1 — int('  ') would otherwise drop the
                    # whole record via the except
                    helix_class=int(line[38:40].strip() or 1),
                ))
            except (ValueError, IndexError):
                continue
        elif line.startswith("SHEET"):
            try:
                out.append(SSRecord(
                    kind="sheet",
                    chain_id=line[21].strip(),
                    start=int(line[22:26]),
                    end=int(line[33:37]),
                    helix_class=0,
                ))
            except (ValueError, IndexError):
                continue
    return out


def author_ss_classes(
    records: List[SSRecord],
    chain_id_per_res: np.ndarray,
    residue_number: np.ndarray,
    alpha_only: bool = False,
) -> np.ndarray:
    """Map annotation records onto per-residue classes ``(L,) int32``.

    Residues not covered by any record are coil (0).  ``alpha_only``
    restricts helix records to PDB class 1 (right-handed alpha) — the class
    the 4-turn DSSP-style assignment detects; 3-10/pi helices stay coil.
    """
    ss = np.zeros(len(residue_number), np.int32)
    for rec in records:
        if rec.kind == "helix" and alpha_only and rec.helix_class != 1:
            continue
        sel = (
            (chain_id_per_res == rec.chain_id)
            & (residue_number >= rec.start)
            & (residue_number <= rec.end)
        )
        ss[sel] = _HELIX if rec.kind == "helix" else _STRAND
    return ss
