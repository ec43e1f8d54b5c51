"""Antibody numbering-scheme conversion (chothia / kabat / imgt).

A NumPy-only copy of ``protstruc_tpu/numbering.py`` (the port never imports
the JAX package); :func:`renumber_pdb` reads with the port's
``pdbio/parser.parse_pdb``.  Keep the two in step.

Rule-based, table-driven conversion of author residue numbers between the
three schemes, so a Chothia-numbered file (the SAbDab convention) can be
ingested with ``numbering_scheme="imgt"`` and get correct IMGT CDR masks.

Design
------
A variable domain is segmented into eight structural stretches delimited
by landmarks that every scheme agrees on (the two domain cysteines, the
FR2 tryptophan, the FR4 W/F-G-x-G motif, and the CDR boundaries).  Each
segment carries its author-number span in Kabat/Chothia coordinates
(identical at integer level — the two schemes differ only in which
position carries insertion *letters*: H1 31 vs 35, L1 30 vs 27) and in
IMGT coordinates, plus a fill rule:

* ``start`` — number sequentially from the segment start (anchors the
  left landmark, e.g. FR2's conserved Trp: Kabat H36 <-> IMGT 41).
* ``end`` — number backward from the segment end (anchors the right
  landmark, e.g. the second Cys: Kabat H92 <-> IMGT 104).
* ``fr1`` — first (up to) 9 residues from the start, remainder
  end-anchored: reproduces IMGT's canonical FR1 gap placement (position
  10) for template-length frameworks while keeping the Cys anchored.
* ``loop`` — CDR fill: front half ascending from the start, back half
  descending from the end, gaps (or integer-duplicate "insertions") in
  the middle — the IMGT CDR convention.
* ``cdr1`` — the CDR1 stretch whose *last two* residues are the IMGT
  FR2 shoulder (IMGT 39-40, e.g. Kabat H34-35): they take the top two
  target positions, the remainder loop-fills.

Segment membership is decided by the residue's *source* number; order
within a segment is file order, so insertion-coded residues (stored as
duplicated integers by the parser) convert correctly.  Residues outside
every segment (constant domains, antigens) keep their numbers.

Contract: the input must be correctly numbered in the source scheme.
Loop-length variation is handled exactly; framework indels follow the
template fills (CDR masks stay exact; framework numbers may then differ
from an HMM-based renumberer like ANARCI by a gap position).  Conversion
targets the scheme's integer numbering; insertion letters are not
emitted (the parser tracks integers, which is what every mask consumes).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["convert_chain_numbering", "detect_numbering_scheme",
           "detect_numbering_scheme_strict", "scheme_anchor_scores",
           "renumber_pdb", "SCHEME_ANCHOR_CYS"]


# (name, kabat/chothia integer span, imgt integer span, fill rule,
#  Chothia insertion anchor in kc coordinates — where overflow residues
#  take duplicate integers when converting INTO kabat/chothia, matching
#  the SAbDab convention (31/52/82/100 heavy, 30/95 light); None = no
#  canonical anchor (overflow falls back to the rule's own placement))
_HEAVY_SEGMENTS = [
    ("fr1a", (1, 22),    (1, 23),    "fr1",   None),  # ends at Cys 22 <-> 23
    ("fr1b", (23, 25),   (24, 26),   "start", None),
    ("cdr1", (26, 35),   (27, 40),   "cdr1",  31),    # last 2 -> IMGT 39-40
    ("fr2",  (36, 50),   (41, 55),   "start", None),  # Trp 36 <-> 41
    ("cdr2", (51, 58),   (56, 65),   "loop",  52),
    ("fr3",  (59, 92),   (66, 104),  "end",   82),    # ends at Cys 92 <-> 104
    ("cdr3", (93, 102),  (105, 117), "loop",  100),   # IMGT CDR3 incl. K93-94
    ("fr4",  (103, 113), (118, 128), "start", None),  # Trp 103 <-> 118
]

_LIGHT_SEGMENTS = [
    ("fr1a", (1, 23),   (1, 23),    "fr1",   None),  # ends at Cys 23 <-> 23
    ("fr1b", (24, 26),  (24, 26),   "start", None),  # Kabat L1 head = IMGT FR1
    ("cdr1", (27, 34),  (27, 40),   "cdr1",  30),    # last 2 -> IMGT 39-40
    ("fr2",  (35, 49),  (41, 55),   "start", None),  # Trp 35 <-> 41
    ("cdr2", (50, 52),  (56, 65),   "loop",  52),    # IMGT CDR-L2 is 3 residues
    ("fr3",  (53, 88),  (66, 104),  "end",   None),  # ends at Cys 88 <-> 104
    ("cdr3", (89, 97),  (105, 117), "loop",  95),
    ("fr4",  (98, 109), (118, 128), "start", None),  # Phe/Trp 98 <-> 118
]

_SEGMENTS = {"heavy": _HEAVY_SEGMENTS, "light": _LIGHT_SEGMENTS}

#: conserved domain-cysteine positions per scheme (chain type -> positions);
#: chothia and kabat share integer positions.
SCHEME_ANCHOR_CYS: Dict[str, Dict[str, Tuple[int, int]]] = {
    "chothia": {"heavy": (22, 92), "light": (23, 88)},
    "kabat": {"heavy": (22, 92), "light": (23, 88)},
    "imgt": {"heavy": (23, 104), "light": (23, 104)},
}


def _span(segment, scheme: str) -> Tuple[int, int]:
    _, kc, imgt, _, _ = segment
    return imgt if scheme == "imgt" else kc


def _fill(n: int, lo: int, hi: int, rule: str, anchor: int = None) -> List[int]:
    """Assign ``n`` residues (in order) integer numbers within [lo, hi].

    ``anchor``: canonical insertion position — when the segment overflows
    (n > m) the extra residues take duplicate integers there (the
    kabat/chothia convention, e.g. heavy FR3 82A-C) instead of the rule's
    default placement.
    """
    m = hi - lo + 1
    if n == 0:
        return []
    if n > m and anchor is not None:
        head = anchor - lo + 1
        return ([lo + i for i in range(head)] + [anchor] * (n - m)
                + [anchor + 1 + i for i in range(hi - anchor)])
    if rule == "start":
        return [lo + min(i, m - 1) for i in range(n)]
    if rule == "end":
        return [hi - min(n - 1 - i, m - 1) for i in range(n)]
    if rule == "fr1":
        front = min(n, 9, m)
        out = [lo + i for i in range(front)]
        out += _fill(n - front, lo + front, hi, "end")
        return out
    if rule == "loop":
        if n >= m:
            front, back = (m + 1) // 2, m // 2
            mid = [lo + front - 1] * (n - m)  # integer-duplicate insertions
            return ([lo + i for i in range(front)] + mid
                    + [hi - back + 1 + i for i in range(back)])
        front, back = (n + 1) // 2, n // 2
        return ([lo + i for i in range(front)]
                + [hi - back + 1 + i for i in range(back)])
    if rule == "cdr1":
        if n <= 2:
            return [hi - 1 + i for i in range(n)][-n:] if n else []
        return _fill(n - 2, lo, hi - 2, "loop", anchor=anchor) + [hi - 1, hi]
    raise ValueError(f"unknown fill rule {rule!r}")


def convert_chain_numbering(
    numbers: Sequence[int],
    chain_type: str,
    from_scheme: str,
    to_scheme: str,
) -> np.ndarray:
    """Convert one chain's author residue numbers between schemes.

    ``numbers``: integers in file order (insertion-coded residues appear
    as duplicated integers).  ``chain_type``: "heavy" | "light".
    Residues outside the variable domain pass through unchanged.
    """
    numbers = np.asarray(numbers, dtype=np.int64)
    if from_scheme == to_scheme:
        return numbers.copy()
    if chain_type not in _SEGMENTS:
        raise ValueError(f"chain_type must be 'heavy' or 'light', "
                         f"got {chain_type!r}")
    for s in (from_scheme, to_scheme):
        if s not in SCHEME_ANCHOR_CYS:
            raise ValueError(f"unknown scheme {s!r}")

    segments = _SEGMENTS[chain_type]
    out = numbers.copy()
    for seg in segments:
        name, _, _, rule, kc_anchor = seg
        lo_f, hi_f = _span(seg, from_scheme)
        lo_t, hi_t = _span(seg, to_scheme)
        idx = np.nonzero((numbers >= lo_f) & (numbers <= hi_f))[0]
        if idx.size == 0:
            continue
        if rule in ("start", "end", "fr1"):
            # frameworks: map each residue by its source-number OFFSET from
            # the segment anchor, not by residue count — interior missing
            # residues (disordered loops, very common in crystal structures)
            # then leave a gap at their own positions instead of shifting
            # the whole segment off its conserved landmark.  For a complete
            # segment this equals the count-based fill; insertion-coded
            # duplicates map to duplicates.
            src = numbers[idx]
            if rule == "start":
                t = lo_t + (src - lo_f)
            elif rule == "end":
                t = hi_t - (hi_f - src)
            else:  # fr1: first 9 positions start-anchored, rest end-anchored
                t = np.where(src - lo_f < 9,
                             lo_t + (src - lo_f), hi_t - (hi_f - src))
            t = np.clip(t, lo_t, hi_t)
            # insertion-coded duplicates (equal source integers): spread a
            # run into the unused slots before the next residue's target,
            # so e.g. an imgt duplicate 128,128 converts back to chothia
            # 108,109 where there is room, while duplicates at a filled
            # anchor (heavy 82A-C with 83 present) stay duplicates — the
            # kabat/chothia convention
            n_seg = idx.size
            j = 0
            while j < n_seg:
                k = j
                while k + 1 < n_seg and src[k + 1] == src[j]:
                    k += 1
                if k > j:
                    nxt = t[k + 1] if k + 1 < n_seg else hi_t + 1
                    room = max(int(nxt - t[j]), 1)
                    for o in range(k - j + 1):
                        t[j + o] = t[j] + min(o, room - 1)
                j = k + 1
            out[idx] = t
        else:
            # CDR loops: length-based fill is the convention (an n-residue
            # loop numbers front/back halves from the boundaries regardless
            # of its source numbers)
            anchor = kc_anchor if to_scheme != "imgt" else None
            out[idx] = _fill(idx.size, lo_t, hi_t, rule, anchor=anchor)
    # constant-domain residues past the variable domain keep their order
    # but shift by the domain-length difference, so e.g. Chothia CH1
    # residues 114+ do not collide with IMGT's 114-128 Fv positions
    src_max = _span(segments[-1], from_scheme)[1]
    tgt_max = _span(segments[-1], to_scheme)[1]
    tail = numbers > src_max
    out[tail] = numbers[tail] - src_max + tgt_max
    return out


def scheme_anchor_scores(
    numbers: Sequence[int],
    oneletter: Sequence[str],
    chain_type: str,
) -> Dict[str, int]:
    """Anchor-cysteine hit count (0-2) per scheme for one chain.

    Chothia and Kabat share integer anchor positions, so "chothia" stands
    for both (their integer numbering is identical; only CDR *definitions*
    differ).
    """
    numbers = np.asarray(numbers, dtype=np.int64)
    letters = np.asarray(list(oneletter))
    scores = {}
    for scheme in ("chothia", "imgt"):
        anchors = SCHEME_ANCHOR_CYS[scheme][chain_type]
        scores[scheme] = sum(
            bool(np.any((numbers == pos) & (letters == "C")))
            for pos in anchors
        )
    return scores


def detect_numbering_scheme(
    numbers: Sequence[int],
    oneletter: Sequence[str],
    chain_type: str,
) -> Tuple[str, int]:
    """Best-guess scheme for one chain from its conserved-Cys anchors.

    Returns ``(scheme, hits)`` where hits is the matched anchor count for
    the winning scheme.  A TIE between the schemes (e.g. only the shared
    first Cys matched because the second is disordered) is genuinely
    ambiguous — callers that *convert* on this answer should demand a
    strict winner via :func:`scheme_anchor_scores` instead of acting on
    the deterministic chothia tie-break returned here.
    """
    scores = scheme_anchor_scores(numbers, oneletter, chain_type)
    # deterministic tie-break: prefer chothia (the SAbDab default) when
    # the anchors cannot separate the schemes
    best = "chothia" if scores["chothia"] >= scores["imgt"] else "imgt"
    return best, scores[best]


def detect_numbering_scheme_strict(
    numbers: Sequence[int],
    oneletter: Sequence[str],
    chain_type: str,
    fallback: str,
    warn_label: str,
) -> str:
    """Scheme detection that refuses to guess on a tie (conversion-safe).

    Returns ``"chothia"`` / ``"imgt"`` when the anchor-cysteine scores
    produce a strict winner, else ``fallback`` — converting on a tie (e.g.
    only the shared first Cys matched because the second is disordered)
    could silently re-gap an already-correct chain, so ties warn (when any
    anchor matched at all) and leave the numbering as-requested.  Shared
    by :func:`renumber_pdb` and ``AntibodyStructureBatch.from_pdb``.
    """
    scores = scheme_anchor_scores(numbers, oneletter, chain_type)
    if scores["chothia"] > scores["imgt"]:
        return "chothia"
    if scores["imgt"] > scores["chothia"]:
        return "imgt"
    if max(scores.values()) > 0:
        import warnings

        warnings.warn(
            f"{warn_label}: anchor cysteines cannot separate chothia from "
            f"imgt (scores {scores}); falling back to the requested scheme "
            f"(no conversion) — pass source_scheme explicitly to force a "
            f"conversion")
    return fallback


def renumber_pdb(
    in_path: str,
    out_path: str,
    heavy_chain_id: str = None,
    light_chain_id: str = None,
    to_scheme: str = "imgt",
    source_scheme: str = "auto",
) -> dict:
    """Rewrite a PDB with the antibody chains renumbered into ``to_scheme``.

    File-level counterpart of :func:`convert_chain_numbering` (and the CLI
    ``protstruc_tpu_torch renumber``): parses ``in_path``, detects (or takes) the
    source scheme per chain, converts the heavy/light author numbering, and
    writes ATOM records carrying the converted numbers.  Non-antibody
    chains and out-of-domain residues keep their numbering (constant
    domains shift past the variable domain, see convert_chain_numbering).
    Coordinates, atom composition, chain ids and residue order are
    untouched.  Returns a summary dict
    ``{chain: {"from": scheme, "to": scheme}}``.

    Insertion letters are not emitted: positions that carried insertion
    codes in the source become duplicated integers at the scheme's
    insertion anchor (the masks every consumer builds are range-based, so
    this is lossless for them).
    """
    import dataclasses

    from protstruc_tpu_torch.pdbio.parser import parse_pdb
    from protstruc_tpu_torch.vocab import AA, RESTYPE_HEAVY_ATOMS, one2three

    p = parse_pdb(in_path)
    # drop the parser's zero-atom gap-fill rows: they are numbering
    # artifacts (missing residues, or IMGT convention gaps when the file
    # is already IMGT-numbered), emit no ATOM records, and would count as
    # phantom residues in the segment fills
    real = p.atom_mask.any(axis=1)
    p = dataclasses.replace(
        p,
        atom_xyz=p.atom_xyz[real], atom_mask=p.atom_mask[real],
        chain_idx=p.chain_idx[real],
        residue_idx=np.arange(int(real.sum()), dtype=np.int32),
        chain_id_per_res=p.chain_id_per_res[real],
        residue_number=p.residue_number[real],
        insertion=p.insertion[real], oneletter=p.oneletter[real],
    )
    nums = p.residue_number.astype(np.int64).copy()
    summary = {}
    target = "imgt" if to_scheme == "imgt" else "chothia"
    for cid, ctype in ((heavy_chain_id, "heavy"), (light_chain_id, "light")):
        if cid is None:
            continue
        sel = p.chain_id_per_res == cid
        if not sel.any():
            raise ValueError(f"chain {cid!r} not found in {in_path}")
        if source_scheme == "auto":
            src = detect_numbering_scheme_strict(
                nums[sel], p.oneletter[sel], ctype,
                fallback=target, warn_label=f"chain {cid!r}")
        else:
            src = "imgt" if source_scheme == "imgt" else "chothia"
        if src != target:
            nums[sel] = convert_chain_numbering(nums[sel], ctype, src, target)
        summary[cid] = {"from": src, "to": to_scheme}

    # consecutive residues sharing a converted integer are insertions:
    # emit PDB insertion codes (A, B, ...) so they stay distinct residues
    # on re-parse (the parser keys residues by (chain, number, icode))
    icodes = [" "] * p.n_residues
    seen = {}
    for i in range(p.n_residues):
        key = (str(p.chain_id_per_res[i]), int(nums[i]))
        k = seen.get(key, 0)
        if k > 0:
            icodes[i] = chr(ord("A") + k - 1)
        seen[key] = k + 1

    lines = []
    serial = 1
    for i in range(p.n_residues):
        # 'X'->UNK can only come from the parser's zero-atom gap dummies
        # (non-canonical residues are dropped at parse), and those rows
        # were filtered above — so the empty UNK slot table never eats a
        # real residue's atoms here
        aa3 = one2three.get(str(p.oneletter[i]), "UNK")
        slot_names = RESTYPE_HEAVY_ATOMS[AA(aa3)]
        for s in range(p.atom_xyz.shape[1]):
            if not p.atom_mask[i, s] or not np.isfinite(p.atom_xyz[i, s]).all():
                continue
            name = slot_names[s]
            if not name:
                continue
            x, y, z = (float(v) for v in p.atom_xyz[i, s])
            pad_name = f" {name:<3s}" if len(name) < 4 else name
            lines.append(
                f"ATOM  {serial:5d} {pad_name} {aa3} {str(p.chain_id_per_res[i]):1s}"
                f"{int(nums[i]):4d}{icodes[i]:1s}   {x:8.3f}{y:8.3f}{z:8.3f}"
                f"{1.00:6.2f}{0.00:6.2f}          {name[0]:>2s}"
            )
            serial += 1
    lines.append("END")
    with open(out_path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return summary
