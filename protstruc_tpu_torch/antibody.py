"""Antibody-aware structure batches with CDR/chain masks.

Port of ``protstruc_tpu/antibody.py``: ``AntibodyStructureBatch`` is the
port's ``StructureBatch`` with chain-filtered ingest, optional Fv trimming,
numbering-scheme conversion (``numbering.py``) and nine named ``(B, L)``
residue masks (heavy/light/antigen, the Fv, and the six CDR loops), which
live on the batch's device with its tensors.  All three schemes
("chothia", "kabat", "imgt") have loop tables.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from protstruc_tpu_torch.batch import DeviceLike, StructureBatch, _compact_order, resolve_device
from protstruc_tpu_torch.vocab import CDR_NAMES

__all__ = ["AntibodyStructureBatch", "NUMBERING_SCHEMES"]


#: CDR loop ranges (inclusive author numbering) and Fv ranges per scheme.
#: Chothia values match the reference class attributes (dohlee/protstruc pdb.py:183-190);
#: Kabat and IMGT are the standard published definitions.
NUMBERING_SCHEMES: Dict[str, Dict[str, Tuple[int, int]]] = {
    "chothia": {
        "fv_heavy": (1, 113), "fv_light": (1, 106),
        "H1": (26, 32), "H2": (52, 56), "H3": (95, 102),
        "L1": (24, 34), "L2": (50, 56), "L3": (89, 97),
    },
    "kabat": {
        "fv_heavy": (1, 113), "fv_light": (1, 107),
        "H1": (31, 35), "H2": (50, 65), "H3": (95, 102),
        "L1": (24, 34), "L2": (50, 56), "L3": (89, 97),
    },
    "imgt": {
        "fv_heavy": (1, 128), "fv_light": (1, 127),
        "H1": (27, 38), "H2": (56, 65), "H3": (105, 117),
        "L1": (27, 38), "L2": (56, 65), "L3": (105, 117),
    },
}

_MASK_KEYS = ("heavy_chain", "light_chain", "antigen", "fv") + tuple(CDR_NAMES)


#: Conserved framework anchor residues per scheme (position -> expected
#: amino acids).  The two domain-forming cysteines are invariant in >99% of
#: antibody variable domains and sit at scheme-specific positions, so their
#: absence at the expected positions is a reliable wrong-scheme signal
#: (the same probe ANARCI-style tools use for numbering validation).
_SCHEME_ANCHORS = {
    "chothia": {"heavy": {22: "C", 92: "C"}, "light": {23: "C", 88: "C"}},
    "kabat": {"heavy": {22: "C", 92: "C"}, "light": {23: "C", 88: "C"}},
    "imgt": {"heavy": {23: "C", 104: "C"}, "light": {23: "C", 104: "C"}},
}


def _warn_if_scheme_implausible(path, scheme_name, masks, heavy, light,
                                num, oneletter):
    """Warn when the numbering looks like a scheme mismatch.

    The scheme tables assume the input is already numbered in the chosen
    scheme (module docstring); feeding e.g. a Chothia-numbered file with
    ``numbering_scheme="imgt"`` silently yields shifted CDR masks.  Two
    plausibility probes close that trap:

    * the scheme's conserved cysteine anchors are absent from a present
      chain (fewer than half of the expected positions carry the expected
      residue), or
    * an empty CDR loop mask on a present chain (every Fv has all six).
    """
    import warnings

    problems = []
    for name, chain in (("heavy", heavy), ("light", light)):
        if not chain.any():
            continue
        by_num = dict(zip(num[chain].tolist(), oneletter[chain].tolist()))
        anchors = _SCHEME_ANCHORS[scheme_name][name]
        hits = sum(by_num.get(pos) == aa for pos, aa in anchors.items())
        if hits * 2 < len(anchors):
            missing = {pos: by_num.get(pos) for pos, aa in anchors.items()
                       if by_num.get(pos) != aa}
            problems.append(
                f"{name} chain lacks the scheme's conserved Cys anchors "
                f"(found {missing} where Cys was expected)")
        loops = [l for l in CDR_NAMES if l.startswith(name[0].upper())]
        empty = [l for l in loops if not masks[l].any()]
        if empty:
            problems.append(f"empty CDR mask(s) {empty} on the present "
                            f"{name} chain")
    if problems:
        warnings.warn(
            f"{path}: {'; '.join(problems)} under numbering_scheme="
            f"'{scheme_name}'. The structure is likely numbered in a "
            f"different scheme — protstruc-tpu applies the scheme's ranges "
            f"to the author numbering as-is (no renumbering).",
            UserWarning,
            stacklevel=3,
        )


def _always_list(x):
    return x if isinstance(x, list) else [x]


def _isnull(x) -> bool:
    if isinstance(x, list):
        return any(_isnull(v) for v in x)
    return x is None or (isinstance(x, float) and np.isnan(x))



@dataclasses.dataclass(frozen=True)
class AntibodyStructureBatch(StructureBatch):
    """StructureBatch specialized for antibody (Fv) structures.

    Adds per-residue named masks (``residue_masks``: heavy_chain,
    light_chain, antigen, fv and the six CDR loops, each ``(B, L)`` bool on
    the batch's device) and per-structure chain-role metadata.
    """

    residue_masks: Optional[Dict[str, torch.Tensor]] = None
    heavy_chain_id: Optional[Tuple[Optional[str], ...]] = None
    light_chain_id: Optional[Tuple[Optional[str], ...]] = None
    antigen_chain_ids: Optional[Tuple[Tuple[str, ...], ...]] = None
    numbering_scheme: str = "chothia"
    keep_fv_only: bool = False

    # ------------------------------------------------------------------
    # mask accessors
    # ------------------------------------------------------------------

    def get_heavy_chain_mask(self) -> torch.Tensor:
        return self.residue_masks["heavy_chain"]

    def get_light_chain_mask(self) -> torch.Tensor:
        return self.residue_masks["light_chain"]

    def get_antigen_mask(self) -> torch.Tensor:
        return self.residue_masks["antigen"]

    def get_heavy_chain_id(self) -> List[Optional[str]]:
        return list(self.heavy_chain_id)

    def get_light_chain_id(self) -> List[Optional[str]]:
        return list(self.light_chain_id)

    def get_antigen_chain_ids(self) -> List[List[str]]:
        return [list(c) for c in self.antigen_chain_ids]

    def is_fv_only(self) -> bool:
        return self.keep_fv_only

    def get_fv_mask(self) -> torch.Tensor:
        """Residues of the Fv region of either chain (by the scheme's ranges
        on the author numbering, decided at ingest)."""
        return self.residue_masks["fv"]

    def get_cdr_mask(self, subset: Union[str, List[str], None] = None) -> torch.Tensor:
        """Union of the selected CDR loop masks; ``None`` means all six, an
        empty list is rejected."""
        if subset is None:
            subset = list(CDR_NAMES)
        subset = _always_list(subset)
        if not subset:
            raise ValueError("subset must name at least one CDR (or be None for all)")
        masks = torch.stack([self.residue_masks[cdr.upper()] for cdr in subset])
        return masks.any(dim=0)

    def get_cdr_anchor_mask(self, subset: Union[str, List[str], None] = None) -> torch.Tensor:
        """Residues immediately flanking (but outside) the selected CDR loops
        (``subset`` as in ``get_cdr_mask``)."""
        if subset is None:
            subset = list(CDR_NAMES)
        subset = _always_list(subset)
        for cdr in subset:
            if cdr.upper() not in CDR_NAMES:
                raise ValueError(f"CDR {cdr} is not valid.")

        cdr = self.get_cdr_mask(subset)
        pad = torch.nn.functional.pad
        nxt = pad(cdr[:, 1:], (0, 1), value=False)
        prv = pad(cdr[:, :-1], (1, 0), value=False)
        return (~cdr & nxt) | (~cdr & prv)

    def get_residue_idx(self) -> torch.Tensor:
        return self.residue_idx

    def residue_compact(self, mask) -> "AntibodyStructureBatch":
        """Mask-and-compact (``StructureBatch.residue_compact``) that also
        reorders the named residue masks."""
        base = StructureBatch.residue_compact(self, mask)
        if self.residue_masks is None:
            return base
        _, order, keep = _compact_order(mask, self)
        return base.replace(residue_masks={k: v.gather(1, order) & keep
                                           for k, v in self.residue_masks.items()})

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------

    @classmethod
    def from_pdb_id(
        cls,
        pdb_id: Union[str, List[str]],
        heavy_chain_id: Union[str, List[str], None] = None,
        light_chain_id: Union[str, List[str], None] = None,
        antigen_chain_ids: Union[str, List, None] = None,
        numbering_scheme: str = "chothia",
        keep_fv_only: bool = False,
        device: DeviceLike = "cuda",
    ) -> "AntibodyStructureBatch":
        """Fetch entries (local cache first, ``pdbio/fetch.py``) and build an
        antibody batch with its masks through :meth:`from_pdb`."""
        from protstruc_tpu_torch.pdbio.fetch import fetch_pdb

        paths = [fetch_pdb(i) for i in _always_list(pdb_id)]
        return cls.from_pdb(paths, heavy_chain_id=heavy_chain_id, light_chain_id=light_chain_id,
                            antigen_chain_ids=antigen_chain_ids,
                            numbering_scheme=numbering_scheme, keep_fv_only=keep_fv_only,
                            device=device)

    @classmethod
    def from_pdb(
        cls,
        pdb_path: Union[str, List[str]],
        heavy_chain_id: Union[str, List[str], None] = None,
        light_chain_id: Union[str, List[str], None] = None,
        antigen_chain_ids: Union[str, List, None] = None,
        numbering_scheme: str = "chothia",
        keep_fv_only: bool = False,
        source_scheme: str = "auto",
        device: DeviceLike = "cuda",
    ) -> "AntibodyStructureBatch":
        """Parse antibody PDBs keeping only the heavy/light/antigen chains.

        Chains are filtered before the residue walk; ``keep_fv_only`` trims
        to the scheme's Fv ranges; chain ids may be None/NaN.

        ``source_scheme``: the scheme the *file* is numbered in.  The default
        ``"auto"`` detects it per chain from the conserved domain-cysteine
        anchors and, where it differs from ``numbering_scheme``, converts
        the author numbering (``numbering.py``) before the masks are built,
        so a Chothia-numbered file ingested with ``numbering_scheme="imgt"``
        gets IMGT CDR masks.  ``source_scheme=None`` asserts the file is
        already in ``numbering_scheme`` (ranges applied as they are, with a
        warning where they look wrong).  Parsing and masks are built on the
        host, then moved to ``device`` once.
        """
        dev = resolve_device(device)
        if numbering_scheme is None:
            numbering_scheme = "chothia"
        if numbering_scheme not in NUMBERING_SCHEMES:
            raise ValueError(
                'Antibody numbering scheme must be one of "kabat", "chothia", "imgt".')
        if source_scheme not in (None, "auto") and source_scheme not in NUMBERING_SCHEMES:
            raise ValueError(
                'source_scheme must be None, "auto", or one of "kabat", '
                '"chothia", "imgt".')
        scheme = NUMBERING_SCHEMES[numbering_scheme]

        from protstruc_tpu_torch import numbering as _nb
        from protstruc_tpu_torch.pdbio.parser import parse_pdb

        paths = _always_list(pdb_path)
        bsz = len(paths)
        hids = [None if _isnull(x) else x for x in _always_list(heavy_chain_id)]
        lids = [None if _isnull(x) else x for x in _always_list(light_chain_id)]
        aidss = [None if _isnull(x) else x for x in _always_list(antigen_chain_ids)]
        if len(hids) == 1:
            hids = hids * bsz
        if len(lids) == 1:
            lids = lids * bsz
        if len(aidss) == 1:
            aidss = aidss * bsz
        if not (len(hids) == len(lids) == len(aidss) == bsz):
            raise ValueError(
                f"chain-id lists must have length 1 or match the number of "
                f"files ({bsz}); got heavy={len(hids)}, light={len(lids)}, "
                f"antigen={len(aidss)}")

        def _int_scheme(s):
            # chothia and kabat share integer numbering; only the CDR
            # definition tables (and insertion letters) differ
            return "imgt" if s == "imgt" else "chothia"

        # conversion can only happen when a source scheme may differ from
        # the requested one; then Fv trimming waits until the numbers are
        # converted (the file's numbers are in the source scheme)
        convertible = source_scheme is not None and (
            source_scheme == "auto"
            or _int_scheme(source_scheme) != _int_scheme(numbering_scheme))

        parsed, masks_per = [], []
        for f, hid, lid, aids in zip(paths, hids, lids, aidss):
            aids = [] if aids is None else _always_list(aids)
            chains = [c for c in [hid, lid] if c is not None] + list(aids)

            ranges = None
            if keep_fv_only and not convertible:
                ranges = {}
                if hid is not None:
                    ranges[hid] = scheme["fv_heavy"]
                if lid is not None:
                    ranges[lid] = scheme["fv_light"]

            p = parse_pdb(f, chains=chains or None, residue_range_by_chain=ranges)

            cid = p.chain_id_per_res
            num = p.residue_number
            heavy = cid == hid if hid is not None else np.zeros(len(cid), bool)
            light = cid == lid if lid is not None else np.zeros(len(cid), bool)

            if convertible:
                num = num.astype(np.int64).copy()
                target = _int_scheme(numbering_scheme)
                # conversion counts only atom-bearing residues: the parser's
                # zero-atom gap rows (numbering gaps, IMGT's convention gaps)
                # would count as phantom residues and shift every fill; they
                # get -1 (outside every range) when conversion applies
                has_atoms = np.asarray(p.atom_mask).any(axis=1)
                for chain_mask, ctype in ((heavy, "heavy"), (light, "light")):
                    real = chain_mask & has_atoms
                    if not real.any():
                        continue
                    if source_scheme == "auto":
                        src = _nb.detect_numbering_scheme_strict(
                            num[real], p.oneletter[real], ctype,
                            fallback=target, warn_label=f"{ctype} chain")
                    else:
                        src = _int_scheme(source_scheme)
                    if src != target:
                        num[real] = _nb.convert_chain_numbering(num[real], ctype, src, target)
                        num[chain_mask & ~has_atoms] = -1
                if keep_fv_only:
                    h_lo, h_hi = scheme["fv_heavy"]
                    l_lo, l_hi = scheme["fv_light"]
                    keep = ~(heavy | light)
                    keep |= heavy & (num >= h_lo) & (num <= h_hi)
                    keep |= light & (num >= l_lo) & (num <= l_hi)
                    p = dataclasses.replace(
                        p,
                        atom_xyz=p.atom_xyz[keep],
                        atom_mask=p.atom_mask[keep],
                        chain_idx=p.chain_idx[keep],
                        residue_idx=np.arange(int(keep.sum()), dtype=np.int32),
                        chain_id_per_res=p.chain_id_per_res[keep],
                        residue_number=p.residue_number[keep],
                        insertion=p.insertion[keep],
                        oneletter=p.oneletter[keep],
                    )
                    num = num[keep]
                    cid = p.chain_id_per_res
                    heavy = heavy[keep]
                    light = light[keep]

            parsed.append(p)
            antigen = np.isin(cid, aids) if aids else np.zeros(len(cid), bool)

            h_lo, h_hi = scheme["fv_heavy"]
            l_lo, l_hi = scheme["fv_light"]
            fv = (heavy & (num >= h_lo) & (num <= h_hi)) | (light & (num >= l_lo) & (num <= l_hi))
            m = {"heavy_chain": heavy, "light_chain": light, "antigen": antigen, "fv": fv}
            for loop in CDR_NAMES:
                lo, hi = scheme[loop]
                chain_mask = heavy if loop.startswith("H") else light
                m[loop] = chain_mask & (num >= lo) & (num <= hi)
            _warn_if_scheme_implausible(f, numbering_scheme, m, heavy, light, num, p.oneletter)
            masks_per.append(m)

        base = StructureBatch._from_parsed(parsed, device=dev)
        max_l = base.n_residues

        residue_masks = {}
        for key in _MASK_KEYS:
            arr = np.zeros((bsz, max_l), dtype=bool)
            for i, m in enumerate(masks_per):
                arr[i, : len(m[key])] = m[key]
            residue_masks[key] = torch.from_numpy(arr).to(dev)

        return cls(
            xyz=base.xyz,
            atom_mask=base.atom_mask,
            chain_idx=base.chain_idx,
            residue_idx=base.residue_idx,
            chain_ids=base.chain_ids,
            seq=base.seq,
            residue_masks=residue_masks,
            heavy_chain_id=tuple(hids),
            light_chain_id=tuple(lids),
            antigen_chain_ids=tuple(
                tuple(_always_list(a)) if a is not None else () for a in aidss),
            numbering_scheme=numbering_scheme,
            keep_fv_only=keep_fv_only,
        )
