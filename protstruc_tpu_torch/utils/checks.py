"""Input validation / failure detection (host-side; port of
``protstruc_tpu/utils/checks.py``, on a host copy of the batch's tensors).

The reference's only 'failure handling' is parse-time sanitization
(SURVEY.md §5).  ``validate_batch`` extends that with an explicit contract
check for StructureBatch invariants, catching malformed containers before
they reach device code where the failure mode would be silent NaNs.
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["validate_batch", "BatchValidationError"]


class BatchValidationError(ValueError):
    """A StructureBatch violates its invariants; ``.problems`` lists them."""

    def __init__(self, problems: List[str]):
        self.problems = problems
        super().__init__("invalid StructureBatch:\n- " + "\n- ".join(problems))


def validate_batch(batch, raise_on_error: bool = True) -> List[str]:
    """Check StructureBatch invariants; returns the list of problems found.

    Checks: field shapes agree; coordinates are finite wherever atom_mask is
    True; chain/residue indices are -1 exactly at padding; chain indices per
    structure start at 0 and are non-decreasing in blocks; standardization
    state is consistent.
    """
    problems: List[str] = []
    xyz, am, ci, ri = (t.detach().cpu().numpy()
                       for t in (batch.xyz, batch.atom_mask, batch.chain_idx, batch.residue_idx))

    B, L, A = xyz.shape[:3]
    if xyz.shape[3:] != (3,):
        problems.append(f"xyz trailing dim is {xyz.shape[3:]}, want (3,)")
    if am.shape != (B, L, A):
        problems.append(f"atom_mask shape {am.shape} != {(B, L, A)}")
    if ci.shape != (B, L):
        problems.append(f"chain_idx shape {ci.shape} != {(B, L)}")
    if ri.shape != (B, L):
        problems.append(f"residue_idx shape {ri.shape} != {(B, L)}")
    if problems:
        if raise_on_error:
            raise BatchValidationError(problems)
        return problems

    bad = ~np.isfinite(xyz[am])
    if bad.any():
        problems.append(
            f"{int(bad.sum())} non-finite coordinates where atom_mask is True"
        )

    residue_mask = am.any(-1)
    # padding rows may keep a real chain idx only if the residue is a gap
    # dummy inside a chain; flag rows beyond the last valid residue.  The
    # scan runs unconditionally over every structure (an early `.any()`
    # pre-filter keyed on -1 specifically would skip e.g. a -2 pad value,
    # and breaking on the first offender hid the rest).
    for b in range(B):
        valid = np.flatnonzero(residue_mask[b])
        if valid.size and (ci[b, valid[-1] + 1 :] != -1).any():
            problems.append(f"structure {b}: chain_idx not -1 after last residue")
        if valid.size and (ri[b, valid[-1] + 1 :] != -1).any():
            problems.append(
                f"structure {b}: residue_idx not -1 after last residue")
    for b in range(B):
        chains = ci[b][ci[b] >= 0]
        if chains.size:
            if chains.min() != 0:
                problems.append(f"structure {b}: chain indices do not start at 0")
            if (np.diff(chains) < 0).any():
                problems.append(f"structure {b}: chain indices decrease")

    if batch.standardized and (batch.mu is None or batch.std is None):
        problems.append("standardized=True but mu/std missing")
    if not batch.standardized and batch.mu is not None:
        problems.append("standardized=False but mu present")

    if problems and raise_on_error:
        raise BatchValidationError(problems)
    return problems
