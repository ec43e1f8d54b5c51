"""Secondary-structure assignment (DSSP-style), port of
``protstruc_tpu/ops/secondary.py``.

Kabsch-Sander hydrogen-bond energies from backbone coordinates (amide H
inferred from the previous residue's carbonyl), then helix/strand/coil
assignment from n-turn and bridge patterns: a vectorized O(L^2) map.

Classes: 0 = coil (C), 1 = helix (H, 4-turns), 2 = strand (E, bridges);
the 8-class alphabet is ``SS8_LETTERS``.  The previous-residue constructions
(amide H, bend virtual-bond angle) are guarded by ``chain_idx`` and
neighbour validity.  Distances are taken with a correctly rounded square
root, as XLA takes them, since an H-bond is a threshold on the energy.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from protstruc_tpu_torch.geometry import _exact_sqrt
from protstruc_tpu_torch.ops.surface import _sq_dist

__all__ = ["hbond_energy_map", "assign_secondary_structure", "assign_secondary_structure_8",
           "SS_COIL", "SS_HELIX", "SS_STRAND", "SS8_LETTERS", "SS8_TO_3"]

SS_COIL, SS_HELIX, SS_STRAND = 0, 1, 2

_Q1Q2_F = 27.888  # 0.084 e^2 * 332 kcal/mol/A (Kabsch & Sander 1983)
_HBOND_CUTOFF = -0.5  # kcal/mol
# the bend threshold as jnp.cos(jnp.deg2rad(110.0)) gives it: the cosine of
# the float32 angle, rounded to float32
_COS_110 = float(np.float32(math.cos(float(np.float32(math.radians(110.0))))))


def _dot3(a, b):
    """``sum_k a_k b_k`` over a trailing axis of 3, left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _pad_left(x: torch.Tensor, k: int = 1, value=False) -> torch.Tensor:
    """``x`` shifted right by ``k`` along dim 1, ``value`` in front (all
    ``value`` when ``k`` reaches the length)."""
    L = x.shape[1]
    if k >= L:
        return torch.full_like(x, value)
    return torch.nn.functional.pad(x[:, :L - k], (k, 0), value=value)


def _prev_same_chain(residue_mask, chain_idx):
    """(B, L) bool: residue i-1 exists, is valid, and shares i's chain."""
    prev_valid = _pad_left(residue_mask)
    if chain_idx is None:
        return prev_valid & (torch.arange(residue_mask.shape[1], device=residue_mask.device) > 0)[None]
    return prev_valid & (chain_idx == _pad_left(chain_idx, value=-1))


def hbond_energy_map(n: torch.Tensor, ca: torch.Tensor, c: torch.Tensor, o: torch.Tensor,
                     residue_mask: torch.Tensor,
                     chain_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kabsch-Sander energy E[b, i, j] of the H-bond C=O(i) ... H-N(j).

    Inputs: ``(B, L, 3)`` backbone atom coordinates + ``(B, L)`` mask, and
    optionally ``(B, L)`` chain indices.  The amide H of residue j sits
    1.0 A from N(j) along the previous residue's C->O direction reversed;
    donors whose previous residue is missing, invalid, or on another chain
    have no defined amide H and are excluded (without ``chain_idx`` only the
    global first residue is).
    """
    prev_dir = torch.roll(c - o, shifts=1, dims=1)
    # guard the normalization: a zeroed previous residue gives a zero
    # direction whose 0/0 would put NaN into that donor's row
    nrm = _exact_sqrt(_dot3(prev_dir, prev_dir))[..., None]
    h = n + prev_dir / torch.clamp_min(nrm, 1e-6)  # 1.0 A from N

    def dist(a, b):
        d = _exact_sqrt(_sq_dist(a[:, :, None, :], b[:, None, :, :]))
        return torch.clamp_min(d, 0.5)  # avoid singularities on garbage pairs

    # E(i, j): acceptor C=O on residue i, donor N-H on residue j
    e = _Q1Q2_F * (1.0 / dist(o, n) + 1.0 / dist(c, h) - 1.0 / dist(o, h) - 1.0 / dist(c, n))

    L = n.shape[1]
    pos = torch.arange(L, device=n.device)
    valid = residue_mask[:, :, None] & residue_mask[:, None, :]
    valid = valid & ((pos[:, None] - pos[None, :]).abs() > 1)[None]  # not self or neighbours
    valid = valid & _prev_same_chain(residue_mask, chain_idx)[:, None, :]
    return torch.where(valid, e, 0.0)


# --- shared pattern helpers (3-class and 8-class assignment) ----------------


def _shift_diag(m, k):
    """d[b, i] = m[b, i, i+k] (False out of range)."""
    L = m.shape[1]
    idx = torch.arange(L, device=m.device) + k
    ok = (idx >= 0) & (idx < L)
    out = torch.gather(m, 2, idx.clamp(0, L - 1)[None, :, None].expand(m.shape[0], L, 1))[..., 0]
    return out & ok[None, :]


def _shifted(m, di, dj):
    """m[i+di, j+dj] as a (B, L, L) map (False out of range)."""
    L = m.shape[1]
    pos = torch.arange(L, device=m.device)
    s = torch.roll(m, shifts=(-di, -dj), dims=(1, 2))
    ok_i = (pos + di >= 0) & (pos + di < L)
    ok_j = (pos + dj >= 0) & (pos + dj < L)
    return s & ok_i[None, :, None] & ok_j[None, None, :]


def _run_from_starts(starts, length):
    """Mark ``length`` residues from every start position."""
    out = torch.zeros_like(starts)
    for k in range(length):
        out = out | (_pad_left(starts, k) if k else starts)
    return out


def _bridge_map(hb):
    """Kabsch-Sander parallel/antiparallel bridge map (B, L, L).

    parallel:     [hb(i-1, j) and hb(j, i+1)] or [hb(j-1, i) and hb(i, j+1)]
    antiparallel: [hb(i, j) and hb(j, i)] or [hb(i-1, j+1) and hb(j-1, i+1)]
    """
    L = hb.shape[1]
    hbT = hb.transpose(1, 2)  # hbT[i, j] = hb[j, i]
    parallel = ((_shifted(hb, -1, 0) & _shifted(hbT, 1, 0))
                | (_shifted(hbT, 0, -1) & _shifted(hb, 0, 1)))
    antipar = (hb & hbT) | (_shifted(hb, -1, 1) & _shifted(hbT, 1, -1))
    pos = torch.arange(L, device=hb.device)
    far = (pos[:, None] - pos[None, :]).abs() > 2
    return (parallel | antipar) & far[None]


def _helix_runs(hb, k):
    """(k-turns at i, residues of helices of two consecutive k-turns)."""
    tk = _shift_diag(hb, k)
    return tk, _run_from_starts(_pad_left(tk) & tk, k)


def assign_secondary_structure(n: torch.Tensor, ca: torch.Tensor, c: torch.Tensor,
                               o: torch.Tensor, residue_mask: torch.Tensor,
                               chain_idx: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DSSP-style 3-class secondary structure. Returns ``(ss, hbond_map)``.

    ``ss``: ``(B, L)`` int32 in {0 coil, 1 helix, 2 strand}.  Helix:
    consecutive (i, i+4) turns (DSSP H).  Strand: parallel or antiparallel
    bridge patterns (DSSP E).
    """
    hb = hbond_energy_map(n, ca, c, o, residue_mask, chain_idx) < _HBOND_CUTOFF
    _, helix = _helix_runs(hb, 4)
    bridge = _bridge_map(hb)
    strand = bridge.any(2) | bridge.any(1)
    ss = torch.where(helix, SS_HELIX, torch.where(strand, SS_STRAND, SS_COIL))
    return torch.where(residue_mask, ss, SS_COIL).to(torch.int32), hb


# --- full 8-class DSSP alphabet --------------------------------------------
# int codes chosen so {0, 1, 2} match the 3-class values above
SS8_COIL, SS8_HELIX, SS8_STRAND = 0, 1, 2
SS8_310, SS8_PI, SS8_BRIDGE, SS8_TURN, SS8_BEND = 3, 4, 5, 6, 7
SS8_LETTERS = "CHEGIBTS"  # index -> DSSP letter ('C' for coil/' ')
#: standard DSSP 8->3 grouping: H/G/I -> helix, E/B -> strand, rest coil
SS8_TO_3 = (0, 1, 2, 1, 1, 2, 0, 0)


def assign_secondary_structure_8(n: torch.Tensor, ca: torch.Tensor, c: torch.Tensor,
                                 o: torch.Tensor, residue_mask: torch.Tensor,
                                 chain_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full 8-class DSSP assignment, ``(B, L)`` int32.

    Classes (``SS8_LETTERS``): H alpha-helix (4-turns), G 3-10 helix
    (3-turns), I pi-helix (5-turns), E strand (ladder), B isolated
    beta-bridge, T hydrogen-bonded turn, S bend (kappa > 70 deg), C coil.
    Priority follows DSSP: H > E > B > G > I > T > S.
    """
    hb = hbond_energy_map(n, ca, c, o, residue_mask, chain_idx) < _HBOND_CUTOFF
    B, L = residue_mask.shape
    turns = {k: _helix_runs(hb, k) for k in (3, 4, 5)}

    bridge_map = _bridge_map(hb)
    bridged = bridge_map.any(2) | bridge_map.any(1)
    # ladder (E) when a sequence neighbour also bridges; else isolated B
    nb = _pad_left(bridged) | torch.nn.functional.pad(bridged[:, 1:], (0, 1), value=False)
    strand_e = bridged & nb
    bridge_b = bridged & ~nb

    # hydrogen-bonded turn: residues i+1 .. i+k-1 of any k-turn at i
    turn_t = torch.zeros((B, L), dtype=torch.bool, device=hb.device)
    for k, (tk, _) in turns.items():
        turn_t = turn_t | _run_from_starts(_pad_left(tk), k - 1)

    # bend: kappa(CA(i-2), CA(i), CA(i+2)) > 70 degrees, only where both +-2
    # neighbours exist, are valid, and share i's chain
    u = torch.roll(ca, 2, dims=1) - ca
    v = torch.roll(ca, -2, dims=1) - ca
    cosang = _dot3(u, v) / _exact_sqrt(torch.clamp_min(_dot3(u, u) * _dot3(v, v), 1e-12))
    pos = torch.arange(L, device=ca.device)
    bend_ok = ((pos >= 2) & (pos < L - 2))[None]
    bend_ok = bend_ok & torch.roll(residue_mask, 2, dims=1) & torch.roll(residue_mask, -2, dims=1)
    if chain_idx is not None:
        bend_ok = bend_ok & (torch.roll(chain_idx, 2, dims=1) == chain_idx)
        bend_ok = bend_ok & (torch.roll(chain_idx, -2, dims=1) == chain_idx)
    # kappa = pi - angle(u, v); kappa > 70 deg <=> angle < 110 deg
    bend_s = (cosang > _COS_110) & bend_ok

    ss = torch.full((B, L), SS8_COIL, dtype=torch.int32, device=hb.device)
    for cls, m in [(SS8_BEND, bend_s), (SS8_TURN, turn_t), (SS8_PI, turns[5][1]),
                   (SS8_310, turns[3][1]), (SS8_BRIDGE, bridge_b), (SS8_STRAND, strand_e),
                   (SS8_HELIX, turns[4][1])]:
        ss = torch.where(m, cls, ss)
    return torch.where(residue_mask, ss, SS8_COIL).to(torch.int32)

