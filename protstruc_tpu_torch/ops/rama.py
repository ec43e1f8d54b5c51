"""Ramachandran (phi/psi) validation, port of ``protstruc_tpu/ops/rama.py``.

Coarse elliptical region classification (favored / allowed / outlier) with
analytic regions per residue class (general / glycine / proline); glycine is
also allowed in the mirrored (left-handed) regions.
"""

from __future__ import annotations

import math

import torch

from protstruc_tpu_torch.vocab import AA

__all__ = ["ramachandran_classes", "RAMA_FAVORED", "RAMA_ALLOWED", "RAMA_OUTLIER"]

RAMA_FAVORED, RAMA_ALLOWED, RAMA_OUTLIER = 0, 1, 2

# (phi0, psi0, r_phi, r_psi) in degrees: favored ellipses
_GENERAL = (
    (-63.0, -43.0, 35.0, 45.0),    # alpha
    (-120.0, 135.0, 65.0, 55.0),   # beta (psi wraps: 135 +/- 55 spans 180)
    (-90.0, 0.0, 30.0, 30.0),      # bridge between alpha and beta
    (57.0, 40.0, 25.0, 35.0),      # left-handed alpha (Asn/Asp/Gly mostly)
)
_PRO = (
    (-63.0, -35.0, 25.0, 40.0),    # proline alpha
    (-65.0, 145.0, 30.0, 40.0),    # proline polyproline-II/beta
)
_ALLOWED_SCALE = 1.7  # allowed = favored ellipses inflated by this factor


def _wrap(x):
    """Wrap degrees into (-180, 180]."""
    return x - 360.0 * torch.round(x / 360.0)


def _in_ellipses(phi, psi, regions, scale=1.0):
    hit = torch.zeros(phi.shape, dtype=torch.bool, device=phi.device)
    for p0, s0, rp, rs in regions:
        dp = _wrap(phi - p0) / (rp * scale)
        ds = _wrap(psi - s0) / (rs * scale)
        hit = hit | (dp * dp + ds * ds <= 1.0)
    return hit


def ramachandran_classes(phi: torch.Tensor, psi: torch.Tensor, seq_idx: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Classify each residue's (phi, psi) pair.

    Args:
        phi, psi: ``(B, L)`` backbone dihedrals in **radians**.
        seq_idx: ``(B, L)`` residue types (GLY and PRO get their own rules).
        valid: ``(B, L)`` residues with defined phi AND psi.

    Returns ``(B, L)`` int32: 0 favored, 1 allowed, 2 outlier; invalid
    residues are favored (0) so fraction reducers can mask with ``valid``.
    """
    # jnp.degrees: x * float32(180 / pi)
    phi_d = phi * (180.0 / math.pi)
    psi_d = psi * (180.0 / math.pi)

    gen_fav = _in_ellipses(phi_d, psi_d, _GENERAL)
    gen_alw = _in_ellipses(phi_d, psi_d, _GENERAL, _ALLOWED_SCALE)
    # glycine: no CB, mirrored regions are equally accessible
    gly_fav = gen_fav | _in_ellipses(-phi_d, -psi_d, _GENERAL)
    gly_alw = gen_alw | _in_ellipses(-phi_d, -psi_d, _GENERAL, _ALLOWED_SCALE)
    pro_fav = _in_ellipses(phi_d, psi_d, _PRO)
    pro_alw = _in_ellipses(phi_d, psi_d, _PRO, _ALLOWED_SCALE)

    is_gly = seq_idx == int(AA.GLY)
    is_pro = seq_idx == int(AA.PRO)
    fav = torch.where(is_gly, gly_fav, torch.where(is_pro, pro_fav, gen_fav))
    alw = torch.where(is_gly, gly_alw, torch.where(is_pro, pro_alw, gen_alw))

    cls = torch.where(fav, RAMA_FAVORED, torch.where(alw, RAMA_ALLOWED, RAMA_OUTLIER))
    return torch.where(valid, cls, RAMA_FAVORED).to(torch.int32)
