"""Fused model-input features: the hand-written CUDA kernel (K3) and its plain version.

Port of ``protstruc_tpu/ops/pallas_pairwise.py`` ``model_features_pallas``
(the kernel ``_make_model_kernel``), the training ingest's fast path.  One
pass over ``(B, L, L)`` emits what the FoldModel trunk embeds and its loss
reads:

* ``d_cb_bins (B, L, L)`` int32: ``int(min(d_cb * ratio, n_bins - 1))``
  with ``ratio = n_bins / max_dist`` rounded once to float32 and a NaN
  distance taken as ``max_dist`` (the last bin).  These are K3's bins, not
  ``ops.histogram.distogram_bins`` (``d / max_dist * n_bins``): the two
  differ at bin edges;
* ``ang_sincos (B, L, L, 6)`` in ``ang_dtype``: [sin w, cos w, sin t, cos t,
  sin phi, cos phi], by rsqrt with no atan2; degenerate w/t (exact
  coordinate equality, as in K1) give (0, 1), NaN or zero-length ones
  (0, 0).  The JAX kernel wrote ``(B, 6, L, L)`` and moved the axis after;
  here the planes are written in the trunk's layout.

:func:`model_features` dispatches on the tensor's device and nothing else: a
CUDA tensor launches the kernel in ``csrc/model_features.cu`` (or raises), a
CPU tensor takes :func:`_model_features_plain`, the same formulas and
rounding points in plain PyTorch.  :func:`model_inputs` adds the pair mask
(CB present and finite at both ends) for ``featurize_for_model(fused=True)``.
The kernel walks ``(B, L, L)`` as K1 does, by the plan ``ops.pair_maps.tile_plan``
lays out.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from protstruc_tpu_torch.ops import cuda_lib
from protstruc_tpu_torch.ops.pair_maps import (
    _check_xyz,
    _cross,
    _dot,
    _eq3,
    _PlanC,
    _sub,
    launch_error,
    plan_arg,
    tile_plan,
)
from protstruc_tpu_torch.vocab import ATOM

__all__ = ["model_features", "model_inputs", "load_library", "library_path", "LAUNCHES"]

_SOURCES = ("model_features.cu",)
_ANG_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_N, _CA, _CB = int(ATOM.N), int(ATOM.CA), int(ATOM.CB)

#: Kernel launches made by :func:`model_features` in this process.
LAUNCHES = 0


def _ratio(n_bins: int, max_dist: float) -> float:
    """``n_bins / max_dist`` rounded once to float32, as the JAX kernel's
    weakly typed Python-float product rounds it."""
    return float(np.float32(n_bins / max_dist))


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the K3 library; raises if it cannot."""
    lib = cuda_lib.load("model_features", _SOURCES)
    fn = lib.ps_model_features
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [_PlanC, ctypes.c_void_p])
    return lib


def library_path():
    """Where the K3 library is built (keyed by its source and flags)."""
    return cuda_lib.library_path("model_features", _SOURCES)


def model_features(xyz: torch.Tensor, n_bins: int = 36, max_dist: float = 20.0,
                   ang_dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(d_cb_bins (B, L, L) int32, ang_sincos (B, L, L, 6) ang_dtype)`` of
    ``xyz (B, L, A>=5, 3)``.  A CUDA tensor goes to K3, a CPU tensor to the
    plain version."""
    if ang_dtype not in _ANG_DTYPES:
        raise TypeError(f"ang_dtype must be float32 or bfloat16, got {ang_dtype}")
    if xyz.device.type == "cuda":
        return _model_features_cuda(xyz, n_bins, max_dist, ang_dtype)
    if xyz.device.type == "cpu":
        return _model_features_plain(xyz, n_bins, max_dist, ang_dtype)
    raise ValueError(f"model_features has no implementation for device {xyz.device}")


def _model_features_cuda(xyz, n_bins, max_dist, ang_dtype):
    global LAUNCHES
    _check_xyz(xyz, "model_features", max_batch=None)
    B, L, A, _ = xyz.shape
    bins = torch.empty((B, L, L), dtype=torch.int32, device=xyz.device)
    ang = torch.empty((B, L, L, 6), dtype=ang_dtype, device=xyz.device)
    if B == 0 or L == 0:
        return bins, ang
    lib = load_library()
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.ps_model_features(xyz.device.index, xyz.data_ptr(), B, L, A, n_bins,
                                _ratio(n_bins, max_dist), float(max_dist),
                                _ANG_DTYPES[ang_dtype], bins.data_ptr(), ang.data_ptr(),
                                plan_arg(tile_plan(B, L)), stream)
    if err != 0:
        raise launch_error("model_features", err)
    LAUNCHES += 1
    return bins, ang


def _sincos_dihedral(a, b, c, d, deg):
    b0, b1, b2 = _sub(a, b), _sub(c, b), _sub(d, c)
    n0, n1 = _cross(b0, b1), _cross(b2, b1)
    x = _dot(n0, n1)
    y = -torch.sqrt(_dot(b1, b1)) * _dot(n0, b2)
    r2 = x * x + y * y
    pos = r2 > 0.0
    inv = torch.rsqrt(torch.where(pos, r2, 1.0))
    ok = pos & ~deg
    return (torch.where(ok, y * inv, 0.0),
            torch.where(ok, x * inv, torch.where(deg, 1.0, 0.0)))


def _model_features_plain(xyz: torch.Tensor, n_bins: int = 36, max_dist: float = 20.0,
                          ang_dtype: torch.dtype = torch.bfloat16
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 in plain PyTorch: the kernel's formulas, pins and rounding points."""
    x = xyz.to(torch.float32)
    B, L = x.shape[:2]

    def vi(slot):  # residue i -> (B, L, 1) planes
        return tuple(x[:, :, slot, k][:, :, None] for k in range(3))

    def vj(slot):  # residue j -> (B, 1, L) planes
        return tuple(x[:, :, slot, k][:, None, :] for k in range(3))

    n_i, ca_i, cb_i = vi(_N), vi(_CA), vi(_CB)
    ca_j, cb_j = vj(_CA), vj(_CB)

    dcb = _sub(cb_i, cb_j)
    d = torch.sqrt(_dot(dcb, dcb))
    d = torch.where(torch.isnan(d), max_dist, d)
    ratio = torch.tensor(_ratio(n_bins, max_dist), dtype=torch.float32, device=x.device)
    bins = torch.clamp_max(d * ratio, float(n_bins - 1)).to(torch.int32)

    deg_o = (_eq3(ca_i, ca_j) & _eq3(cb_i, cb_j)) | _eq3(ca_j, cb_j) | _eq3(ca_i, cb_i)
    os_, oc_ = _sincos_dihedral(ca_i, cb_i, ca_j, cb_j, deg_o)
    deg_t = (_eq3(n_i, cb_i) & _eq3(ca_i, cb_j)) | _eq3(cb_i, cb_j) | _eq3(n_i, ca_i)
    ts_, tc_ = _sincos_dihedral(n_i, ca_i, cb_i, cb_j, deg_t)

    ba, bc = _sub(ca_i, cb_i), _sub(cb_j, cb_i)
    cr = _cross(ba, bc)
    s2 = _dot(cr, cr)
    dt = _dot(ba, bc)
    r2 = s2 + dt * dt
    okp = r2 > 0.0
    inv = torch.rsqrt(torch.where(okp, r2, 1.0))
    ps_ = torch.where(okp, torch.sqrt(torch.where(s2 > 0.0, s2, 0.0)) * inv, 0.0)
    pc_ = torch.where(okp, dt * inv, 0.0)

    planes = [p.expand(B, L, L) for p in (os_, oc_, ts_, tc_, ps_, pc_)]
    return bins.expand(B, L, L).contiguous(), torch.stack(planes, dim=-1).to(ang_dtype)


def model_inputs(xyz: torch.Tensor, atom_mask: torch.Tensor, n_bins: int = 36,
                 max_dist: float = 20.0, ang_dtype: torch.dtype = torch.bfloat16
                 ) -> Dict[str, torch.Tensor]:
    """The pair entries of ``featurize_for_model(fused=True)``: ``d_cb_bins``
    and ``ang_sincos`` from :func:`model_features`, and ``pair_mask``, True
    where both residues have a finite CB."""
    bins, ang = model_features(xyz, n_bins, max_dist, ang_dtype)
    cb_ok = atom_mask[:, :, _CB] & torch.isfinite(xyz[:, :, _CB]).all(-1)
    return {"d_cb_bins": bins, "ang_sincos": ang,
            "pair_mask": cb_ok[:, :, None] & cb_ok[:, None, :]}
