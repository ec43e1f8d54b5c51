"""trRosetta pair maps: the hand-written CUDA kernel (K1) and its plain version.

Port of the forward of ``protstruc_tpu/ops/pallas_pairwise.py``
(``pairwise_maps_pallas`` / ``trrosetta_features``).  One pass over
``(B, L, L)`` computes the six maps d_ca, d_cb, d_no, omega, theta, phi from
atom slots 0-4 of ``xyz (B, L, A, 3)``; the validity masks are outer products
computed outside the kernel.

:func:`pairwise_maps` dispatches on the tensor's device and nothing else: a
CUDA tensor launches the kernel in ``csrc/pair_maps.cu`` (or raises), a CPU
tensor takes :func:`_pair_maps_plain`, the same function written in plain
PyTorch (same atan2 form, same equality-based pinning, same NaN rules).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from protstruc_tpu_torch.ops import cuda_lib
from protstruc_tpu_torch.vocab import ATOM

__all__ = ["MAP_NAMES", "pairwise_maps", "trrosetta_features", "load_library"]

#: The six maps, in the order of the kernel's bitmask.
MAP_NAMES = ("d_ca", "d_cb", "d_no", "omega", "theta", "phi")
_SOURCES = ("pair_maps.cu",)

#: Kernel launches made by :func:`pairwise_maps` in this process.
LAUNCHES = 0

_N, _CA, _O, _CB = int(ATOM.N), int(ATOM.CA), int(ATOM.O), int(ATOM.CB)
_MAX_GRID_Z = 65535


def _check_maps(maps: Sequence[str]) -> Tuple[str, ...]:
    maps = tuple(maps)
    unknown = set(maps) - set(MAP_NAMES)
    if unknown:
        raise ValueError(f"unknown maps {sorted(unknown)}; valid: {MAP_NAMES}")
    return maps


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the K1 library; raises if it cannot."""
    lib = cuda_lib.load("pair_maps", _SOURCES)
    fn = lib.ps_pair_maps_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 6 + [ctypes.c_void_p])
    return lib


def pairwise_maps(xyz: torch.Tensor,
                  maps: Sequence[str] = MAP_NAMES) -> Dict[str, torch.Tensor]:
    """The requested trRosetta maps of ``xyz (B, L, A, 3)``, each ``(B, L, L)`` f32.

    A CUDA tensor goes to the K1 kernel, a CPU tensor to the plain version.
    """
    maps = _check_maps(maps)
    if xyz.device.type == "cuda":
        return _pair_maps_cuda(xyz, maps)
    if xyz.device.type == "cpu":
        return _pair_maps_plain(xyz, maps)
    raise ValueError(f"pairwise_maps has no implementation for device {xyz.device}")


def _pair_maps_cuda(xyz: torch.Tensor, maps: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    global LAUNCHES
    if xyz.dtype != torch.float32:
        raise TypeError(f"pair_maps kernel takes float32 xyz, got {xyz.dtype}")
    if xyz.dim() != 4 or xyz.shape[-1] != 3 or xyz.shape[2] < 5:
        raise ValueError(f"pair_maps kernel takes xyz (B, L, A>=5, 3), got {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError("pair_maps kernel takes a contiguous xyz")
    B, L, A, _ = xyz.shape
    if B > _MAX_GRID_Z:
        raise ValueError(f"pair_maps kernel takes B <= {_MAX_GRID_Z}, got {B}")
    outs = {k: torch.empty((B, L, L), dtype=torch.float32, device=xyz.device)
            for k in maps}
    if B == 0 or L == 0:
        return outs
    lib = load_library()
    bits = sum(1 << MAP_NAMES.index(k) for k in maps)
    ptrs = [outs[k].data_ptr() if k in outs else None for k in MAP_NAMES]
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.ps_pair_maps_f32(xyz.device.index, xyz.data_ptr(), B, L, A, bits,
                               *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"pair_maps kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return outs


# ---------------------------------------------------------------------------
# plain PyTorch version: component planes, the same formulas as the kernel
# ---------------------------------------------------------------------------


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _eq3(a, b):
    return (a[0] == b[0]) & (a[1] == b[1]) & (a[2] == b[2])


def _dist(a, b):
    d = _sub(a, b)
    return torch.sqrt(_dot(d, d))


def _dihedral(a, b, c, d):
    b0, b1, b2 = _sub(a, b), _sub(c, b), _sub(d, c)
    n0, n1 = _cross(b0, b1), _cross(b2, b1)
    x = _dot(n0, n1) + 0.0          # +0.0 turns -0 into +0 before atan2
    y = -torch.sqrt(_dot(b1, b1)) * _dot(n0, b2) + 0.0
    return torch.atan2(y, x)


def _planar_angle(a, b, c):
    ba, bc = _sub(a, b), _sub(c, b)
    cr = _cross(ba, bc)
    ang = torch.atan2(torch.sqrt(_dot(cr, cr)), _dot(ba, bc))
    zero = (_dot(bc, bc) == 0.0) | (_dot(ba, ba) == 0.0)
    return torch.where(zero, torch.nan, ang)


def _pair_maps_plain(xyz: torch.Tensor,
                     maps: Sequence[str] = MAP_NAMES) -> Dict[str, torch.Tensor]:
    """K1 in plain PyTorch: the same maps, formulas, pinning and NaN rules."""
    maps = _check_maps(maps)
    x = xyz.to(torch.float32)
    B, L = x.shape[:2]

    def vi(slot):  # residue i -> (B, L, 1) planes
        return tuple(x[:, :, slot, k][:, :, None] for k in range(3))

    def vj(slot):  # residue j -> (B, 1, L) planes
        return tuple(x[:, :, slot, k][:, None, :] for k in range(3))

    n_i, ca_i, cb_i = vi(_N), vi(_CA), vi(_CB)
    ca_j, cb_j, o_j = vj(_CA), vj(_CB), vj(_O)

    out = {}
    if "d_ca" in maps:
        out["d_ca"] = _dist(ca_i, ca_j)
    if "d_cb" in maps:
        out["d_cb"] = _dist(cb_i, cb_j)
    if "d_no" in maps:
        out["d_no"] = _dist(n_i, o_j)
    if "omega" in maps:
        deg = (_eq3(ca_i, ca_j) & _eq3(cb_i, cb_j)) | _eq3(ca_j, cb_j) | _eq3(ca_i, cb_i)
        out["omega"] = torch.where(deg, 0.0, _dihedral(ca_i, cb_i, ca_j, cb_j))
    if "theta" in maps:
        deg = (_eq3(n_i, cb_i) & _eq3(ca_i, cb_j)) | _eq3(cb_i, cb_j) | _eq3(n_i, ca_i)
        out["theta"] = torch.where(deg, 0.0, _dihedral(n_i, ca_i, cb_i, cb_j))
    if "phi" in maps:
        out["phi"] = _planar_angle(ca_i, cb_i, cb_j)
    return {k: out[k].expand(B, L, L).contiguous() for k in maps}


def trrosetta_features(xyz: torch.Tensor,
                       atom_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The full ``inter_residue_geometry`` dict through :func:`pairwise_maps`.

    The six maps come from K1 (its plain version on the CPU); the three
    distance-map masks are outer products of the atom mask.
    """
    ret = dict(pairwise_maps(xyz))
    for key, (ai, aj) in {
        "d_ca_mask": ("CA", "CA"),
        "d_cb_mask": ("CB", "CB"),
        "d_no_mask": ("N", "O"),
    }.items():
        mi = atom_mask[:, :, int(ATOM[ai])]
        mj = atom_mask[:, :, int(ATOM[aj])]
        ret[key] = mi[:, :, None] & mj[:, None, :]
    return ret
