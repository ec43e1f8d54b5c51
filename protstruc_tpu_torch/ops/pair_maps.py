"""trRosetta pair maps and their gradient: the hand-written CUDA kernels (K1,
K2) and their plain versions.

Port of ``protstruc_tpu/ops/pallas_pairwise.py`` (``pairwise_maps`` /
``pairwise_maps_pallas`` / ``trrosetta_features``).  One pass over
``(B, L, L)`` computes the six maps d_ca, d_cb, d_no, omega, theta, phi from
atom slots 0-4 of ``xyz (B, L, A, 3)``; the validity masks are outer products
computed outside the kernel.  The backward (K2, ``_maps_bwd_pallas`` in the
JAX package) takes the maps' cotangents back to ``dxyz``.

:func:`pairwise_maps` is differentiable in ``xyz`` (a
``torch.autograd.Function``, as the JAX ``custom_vjp``) and dispatches on the
tensor's device and nothing else: a CUDA tensor launches K1 forward and K2
backward (``csrc/pair_maps.cu``, ``csrc/pair_maps_bwd.cu``) or raises, a CPU
tensor takes the plain versions :func:`_pair_maps_plain` and
:func:`_maps_bwd_plain`, the same functions written in plain PyTorch (same
formulas and order of operations, same equality-based pinning and guards,
same NaN rules).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from protstruc_tpu_torch.ops import cuda_lib
from protstruc_tpu_torch.vocab import ATOM

__all__ = ["MAP_NAMES", "pairwise_maps", "maps_bwd", "trrosetta_features", "load_library",
           "load_bwd_library", "bwd_library_path", "LAUNCHES", "BWD_LAUNCHES"]

#: The six maps, in the order of the kernel's bitmask.
MAP_NAMES = ("d_ca", "d_cb", "d_no", "omega", "theta", "phi")
_SOURCES = ("pair_maps.cu",)
_BWD_SOURCES = ("pair_maps_bwd.cu",)

#: K1 launches made by :func:`pairwise_maps` in this process.
LAUNCHES = 0
#: K2 launches made by :func:`maps_bwd` (the backward of :func:`pairwise_maps`).
BWD_LAUNCHES = 0

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


def load_bwd_library() -> ctypes.CDLL:
    """Build (at first use) and load the K2 library; raises if it cannot."""
    lib = cuda_lib.load("pair_maps_bwd", _BWD_SOURCES)
    lib.ps_pair_maps_bwd_scratch.restype = None
    lib.ps_pair_maps_bwd_scratch.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_longlong),
                                             ctypes.POINTER(ctypes.c_longlong)]
    fn = lib.ps_pair_maps_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 6 + [ctypes.c_void_p] * 3 + [ctypes.c_void_p])
    return lib


def bwd_library_path():
    """Where the K2 library is built (keyed by its source and flags)."""
    return cuda_lib.library_path("pair_maps_bwd", _BWD_SOURCES)


def _on_device(xyz: torch.Tensor, what: str, cuda_fn, plain_fn):
    if xyz.device.type == "cuda":
        return cuda_fn
    if xyz.device.type == "cpu":
        return plain_fn
    raise ValueError(f"{what} has no implementation for device {xyz.device}")


class _PairMaps(torch.autograd.Function):
    """K1 forward, K2 backward (their plain versions on CPU tensors).  Saves
    ``xyz``, not the maps; an unused map's cotangent arrives as ``None`` and
    costs K2 neither a read nor its arithmetic."""

    @staticmethod
    def forward(ctx, xyz, maps):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xyz)
        ctx.maps = maps
        out = _on_device(xyz, "pairwise_maps", _pair_maps_cuda, _pair_maps_plain)(xyz, maps)
        return tuple(out[k] for k in maps)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        (xyz,) = ctx.saved_tensors
        return maps_bwd(xyz, dict(zip(ctx.maps, grads))), None


def pairwise_maps(xyz: torch.Tensor,
                  maps: Sequence[str] = MAP_NAMES) -> Dict[str, torch.Tensor]:
    """The requested trRosetta maps of ``xyz (B, L, A, 3)``, each ``(B, L, L)`` f32.

    Differentiable in ``xyz``.  A CUDA tensor goes to the K1 kernel forward
    and the K2 kernel backward, a CPU tensor to their plain versions.
    Gradients at NaN coordinates are NaN, as in the JAX package (the
    cotangent of a missing pair is 0, and 0 times NaN is NaN): mask or
    replace missing atoms upstream where a finite gradient is needed.
    """
    maps = _check_maps(maps)
    return dict(zip(maps, _PairMaps.apply(xyz, maps)))


def maps_bwd(xyz: torch.Tensor,
             grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """``dxyz (B, L, A, 3)`` in ``xyz.dtype`` from the maps' cotangents.

    ``grads`` maps names of :data:`MAP_NAMES` to ``(B, L, L)`` cotangents; a
    missing or ``None`` map contributes nothing.  A CUDA tensor goes to K2, a
    CPU tensor to :func:`_maps_bwd_plain`.
    """
    grads = {k: g for k, g in grads.items() if g is not None}
    _check_maps(grads)
    return _on_device(xyz, "maps_bwd", _maps_bwd_cuda, _maps_bwd_plain)(xyz, grads)


def _pair_maps_cuda(xyz: torch.Tensor, maps: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    global LAUNCHES
    _check_xyz(xyz, "pair_maps")
    B, L, A, _ = xyz.shape
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


def _check_xyz(xyz: torch.Tensor, what: str) -> None:
    if xyz.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32 xyz, got {xyz.dtype}")
    if xyz.dim() != 4 or xyz.shape[-1] != 3 or xyz.shape[2] < 5:
        raise ValueError(f"{what} kernel takes xyz (B, L, A>=5, 3), got {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous xyz")
    if xyz.shape[0] > _MAX_GRID_Z:
        raise ValueError(f"{what} kernel takes B <= {_MAX_GRID_Z}, got {xyz.shape[0]}")


def _maps_bwd_cuda(xyz: torch.Tensor, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    global BWD_LAUNCHES
    _check_xyz(xyz, "pair_maps_bwd")
    B, L, A, _ = xyz.shape
    gs = {}
    for k, g in grads.items():
        if g.shape != (B, L, L) or g.device != xyz.device:
            raise ValueError(f"cotangent of {k} is {tuple(g.shape)} on {g.device}; "
                             f"needs ({B}, {L}, {L}) on {xyz.device}")
        gs[k] = g.to(torch.float32).contiguous()
    dxyz = torch.empty_like(xyz)
    if not gs or B == 0 or L == 0:
        return dxyz.zero_()
    lib = load_bwd_library()
    n_i, n_j = ctypes.c_longlong(), ctypes.c_longlong()
    lib.ps_pair_maps_bwd_scratch(B, L, ctypes.byref(n_i), ctypes.byref(n_j))
    part_i = torch.empty(n_i.value, dtype=torch.float32, device=xyz.device)
    part_j = torch.empty(n_j.value, dtype=torch.float32, device=xyz.device)
    bits = sum(1 << MAP_NAMES.index(k) for k in gs)
    ptrs = [gs[k].data_ptr() if k in gs else None for k in MAP_NAMES]
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.ps_pair_maps_bwd_f32(xyz.device.index, xyz.data_ptr(), B, L, A, bits, *ptrs,
                                   part_i.data_ptr(), part_j.data_ptr(), dxyz.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pair_maps_bwd kernel launch failed with CUDA error {err}")
    BWD_LAUNCHES += 1
    return dxyz


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


def _dihedral(a, b, c, d, atan2=torch.atan2):
    b0, b1, b2 = _sub(a, b), _sub(c, b), _sub(d, c)
    n0, n1 = _cross(b0, b1), _cross(b2, b1)
    x = _dot(n0, n1) + 0.0          # +0.0 turns -0 into +0 before atan2
    y = -torch.sqrt(_dot(b1, b1)) * _dot(n0, b2) + 0.0
    return atan2(y, x)


def _planar_angle(a, b, c, atan2=torch.atan2):
    ba, bc = _sub(a, b), _sub(c, b)
    cr = _cross(ba, bc)
    ang = atan2(torch.sqrt(_dot(cr, cr)), _dot(ba, bc))
    zero = (_dot(bc, bc) == 0.0) | (_dot(ba, ba) == 0.0)
    return torch.where(zero, torch.nan, ang)


def _pair_maps_plain(xyz: torch.Tensor, maps: Sequence[str] = MAP_NAMES,
                     atan2=torch.atan2) -> Dict[str, torch.Tensor]:
    """K1 in plain PyTorch: the same maps, formulas, pinning and NaN rules.

    ``atan2`` is the roofline probes' seam (their polynomial atan2 variants,
    ``experiments/kernel_probe.py``); K1 is ``torch.atan2``."""
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
        out["omega"] = torch.where(deg, 0.0, _dihedral(ca_i, cb_i, ca_j, cb_j, atan2))
    if "theta" in maps:
        deg = (_eq3(n_i, cb_i) & _eq3(ca_i, cb_j)) | _eq3(cb_i, cb_j) | _eq3(n_i, ca_i)
        out["theta"] = torch.where(deg, 0.0, _dihedral(n_i, ca_i, cb_i, cb_j, atan2))
    if "phi" in maps:
        out["phi"] = _planar_angle(ca_i, cb_i, cb_j, atan2)
    return {k: out[k].expand(B, L, L).contiguous() for k in maps}


# ---------------------------------------------------------------------------
# plain PyTorch version of K2: the hand-written adjoint, the kernel's algebra
# ---------------------------------------------------------------------------


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _scale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def _d_dist(g, q):
    """Cotangent of a squared distance from that of the distance."""
    pos = q > 0.0
    return torch.where(pos, g * 0.5 / torch.sqrt(torch.where(pos, q, 1.0)), 0.0)


def _pull_dihedral(g, a, b, c, d, deg):
    """Cotangents of a, b, c, d from that of atan2(w / sqrt(h), x), through the
    polynomial primal x = n0 . n1, w = (n0 x n1) . b1, h = b1 . b1; every
    divide guarded twice, degenerate pairs an exact 0."""
    b0, b1, b2 = _sub(a, b), _sub(c, b), _sub(d, c)
    n0, n1 = _cross(b0, b1), _cross(b2, b1)
    m = _cross(n0, n1)
    x, w, h = _dot(n0, n1), _dot(m, b1), _dot(b1, b1)

    hpos = h > 0.0
    s = 1.0 / torch.sqrt(torch.where(hpos, h, 1.0))
    y = w * s
    denom = x * x + y * y
    ok = hpos & (denom > 0.0) & ~deg
    inv = 1.0 / torch.where(ok, denom, 1.0)
    gx = torch.where(ok, -g * y * inv, 0.0)
    gy = torch.where(ok, g * x * inv, 0.0)
    gw = gy * s
    gh = -0.5 * gy * w * s * s * s

    ct_m = _scale(gw, b1)
    ct_n0 = _add(_scale(gx, n1), _cross(n1, ct_m))
    ct_n1 = _add(_scale(gx, n0), _cross(ct_m, n0))
    ct_b1 = _add(_add(_add(_scale(gw, m), _scale(gh + gh, b1)), _cross(ct_n0, b0)),
                 _cross(ct_n1, b2))
    ct_b0 = _cross(b1, ct_n0)
    ct_b2 = _cross(b1, ct_n1)
    return ct_b0, _sub(_neg(ct_b0), ct_b1), _sub(ct_b1, ct_b2), ct_b2


def _pull_angle(g, a, b, c, deg):
    """Cotangents of a, b, c from that of the planar angle
    atan2(sqrt(s2), t), s2 = |ba x bc|^2, t = ba . bc."""
    ba, bc = _sub(a, b), _sub(c, b)
    cr = _cross(ba, bc)
    s2, t = _dot(cr, cr), _dot(ba, bc)

    s = torch.sqrt(torch.where(s2 > 0.0, s2, 0.0))
    r2 = s2 + t * t
    ok = (r2 > 0.0) & ~deg
    inv = 1.0 / torch.where(ok, r2, 1.0)
    gt = torch.where(ok, -g * s * inv, 0.0)
    gs = torch.where(ok, g * t * inv, 0.0)
    pos = (s2 > 0.0) & ~deg
    gs2 = torch.where(pos, gs * 0.5 / torch.sqrt(torch.where(pos, s2, 1.0)), 0.0)

    ct_cr = _scale(gs2 + gs2, cr)
    ct_ba = _add(_scale(gt, bc), _cross(bc, ct_cr))
    ct_bc = _add(_scale(gt, ba), _cross(ct_cr, ba))
    return ct_ba, _sub(_neg(ct_ba), ct_bc), ct_bc


def _maps_bwd_plain(xyz: torch.Tensor,
                    grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """K2 in plain PyTorch: ``dxyz (B, L, A, 3)`` in ``xyz.dtype`` from up to
    six ``(B, L, L)`` cotangents (a missing or ``None`` map contributes
    nothing).

    The JAX package's adjoint (pallas_pairwise.py ``_bwd_primal``,
    ``_deg_masks``, ``_bwd_cotangents``) written out by hand in K2's order:
    each pair's contributions to residue i's N, CA, CB and residue j's CA,
    CB, O, summed map by map, then over j (i-side) and i (j-side).  Slots
    other than N, CA, CB, O get exact zeros; NaN coordinates give NaN
    gradients on the atoms they meet, as in the JAX package.
    """
    grads = {k: g for k, g in grads.items() if g is not None}
    _check_maps(grads)
    x = xyz.to(torch.float32)
    B, L, A = x.shape[:3]
    g = {k: v.to(torch.float32) for k, v in grads.items()}

    def vi(slot):  # residue i -> (B, L, 1) planes
        return tuple(x[:, :, slot, k][:, :, None] for k in range(3))

    def vj(slot):  # residue j -> (B, 1, L) planes
        return tuple(x[:, :, slot, k][:, None, :] for k in range(3))

    n_i, ca_i, cb_i = vi(_N), vi(_CA), vi(_CB)
    ca_j, cb_j, o_j = vj(_CA), vj(_CB), vj(_O)
    ai = {_N: None, _CA: None, _CB: None}   # per pair, summed over j below
    aj = {_CA: None, _CB: None, _O: None}   # per pair, summed over i below

    def acc(side, slot, v):
        side[slot] = v if side[slot] is None else _add(side[slot], v)

    def pull_q(gq, u, v):
        return _scale(gq + gq, _sub(u, v))

    for k, (u, v, su, sv) in {"d_ca": (ca_i, ca_j, _CA, _CA), "d_cb": (cb_i, cb_j, _CB, _CB),
                              "d_no": (n_i, o_j, _N, _O)}.items():
        if k in g:
            c = pull_q(_d_dist(g[k], _dot(_sub(u, v), _sub(u, v))), u, v)
            acc(ai, su, c)
            acc(aj, sv, _neg(c))
    if "omega" in g:
        deg = ((_eq3(ca_i, ca_j) & _eq3(cb_i, cb_j)) | _eq3(ca_j, cb_j) | _eq3(ca_i, cb_i)
               | _eq3(cb_i, ca_j))
        ct = _pull_dihedral(g["omega"], ca_i, cb_i, ca_j, cb_j, deg)
        acc(ai, _CA, ct[0])
        acc(ai, _CB, ct[1])
        acc(aj, _CA, ct[2])
        acc(aj, _CB, ct[3])
    if "theta" in g:
        deg = ((_eq3(n_i, cb_i) & _eq3(ca_i, cb_j)) | _eq3(cb_i, cb_j) | _eq3(n_i, ca_i)
               | _eq3(ca_i, cb_i))
        ct = _pull_dihedral(g["theta"], n_i, ca_i, cb_i, cb_j, deg)
        acc(ai, _N, ct[0])
        acc(ai, _CA, ct[1])
        acc(ai, _CB, ct[2])
        acc(aj, _CB, ct[3])
    if "phi" in g:
        deg = _eq3(ca_i, cb_i) | _eq3(cb_j, cb_i)
        ct = _pull_angle(g["phi"], ca_i, cb_i, cb_j, deg)
        acc(ai, _CA, ct[0])
        acc(ai, _CB, ct[1])
        acc(aj, _CB, ct[2])

    dxyz = torch.zeros((B, L, A, 3), dtype=torch.float32, device=x.device)
    for side, dim in ((ai, 2), (aj, 1)):
        for slot, v in side.items():
            if v is not None:
                dxyz[:, :, slot] += torch.stack([c.expand(B, L, L).sum(dim) for c in v], -1)
    return dxyz.to(xyz.dtype)


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
