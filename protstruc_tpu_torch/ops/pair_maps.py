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
same NaN rules).  :func:`pairwise_maps_forward` is the forward alone, in
f32 or, as ``pairwise_maps_pallas(out_dtype=bfloat16)``, bf16 planes.

K1 and K3 (``ops/model_features.py``) share one tile skeleton
(``csrc/pair_maps.cuh``); :func:`tile_plan` lays out the walk that their
wrappers hand to every launch, and :func:`bwd_plan` K2's walk over the same
kind of tiles.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from protstruc_tpu_torch.ops import cuda_lib
from protstruc_tpu_torch.vocab import ATOM

__all__ = ["MAP_NAMES", "pairwise_maps", "pairwise_maps_forward", "maps_bwd", "trrosetta_features",
           "load_library", "load_bwd_library", "bwd_library_path", "tile_plan", "bwd_plan",
           "TilePlan", "LAUNCHES", "BF16_LAUNCHES", "BWD_LAUNCHES"]

#: The six maps, in the order of the kernel's bitmask.
MAP_NAMES = ("d_ca", "d_cb", "d_no", "omega", "theta", "phi")
_SOURCES = ("pair_maps.cu",)
_BWD_SOURCES = ("pair_maps_bwd.cu",)

#: K1 launches with f32 planes made by :func:`pairwise_maps` and
#: :func:`pairwise_maps_forward` in this process.
LAUNCHES = 0
#: K1 launches with bf16 planes (``pairwise_maps_forward(out_dtype=bfloat16)``).
BF16_LAUNCHES = 0
#: K2 launches made by :func:`maps_bwd` (the backward of :func:`pairwise_maps`).
BWD_LAUNCHES = 0

_N, _CA, _O, _CB = int(ATOM.N), int(ATOM.CA), int(ATOM.O), int(ATOM.CB)
_OUT_DTYPES = (torch.float32, torch.bfloat16)

#: The tile shape of K1, K2 and K3 (csrc/pair_maps.cuh): pairs a thread
#: owns along j, the tile's j and i extent, warps a block.  The kernels
#: refuse a plan of another shape (``plan_fits``).
PAIR_TILE = (4, 128, 32, 8)
_MAX_GRID = 2**31 - 1     # blocks a launch may have along x


class TilePlan(NamedTuple):
    """The walk K1, K2 and K3 take over ``(B, L, L)``: tiles of ``tile_i``
    rows by ``tile_j`` columns of one batch entry, numbered ``t = (b *
    tiles_i + ti) * tiles_j + tj``; block ``k`` of ``grid`` takes ``t = k, k
    + grid, ...``, and warp ``w`` of a block the rows ``w, w + warps, ...``
    of a tile.  In K1 and K3 lane ``l`` of every warp owns columns ``j0 +
    pairs_j * l`` and the ``pairs_j - 1`` after it; with ``vector`` every run
    of ``pairs_j`` pairs is one vector store (16 bytes in f32 and int32
    outputs and K3's 6-plane runs, 8 in bf16 planes), without it every pair
    takes scalar stores.  In K2 lane ``l`` owns columns ``j0 + l + 32 q``
    (``q < pairs_j``), each read by scalar loads, and ``vector`` is off."""

    B: int
    L: int
    pairs_j: int
    tile_j: int
    tile_i: int
    warps: int
    tiles_j: int
    tiles_i: int
    n_tiles: int
    grid: int
    vector: bool


class _PlanC(ctypes.Structure):
    """``PairPlan`` of csrc/pair_maps.cuh, the plan as the launch takes it."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("pairs_j", "tile_j", "tile_i", "warps", "tiles_j", "tiles_i", "grid", "vector")]


def tile_plan(B: int, L: int) -> TilePlan:
    """The walk K1 and K3 launch for ``xyz (B, L, ...)``: one block a tile
    (up to the grid's limit, past which a block walks several), vector
    stores when ``L`` is a multiple of ``pairs_j`` (every row then starts
    on a multiple of 4 elements and every run is whole)."""
    pairs_j, tile_j, tile_i, warps = PAIR_TILE
    tiles_j, tiles_i = -(-L // tile_j), -(-L // tile_i)
    n_tiles = B * tiles_i * tiles_j
    return TilePlan(B, L, pairs_j, tile_j, tile_i, warps, tiles_j, tiles_i, n_tiles,
                    min(n_tiles, _MAX_GRID), L % pairs_j == 0)


def bwd_plan(B: int, L: int) -> TilePlan:
    """The walk K2 launches for ``xyz (B, L, ...)``: :func:`tile_plan`
    without vector stores (K2 reads its cotangents by scalar loads, 128
    contiguous bytes a warp, and stores only partials)."""
    return tile_plan(B, L)._replace(vector=False)


def bwd_scratch(plan: TilePlan) -> Tuple[int, int]:
    """Floats of K2's partials under ``plan``: residue i's side per j-tile
    ``(B, tiles_j, 9, L)``, residue j's per i-tile ``(B, tiles_i, 9, L)``."""
    return plan.B * plan.tiles_j * 9 * plan.L, plan.B * plan.tiles_i * 9 * plan.L


def plan_arg(plan: TilePlan) -> _PlanC:
    """``plan`` as the C entries of K1 and K3 take it."""
    return _PlanC(*(int(getattr(plan, f)) for f, _ in _PlanC._fields_))


def launch_error(what: str, err: int) -> RuntimeError:
    """The error of a K1, K2 or K3 launch that returned ``err``."""
    if err == -3:
        return RuntimeError(f"{what} kernel refused its tile plan (plan_fits: a tile shape other "
                            f"than the kernel's, tiles short of L, or vector stores it cannot "
                            f"make)")
    return RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def _check_maps(maps: Sequence[str]) -> Tuple[str, ...]:
    maps = tuple(maps)
    unknown = set(maps) - set(MAP_NAMES)
    if unknown:
        raise ValueError(f"unknown maps {sorted(unknown)}; valid: {MAP_NAMES}")
    return maps


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the K1 library; raises if it cannot."""
    lib = cuda_lib.load("pair_maps", _SOURCES)
    for fn in (lib.ps_pair_maps_f32, lib.ps_pair_maps_bf16):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 6 + [_PlanC, ctypes.c_void_p])
    return lib


def load_bwd_library() -> ctypes.CDLL:
    """Build (at first use) and load the K2 library; raises if it cannot."""
    lib = cuda_lib.load("pair_maps_bwd", _BWD_SOURCES)
    fn = lib.ps_pair_maps_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 6 + [ctypes.c_void_p] * 3 + [_PlanC, ctypes.c_void_p])
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
        out = pairwise_maps_forward(xyz, maps)
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


def pairwise_maps_forward(xyz: torch.Tensor, maps: Sequence[str] = MAP_NAMES,
                          out_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The requested maps of ``xyz (B, L, A, 3)``, each ``(B, L, L)`` of
    ``out_dtype`` (float32 or bfloat16: computed in f32, rounded once to
    nearest even), with no gradient: the counterpart of
    ``pairwise_maps_pallas(out_dtype=...)``.  A CUDA tensor goes to K1, a CPU
    tensor to ``_pair_maps_plain(...)`` cast to ``out_dtype``."""
    maps = _check_maps(maps)
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if xyz.device.type == "cuda":
        return _pair_maps_cuda(xyz, maps, out_dtype)
    if xyz.device.type == "cpu":
        return {k: v.to(out_dtype) for k, v in _pair_maps_plain(xyz, maps).items()}
    raise ValueError(f"pairwise_maps has no implementation for device {xyz.device}")


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


def _pair_maps_cuda(xyz: torch.Tensor, maps: Tuple[str, ...],
                    out_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    global LAUNCHES, BF16_LAUNCHES
    _check_xyz(xyz, "pair_maps")
    B, L, A, _ = xyz.shape
    outs = {k: torch.empty((B, L, L), dtype=out_dtype, device=xyz.device) for k in maps}
    if B == 0 or L == 0:
        return outs
    lib = load_library()
    fn = lib.ps_pair_maps_f32 if out_dtype == torch.float32 else lib.ps_pair_maps_bf16
    bits = sum(1 << MAP_NAMES.index(k) for k in maps)
    ptrs = [outs[k].data_ptr() if k in outs else None for k in MAP_NAMES]
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = fn(xyz.device.index, xyz.data_ptr(), B, L, A, bits, *ptrs, plan_arg(tile_plan(B, L)), stream)
    if err != 0:
        raise launch_error("pair_maps", err)
    if out_dtype == torch.float32:
        LAUNCHES += 1
    else:
        BF16_LAUNCHES += 1
    return outs


def _check_xyz(xyz: torch.Tensor, what: str) -> None:
    if xyz.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32 xyz, got {xyz.dtype}")
    if xyz.dim() != 4 or xyz.shape[-1] != 3 or xyz.shape[2] < 5:
        raise ValueError(f"{what} kernel takes xyz (B, L, A>=5, 3), got {tuple(xyz.shape)}")
    if not xyz.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous xyz")


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
    plan = bwd_plan(B, L)
    n_i, n_j = bwd_scratch(plan)
    part_i = torch.empty(n_i, dtype=torch.float32, device=xyz.device)
    part_j = torch.empty(n_j, dtype=torch.float32, device=xyz.device)
    bits = sum(1 << MAP_NAMES.index(k) for k in gs)
    ptrs = [gs[k].data_ptr() if k in gs else None for k in MAP_NAMES]
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = lib.ps_pair_maps_bwd_f32(xyz.device.index, xyz.data_ptr(), B, L, A, bits, *ptrs,
                                   part_i.data_ptr(), part_j.data_ptr(), dxyz.data_ptr(),
                                   plan_arg(plan), stream)
    if err != 0:
        raise launch_error("pair_maps_bwd", err)
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


def _pair_contributions(x: torch.Tensor, g: Mapping[str, torch.Tensor]):
    """Each pair's contributions to dxyz, map by map in K2's order, as
    ``(side, slot, (cx, cy, cz))`` with side ``"i"`` (residue i's N, CA, CB)
    or ``"j"`` (residue j's CA, CB, O) and each component a plane that
    broadcasts to ``(B, L, L)``: the JAX package's adjoint
    (pallas_pairwise.py ``_bwd_primal``, ``_deg_masks``,
    ``_bwd_cotangents``) written out by hand.  ``x`` is f32 ``(B, L, A, 3)``,
    ``g`` the f32 cotangents of the maps present."""

    def vi(slot):  # residue i -> (B, L, 1) planes
        return tuple(x[:, :, slot, k][:, :, None] for k in range(3))

    def vj(slot):  # residue j -> (B, 1, L) planes
        return tuple(x[:, :, slot, k][:, None, :] for k in range(3))

    n_i, ca_i, cb_i = vi(_N), vi(_CA), vi(_CB)
    ca_j, cb_j, o_j = vj(_CA), vj(_CB), vj(_O)

    def pull_q(gq, u, v):
        return _scale(gq + gq, _sub(u, v))

    for k, (u, v, su, sv) in {"d_ca": (ca_i, ca_j, _CA, _CA), "d_cb": (cb_i, cb_j, _CB, _CB),
                              "d_no": (n_i, o_j, _N, _O)}.items():
        if k in g:
            c = pull_q(_d_dist(g[k], _dot(_sub(u, v), _sub(u, v))), u, v)
            yield "i", su, c
            yield "j", sv, _neg(c)
    if "omega" in g:
        deg = ((_eq3(ca_i, ca_j) & _eq3(cb_i, cb_j)) | _eq3(ca_j, cb_j) | _eq3(ca_i, cb_i)
               | _eq3(cb_i, ca_j))
        ct = _pull_dihedral(g["omega"], ca_i, cb_i, ca_j, cb_j, deg)
        yield from (("i", _CA, ct[0]), ("i", _CB, ct[1]), ("j", _CA, ct[2]), ("j", _CB, ct[3]))
    if "theta" in g:
        deg = ((_eq3(n_i, cb_i) & _eq3(ca_i, cb_j)) | _eq3(cb_i, cb_j) | _eq3(n_i, ca_i)
               | _eq3(ca_i, cb_i))
        ct = _pull_dihedral(g["theta"], n_i, ca_i, cb_i, cb_j, deg)
        yield from (("i", _N, ct[0]), ("i", _CA, ct[1]), ("i", _CB, ct[2]), ("j", _CB, ct[3]))
    if "phi" in g:
        deg = _eq3(ca_i, cb_i) | _eq3(cb_j, cb_i)
        ct = _pull_angle(g["phi"], ca_i, cb_i, cb_j, deg)
        yield from (("i", _CA, ct[0]), ("i", _CB, ct[1]), ("j", _CB, ct[2]))


def _maps_bwd_plain(xyz: torch.Tensor,
                    grads: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
    """K2 in plain PyTorch: ``dxyz (B, L, A, 3)`` in ``xyz.dtype`` from up to
    six ``(B, L, L)`` cotangents (a missing or ``None`` map contributes
    nothing).

    Each pair's contributions (:func:`_pair_contributions`) to residue i's
    N, CA, CB and residue j's CA, CB, O, summed map by map, then over j
    (i-side) and i (j-side).  Slots other than N, CA, CB, O get exact zeros;
    NaN coordinates give NaN gradients on the atoms they meet, as in the JAX
    package.
    """
    grads = {k: g for k, g in grads.items() if g is not None}
    _check_maps(grads)
    x = xyz.to(torch.float32)
    B, L, A = x.shape[:3]
    g = {k: v.to(torch.float32) for k, v in grads.items()}
    sides = {"i": {}, "j": {}}   # per pair, summed over j (i-side) and i (j-side) below
    for side, slot, v in _pair_contributions(x, g):
        acc = sides[side]
        acc[slot] = _add(acc[slot], v) if slot in acc else v

    dxyz = torch.zeros((B, L, A, 3), dtype=torch.float32, device=x.device)
    for side, dim in (("i", 2), ("j", 1)):
        for slot, v in sides[side].items():
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
