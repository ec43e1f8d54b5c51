"""Fused triangle multiplication: the Hopper kernels K4-K7 and their plain versions.

Port of ``protstruc_tpu/ops/tri_mul.py``.  The AF2 triangle multiplicative
update runs as two fused streaming passes over the ``(N, C)`` pair rows
(``N = B*L*L``) around a plain batched contraction:

* **prologue** (K4 forward, K5 backward): ``src = LayerNorm(x)`` in f32, then
  ``a = sigmoid(s @ Wag + bag) * (s @ Wap + bap) * m`` and ``b`` likewise,
  with ``s = src`` cast to the stream dtype;
* **contraction**: ``einsum('bikc,bjkc->bijc')`` (outgoing) or
  ``'bkic,bkjc->bijc'`` (incoming), left to ``torch.einsum`` as the JAX
  package leaves it to XLA;
* **epilogue** (K6 forward, K7 backward):
  ``sigmoid(LN1(x) @ Wog + bog) * (LN2(prod) @ Wo + bo)``.

Each pass is a ``torch.autograd.Function`` whose backward is a kernel too.
The wrappers dispatch on the tensor's device and nothing else: a CUDA tensor
launches the kernel in ``csrc/tri_mul.cu`` (or raises), a CPU tensor takes
the plain version below, a transcription of the Pallas body with the same
rounding points (LayerNorm statistics in f32 in the fast-variance form, the
product input cast to the stream dtype, f32 accumulation with the bias added
in f32, the backward's ``dpre`` cast to the stream dtype before the
back-projection and the weight-gradient product, weight gradients summed in
f32 and then cast to the weight dtype).  The plain backward is written out in
formulas, not taken by autograd of the forward.

The kernels take any width C >= 1, as the Pallas kernels do.  Their tiles
work on ``padded_width(C) = round_up(C, 16)``: at a ragged C the CUDA wrappers
stage the rows, weights and cotangents into zero-padded copies that wide,
pass the logical C (the LayerNorms' divisor) to the library, and cut the
outputs back to C; at a multiple of 16 they pass the tensors as they are.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from protstruc_tpu_torch.ops import cuda_lib

__all__ = ["fused_triangle_multiplication", "tri_prod", "in_tri_prod", "prologue_fwd", "prologue_bwd",
           "epilogue_fwd", "epilogue_bwd", "KERNELS", "LAUNCHES", "ROUTE_LAUNCHES", "ROUTES", "route",
           "load_library", "library_path", "padded_width"]

_EPS = 1e-6  # flax.linen.LayerNorm default
_SOURCES = ("tri_mul.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ERR_UNSUPPORTED_C = -1

#: Kernel launches made by the CUDA wrappers in this process, per kernel
#: (K4 prologue_fwd, K5 prologue_bwd, K6 epilogue_fwd, K7 epilogue_bwd).
LAUNCHES: Dict[str, int] = {"prologue_fwd": 0, "prologue_bwd": 0,
                            "epilogue_fwd": 0, "epilogue_bwd": 0}

#: Workspace kinds of ``ps_tri_workspace``, one per kernel.
_KIND = {"prologue_fwd": 0, "prologue_bwd": 1, "epilogue_fwd": 2, "epilogue_bwd": 3}

#: The rows passes of ``ps_tri_route``, by its code: weights resident in
#: shared memory (bf16 C <= 128, float32 C <= 64), or the wide route's
#: chain of GEMM kernels above those widths (every kernel, both dtypes).
ROUTES = ("resident", "wide")

#: The launches of ``LAUNCHES`` split by the route each took.
ROUTE_LAUNCHES: Dict[str, Dict[str, int]] = {name: dict.fromkeys(ROUTES, 0) for name in _KIND}


# ---------------------------------------------------------------------------
# plain PyTorch versions (the Pallas bodies, tri_mul.py:57-99, 107-167, 267-317)
# ---------------------------------------------------------------------------


def _ln_f32(x, scale, bias):
    """f32 LayerNorm over the last axis: (y, xhat, inv_sigma), fast variance."""
    mu = x.mean(-1, keepdim=True)
    var = (x * x).mean(-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var + _EPS)
    xhat = (x - mu) * inv
    return xhat * scale.float() + bias.float(), xhat, inv


def _ln_bwd(dsrc, xhat, inv, scale):
    """d LayerNorm / d x, given the cotangent of its output."""
    dxh = dsrc * scale.float()
    mean_dxh = dxh.mean(-1, keepdim=True)
    mean_dxh_xh = (dxh * xhat).mean(-1, keepdim=True)
    return inv * (dxh - mean_dxh - xhat * mean_dxh_xh)


def _dot(s, w, b):
    """(R, C) @ (C, C) + (C,): stream-dtype operands, f32 products and sum."""
    return s.float() @ w.float() + b.float()


def _dot_t(dpre, w, cd):
    """(R, C) @ (C, C)^T with ``dpre`` cast to the stream dtype first."""
    return dpre.to(cd).float() @ w.float().t()


def _dot_acc(s, dpre, cd):
    """(C, C) = s^T @ dpre, ``dpre`` cast to the stream dtype first."""
    return s.float().t() @ dpre.to(cd).float()


def _cast(grads, weights):
    return tuple(g.to(w.dtype) for g, w in zip(grads, weights))


def _prologue_fwd_plain(x, m, lns, lnb, wag, bag, wap, bap, wbg, bbg, wbp, bbp):
    src, _, _ = _ln_f32(x.float(), lns, lnb)
    s = src.to(x.dtype)
    mf = m.float()[:, None]
    a = torch.sigmoid(_dot(s, wag, bag)) * _dot(s, wap, bap)
    b = torch.sigmoid(_dot(s, wbg, bbg)) * _dot(s, wbp, bbp)
    return (a * mf).to(x.dtype), (b * mf).to(x.dtype)


def _prologue_bwd_plain(x, m, lns, lnb, wag, bag, wap, bap, wbg, bbg, wbp, bbp,
                        da, db):
    """Returns ``dx`` and the gradients of lns, lnb, wag, bag, ..., bbp, summed
    in f32 and cast to each weight's dtype."""
    cd = x.dtype
    src, xhat, inv = _ln_f32(x.float(), lns, lnb)
    s = src.to(cd)
    mf = m.float()[:, None]
    ap, bp = _dot(s, wap, bap), _dot(s, wbp, bbp)
    sa, sb = torch.sigmoid(_dot(s, wag, bag)), torch.sigmoid(_dot(s, wbg, bbg))
    da = da.float() * mf
    db = db.float() * mf
    dap = da * sa
    dag = da * ap * sa * (1.0 - sa)
    dbp = db * sb
    dbg = db * bp * sb * (1.0 - sb)
    dsrc = (_dot_t(dag, wag, cd) + _dot_t(dap, wap, cd)
            + _dot_t(dbg, wbg, cd) + _dot_t(dbp, wbp, cd))
    dx = _ln_bwd(dsrc, xhat, inv, lns).to(cd)
    grads = ((dsrc * xhat).sum(0), dsrc.sum(0),
             _dot_acc(s, dag, cd), dag.sum(0), _dot_acc(s, dap, cd), dap.sum(0),
             _dot_acc(s, dbg, cd), dbg.sum(0), _dot_acc(s, dbp, cd), dbp.sum(0))
    return (dx,) + _cast(grads, (lns, lnb, wag, bag, wap, bap, wbg, bbg, wbp, bbp))


def _epilogue_fwd_plain(x, p, ln1s, ln1b, wog, bog, ln2s, ln2b, wo, bo):
    src, _, _ = _ln_f32(x.float(), ln1s, ln1b)
    g = torch.sigmoid(_dot(src.to(x.dtype), wog, bog))
    t, _, _ = _ln_f32(p.float(), ln2s, ln2b)
    u = _dot(t.to(p.dtype), wo, bo)
    return (g * u).to(x.dtype)


def _epilogue_bwd_plain(x, p, ln1s, ln1b, wog, bog, ln2s, ln2b, wo, bo, do):
    """Returns ``dx, dp`` and the gradients of ln1s, ln1b, wog, bog, ln2s,
    ln2b, wo, bo, summed in f32 and cast to each weight's dtype."""
    cd = x.dtype
    src, xhat1, inv1 = _ln_f32(x.float(), ln1s, ln1b)
    s = src.to(cd)
    g = torch.sigmoid(_dot(s, wog, bog))
    t, xhat2, inv2 = _ln_f32(p.float(), ln2s, ln2b)
    tc = t.to(cd)
    u = _dot(tc, wo, bo)
    do = do.float()
    du = do * g
    dpre = do * u * g * (1.0 - g)
    dsrc = _dot_t(dpre, wog, cd)
    dt = _dot_t(du, wo, cd)
    grads = ((dsrc * xhat1).sum(0), dsrc.sum(0), _dot_acc(s, dpre, cd), dpre.sum(0),
             (dt * xhat2).sum(0), dt.sum(0), _dot_acc(tc, du, cd), du.sum(0))
    return (_ln_bwd(dsrc, xhat1, inv1, ln1s).to(cd), _ln_bwd(dt, xhat2, inv2, ln2s).to(cd)
            ) + _cast(grads, (ln1s, ln1b, wog, bog, ln2s, ln2b, wo, bo))


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/tri_mul.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the K4-K7 library; raises if it cannot."""
    lib = cuda_lib.load("tri_mul", _SOURCES, cuda_lib.NVCC_FLAGS_FMA)
    lib.ps_tri_workspace.restype = _I
    lib.ps_tri_workspace.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)]
    lib.ps_tri_route.restype = _I
    lib.ps_tri_route.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_I)]
    head = [_I, _I, _I, _I]  # device, dtype, N, C
    for name, n_ptrs in (("ps_tri_prologue_fwd", 15), ("ps_tri_prologue_bwd", 19),
                         ("ps_tri_epilogue_fwd", 12), ("ps_tri_epilogue_bwd", 17)):
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = head + [_P] * n_ptrs + [_P]  # ... pointers, stream
    return lib


def library_path():
    """Where the K4-K7 library is built (keyed by its sources and flags)."""
    return cuda_lib.library_path("tri_mul", _SOURCES, cuda_lib.NVCC_FLAGS_FMA)


def _check(name, x, tensors, shapes):
    """Device, dtype, shape and contiguity checks before any pointer is passed."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 rows, got {x.dtype}")
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        if t.device != x.device:
            raise ValueError(f"{name}: argument {i} is on {t.device}, rows on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: argument {i} is {t.dtype}, rows are {x.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: argument {i} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")


def _rc_check(rc, what, C, dtype):
    if rc == _ERR_UNSUPPORTED_C:
        raise ValueError(f"the tri_mul kernels do not support C={C} in {dtype} "
                         "(their tiles do not fit in shared memory)")
    if rc != 0:
        raise RuntimeError(f"{what} failed with code {rc}")


def padded_width(C: int) -> int:
    """The width K4-K7's tiles work on: ``round_up(C, 16)``; the route is
    read at it (``ps_tri_route``)."""
    return -(-C // 16) * 16


def _staged(t, kind, C):
    """``t`` zero-padded from width ``C`` to :func:`padded_width`: rows
    (``kind`` "r", ``(N, C)``) and vectors ("v") in their last dim, matrices
    ("m", ``(C, C)``) in both; ``t`` itself at a multiple of 16."""
    pad = padded_width(C) - C
    if not pad:
        return t
    return torch.nn.functional.pad(t, (0, pad, 0, pad) if kind == "m" else (0, pad))


def _cut(t, C):
    """The first ``C`` columns of a padded output (rows, vectors) and, of a
    ``(.., Cp, Cp)`` one, its ``C x C`` corner; ``t`` itself at Cp = C."""
    if t.shape[-1] == C:
        return t
    return t[..., :C, :C] if t.dim() == 3 else t[..., :C]


def _workspace(name, x):
    """The f32 scratch that kernel ``name`` needs for ``x``, on its device, or
    None where it needs none (a forward off the wide route)."""
    floats = _workspace_floats(name, x.dtype, *x.shape, x.device.index)
    return torch.empty((floats,), dtype=torch.float32, device=x.device) if floats else None


@functools.lru_cache(maxsize=None)
def _workspace_floats(name, dtype, N, C, device_index):
    """``ps_tri_workspace``: a function of the kernel, the dtype, N, C and the
    device (its SM count), so it is asked once for each."""
    out = ctypes.c_longlong(0)
    rc = load_library().ps_tri_workspace(device_index, _KIND[name], _DTYPES[dtype], N, C,
                                         ctypes.byref(out))
    _rc_check(rc, "ps_tri_workspace", C, dtype)
    return out.value


def route(name, x) -> str:
    """The rows pass kernel ``name`` takes for CUDA rows ``x (N, C)``:
    "resident" or "wide" (``ps_tri_route``: a function of the
    kernel, the dtype and C, read at ``padded_width(C)``, so it is asked
    once for each)."""
    return _route(name, x.dtype, x.shape[1], x.device.index)


@functools.lru_cache(maxsize=None)
def _route(name, dtype, C, device_index):
    code = _I(-1)
    rc = load_library().ps_tri_route(device_index, _KIND[name], _DTYPES[dtype], 0, C,
                                     ctypes.byref(code))
    if rc != 0:
        raise RuntimeError(f"ps_tri_route for {name} at C={C} in {dtype} failed with code {rc}")
    return ROUTES[code.value]


def _launch(name, fn, x, *args):
    """Launch kernel ``name`` on ``x``'s stream: ``x (N, C)`` the caller's
    rows, which give N and the logical C; ``args`` the tensors the kernel
    reads and writes, each :func:`padded_width` wide (the library checks C
    first; no kernel starts, and nothing is counted, at N = 0)."""
    N, C = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(x.device.index, _DTYPES[x.dtype], N, C, *ptrs, stream)
    _rc_check(rc, f"tri_mul {name} kernel launch", C, x.dtype)
    if N:
        LAUNCHES[name] += 1
        ROUTE_LAUNCHES[name][route(name, x)] += 1


def _weight_shapes(C, kinds):
    return [(C, C) if k == "m" else (C,) for k in kinds]


_PRO_W = "vvmvmvmvmv"   # lns lnb wag bag wap bap wbg bbg wbp bbp
_EPI_W = "vvmvvvmv"     # ln1s ln1b wog bog ln2s ln2b wo bo


def _prologue_fwd_cuda(x, m, *w):
    N, C = x.shape
    _check("prologue_fwd", x, [x, m, *w], [(N, C), (N,)] + _weight_shapes(C, _PRO_W))
    (xs,), w = _stage_rows(C, x), _stage_weights(C, w, _PRO_W)
    lib = load_library()
    ws = _workspace("prologue_fwd", x)
    a, b = torch.empty_like(xs), torch.empty_like(xs)
    _launch("prologue_fwd", lib.ps_tri_prologue_fwd, x, xs, m, *w, a, b, ws)
    return _cut(a, C), _cut(b, C)


def _aligned16(t):
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary: K4-K7 copy rows and weights in 16-byte pieces and read
    cotangents in pairs."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stage_rows(C, *rows):
    """Rows (and cotangents) as the kernels take them: 16-byte aligned and,
    at a ragged C, zero-padded copies :func:`padded_width` wide (fresh, so
    aligned)."""
    if C % 16 == 0:
        return [_aligned16(t) for t in rows]
    return [_staged(t, "r", C) for t in rows]


def _stage_weights(C, w, kinds):
    if C % 16 == 0:
        return [_aligned16(t) for t in w]
    return [_staged(t, k, C) for t, k in zip(w, kinds)]


def _prologue_bwd_cuda(x, m, *rest):
    N, C = x.shape
    w, da, db = rest[:10], rest[10], rest[11]
    _check("prologue_bwd", x, [x, m, *w, da, db],
           [(N, C), (N,)] + _weight_shapes(C, _PRO_W) + [(N, C), (N, C)])
    xs, da, db = _stage_rows(C, x, da, db)
    w = _stage_weights(C, w, _PRO_W)
    lib = load_library()
    ws = _workspace("prologue_bwd", x)
    Cp = xs.shape[1]
    dx = torch.empty_like(xs)
    dvec = torch.zeros((6, Cp), dtype=x.dtype, device=x.device)
    dmat = torch.zeros((4, Cp, Cp), dtype=x.dtype, device=x.device)
    dpre = torch.empty((4, N, Cp), dtype=x.dtype, device=x.device)
    _launch("prologue_bwd", lib.ps_tri_prologue_bwd, x, xs, m, *w, da, db,
            dx, dvec, dmat, dpre, ws)
    dx, dvec, dmat = _cut(dx, C), _cut(dvec, C), _cut(dmat, C)
    return (dx, dvec[0], dvec[1], dmat[0], dvec[2], dmat[1], dvec[3],
            dmat[2], dvec[4], dmat[3], dvec[5])


def _epilogue_fwd_cuda(x, p, *w):
    N, C = x.shape
    _check("epilogue_fwd", x, [x, p, *w], [(N, C), (N, C)] + _weight_shapes(C, _EPI_W))
    xs, p = _stage_rows(C, x, p)
    w = _stage_weights(C, w, _EPI_W)
    lib = load_library()
    ws = _workspace("epilogue_fwd", x)
    out = torch.empty_like(xs)
    _launch("epilogue_fwd", lib.ps_tri_epilogue_fwd, x, xs, p, *w, out, ws)
    return _cut(out, C)


def _epilogue_bwd_cuda(x, p, *rest):
    N, C = x.shape
    w, do = rest[:8], rest[8]
    _check("epilogue_bwd", x, [x, p, *w, do],
           [(N, C), (N, C)] + _weight_shapes(C, _EPI_W) + [(N, C)])
    xs, p, do = _stage_rows(C, x, p, do)
    w = _stage_weights(C, w, _EPI_W)
    lib = load_library()
    ws = _workspace("epilogue_bwd", x)
    Cp = xs.shape[1]
    dx, dp = torch.empty_like(xs), torch.empty_like(xs)
    dvec = torch.zeros((6, Cp), dtype=x.dtype, device=x.device)
    dmat = torch.zeros((2, Cp, Cp), dtype=x.dtype, device=x.device)
    dpre = torch.empty((2, N, Cp), dtype=x.dtype, device=x.device)
    _launch("epilogue_bwd", lib.ps_tri_epilogue_bwd, x, xs, p, *w, do,
            dx, dp, dvec, dmat, dpre, ws)
    dx, dp, dvec, dmat = _cut(dx, C), _cut(dp, C), _cut(dvec, C), _cut(dmat, C)
    return (dx, dp, dvec[0], dvec[1], dmat[0], dvec[2], dvec[3], dvec[4],
            dmat[1], dvec[5])


# ---------------------------------------------------------------------------
# device dispatch
# ---------------------------------------------------------------------------


def _on_device(name, x, cuda_fn, plain_fn):
    if x.device.type == "cuda":
        return cuda_fn
    if x.device.type == "cpu":
        return plain_fn
    raise ValueError(f"tri_mul {name} has no implementation for device {x.device}")


def prologue_fwd(x, m, *weights) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: rows ``x (N, C)`` and mask ``m (N,)`` -> gated, masked ``(a, b)``.

    ``weights``: lns, lnb ``(C,)``; then (kernel ``(C, C)``, bias ``(C,)``)
    for a_gate, a_proj, b_gate, b_proj; all in ``x``'s dtype.
    """
    fn = _on_device("prologue_fwd", x, _prologue_fwd_cuda, _prologue_fwd_plain)
    return fn(x, m, *weights)


def prologue_bwd(x, m, *weights_and_cts):
    """K5: ``dx`` and the gradients of the ten prologue weights (in their
    dtype), given K4's inputs and the cotangents ``da, db``."""
    fn = _on_device("prologue_bwd", x, _prologue_bwd_cuda, _prologue_bwd_plain)
    return fn(x, m, *weights_and_cts)


def epilogue_fwd(x, p, *weights) -> torch.Tensor:
    """K6: pair rows ``x`` and product rows ``p (N, C)`` -> ``g * u``.

    ``weights``: ln1s, ln1b, wog, bog, ln2s, ln2b, wo, bo in ``x``'s dtype.
    """
    fn = _on_device("epilogue_fwd", x, _epilogue_fwd_cuda, _epilogue_fwd_plain)
    return fn(x, p, *weights)


def epilogue_bwd(x, p, *weights_and_ct):
    """K7: ``dx, dp`` and the gradients of the eight epilogue weights, given
    K6's inputs and the cotangent ``do``."""
    fn = _on_device("epilogue_bwd", x, _epilogue_bwd_cuda, _epilogue_bwd_plain)
    return fn(x, p, *weights_and_ct)


#: name -> (kernel wrapper, plain version); the plain versions run on any device.
KERNELS = {
    "prologue_fwd": (prologue_fwd, _prologue_fwd_plain),
    "prologue_bwd": (prologue_bwd, _prologue_bwd_plain),
    "epilogue_fwd": (epilogue_fwd, _epilogue_fwd_plain),
    "epilogue_bwd": (epilogue_bwd, _epilogue_bwd_plain),
}


class _Prologue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m, *weights):
        ctx.save_for_backward(x, m, *weights)
        return prologue_fwd(x, m, *weights)

    @staticmethod
    def backward(ctx, da, db):
        x, m, *weights = ctx.saved_tensors
        dx, *grads = prologue_bwd(x, m, *weights, da.contiguous(), db.contiguous())
        return (dx, None, *grads)  # the mask's gradient is zero


class _Epilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, *weights):
        ctx.save_for_backward(x, p, *weights)
        return epilogue_fwd(x, p, *weights)

    @staticmethod
    def backward(ctx, do):
        x, p, *weights = ctx.saved_tensors
        return epilogue_bwd(x, p, *weights, do.contiguous())


_IN_TRI_PROD = 0


def in_tri_prod() -> bool:
    """Whether the caller is inside :func:`tri_prod` (``remat_policy="tri_dots"``
    saves the batched product issued there)."""
    return _IN_TRI_PROD > 0


def tri_prod(a, b, outgoing: bool = True):
    """The triangle contraction over the third residue, ``(B, L, L, C)``:
    ``sum_k a_ik b_jk`` (outgoing) or ``sum_k a_ki b_kj`` (incoming), one
    batched product over (b, c).  The JAX package names its output
    ``tri_prod`` for its remat policy; here the product runs inside a named
    scope that the ``tri_dots`` selective-checkpoint policy reads
    (``models/trfold.py``), since a bare ``bmm`` is also what the attention
    einsums issue."""
    global _IN_TRI_PROD
    eq = "bikc,bjkc->bijc" if outgoing else "bkic,bkjc->bijc"
    _IN_TRI_PROD += 1
    try:
        return torch.einsum(eq, a, b)
    finally:
        _IN_TRI_PROD -= 1


def fused_triangle_multiplication(pair, mask, params, outgoing=True, col_mask=None,
                                  contract=None):
    """AF2 triangle multiplicative update through the fused kernels.

    ``pair``: ``(B, L, L, C)`` in the compute dtype; ``mask``: ``(B, L)``
    bool; ``params``: the TriangleMultiplication leaves already cast to the
    compute dtype -- ``ln_in``/``ln_out``: (scale, bias); ``a_gate``,
    ``a_proj``, ``b_gate``, ``b_proj``, ``out_gate``, ``out_proj``: (kernel
    ``(C, C)`` as ``(in, out)``, bias).  Returns ``g * update`` with pair's
    shape and dtype (the caller adds the residual).  Differentiable through
    both kernels' hand-written backwards.

    A block of rows: ``pair`` ``(B, Li, L, C)`` (this rank's rows of a
    sequence-parallel pair), ``mask`` ``(B, Li)`` the rows' mask and
    ``col_mask`` ``(B, L)`` the columns' (default: ``mask``, the square
    call).  K4-K7 work row by row over the ``(B*Li*L, C)`` rows, so a block
    runs the same kernels; ``contract(a, b)`` replaces the contraction
    (default :func:`tri_prod` in the direction given), e.g. one that gathers
    ``b`` over the ranks (outgoing) or reduce-scatters the partial product
    over local k (incoming), and must return ``(B, Li, L, C)``.
    """
    B, L, L2, C = pair.shape
    N = B * L * L2
    x = pair.reshape(N, C).contiguous()
    cols = mask if col_mask is None else col_mask
    m = (mask[:, :, None] & cols[:, None, :]).to(pair.dtype).reshape(N)
    ln_in_s, ln_in_b = params["ln_in"]
    a, b = _Prologue.apply(x, m, ln_in_s, ln_in_b,
                           *params["a_gate"], *params["a_proj"],
                           *params["b_gate"], *params["b_proj"])
    a = a.view(B, L, L2, C)
    b = b.view(B, L, L2, C)
    prod = tri_prod(a, b, outgoing) if contract is None else contract(a, b)
    prod = prod.reshape(N, C).contiguous()
    out = _Epilogue.apply(x, prod, ln_in_s, ln_in_b, *params["out_gate"],
                          *params["ln_out"], *params["out_proj"])
    return out.view(B, L, L2, C)
