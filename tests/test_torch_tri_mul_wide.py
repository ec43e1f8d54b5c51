"""K4-K7's wide route on the card, emulated in plain torch and checked on
the CPU.

At bf16 widths C > 128 (``[mfu-peak]``'s C = 1024) ``csrc/tri_mul.cu``
runs the triangle prologue (K4 forward, K5 backward) and the epilogue (K6
forward, K7 backward) as chains of GEMM kernels instead of one rows pass.
Their sums run in another order than the plain versions'.  This file
emulates the chains step by step.  The forwards:

* the LayerNorm of every row in f32 (fast variance), cast to bf16 once into
  a plane (K6: ``s`` and ``t``);
* the gate products in 128-row x 64-column output tiles (the last row and
  column tiles ragged), both products that share the tile's columns,
  32-deep k steps accumulated in f32, then ``sigmoid(G + bg) * (P + bp)``
  (times the mask in K4) in f32, cast to bf16 once.

The backwards:

* the same LayerNorm planes (K7: ``s`` and ``t``) and gate products (bf16
  products are exact in f32; the last k step ragged where C is not a
  multiple of 32), then the gate backward on the tile, ``dpre`` (K7:
  ``dpre`` and ``du``) cast to bf16 once, and the tile's column sums of the
  f32 gradients;
* ``dsrc`` in 128 x 128 f32 tiles, one product of depth 4C (K5) over the
  four cast planes and their weights, 32 deep a step (K7: ``dsrc`` and ``dt``
  one after the other);
* the LayerNorm backward per 128-row tile, with the tile's column sums of
  ``dsrc * xhat`` and ``dsrc``;
* the weight gradients ``s^T @ dpre`` from the bf16 planes in chunks of
  rows, 64 rows a step, the chunk partials summed in chunk order;
* the row tiles' column sums summed in tile order.

Each emulation is held to the plain version (``_prologue_fwd_plain``,
``_epilogue_fwd_plain``, ``_prologue_bwd_plain``, ``_epilogue_bwd_plain``)
and to the Pallas op in interpret mode (``_prologue_op``, ``_epilogue_op``;
the backwards under ``jax.vjp``) at C = 256 and C = 144 (ragged against
the column tiles and the k steps; the forwards also at 160, ragged against
the column tiles alone) on N = 300 rows (ragged against the 128-row
tiles): every output within 5e-2 of max|ref| (tests/test_tri_mul.py:49-60).

All four also take the wide route in float32 at C > 64.  The chain is the
same with nothing cast (the planes ``s``, ``t``, ``dpre`` and ``du`` stay
f32), and the products run as 3xTF32 on 8-deep k steps (``big =
tf32(x)`` rounded to nearest by bit arithmetic on the f32 words, as the
kernels round it, ``small = x - big`` truncated to tf32, as the tensor
cores read it, ``a_small b_big + a_big b_small + a_big b_big``), each k
step's product summed apart and added in f32, the weight gradients' k
steps (8 rows) too.  A float32 stage is 16 deep,
so no width (a multiple of 16) is ragged against it.  The float32 cases
(K4-K7), at C = 256 and C = 80 (ragged against the 64-column gate tiles and
the 128-column back-projection tiles), hold every output within 2e-5 *
max(1, max|ref|) (tests/test_tri_mul.py:49); the same chain with the small
terms dropped (1xTF32) breaks that limit at C = 256.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.ops.tri_mul import _epilogue_op, _prologue_op
from protstruc_tpu_torch.ops.tri_mul import (ROUTE_LAUNCHES, ROUTES, _epilogue_bwd_plain,
                                             _epilogue_fwd_plain, _prologue_bwd_plain,
                                             _prologue_fwd_plain)

torch.set_num_threads(1)

N = 300
BM, GATE_N, BACK_N = 128, 64, 128   # row tile, gate and back-projection tile columns
WG_STEP, WG_CHUNK = 64, 192         # weight-gradient rows a step and a chunk
EPS = 1e-6


def _tf32(x):
    """float32 rounded to TF32, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """float32 truncated to TF32: the bits the tensor cores read."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _exact(a, b):
    """A product of bf16 operands: exact in f32."""
    return a.float() @ b.float()


def _3xtf32(a, b):
    """A float32 product as the tensor cores take it in 3xTF32."""
    a_big, b_big = _tf32(a), _tf32(b)
    return (_tf32_trunc(a - a_big) @ b_big + a_big @ _tf32_trunc(b - b_big)) + a_big @ b_big


def _1xtf32(a, b):
    """The same with the small terms dropped: one TF32 product."""
    return _tf32(a) @ _tf32(b)


#: the stream dtype, the depth of a k step summed apart, and its product
Mode = collections.namedtuple("Mode", "dtype kstep product")
BF16 = Mode(torch.bfloat16, 32, _exact)
F32 = Mode(torch.float32, 8, _3xtf32)
F32_1XTF32 = Mode(torch.float32, 8, _1xtf32)


def _ln(x, lns, lnb, mode=BF16):
    mu = x.mean(-1, keepdim=True)
    inv = torch.rsqrt((x * x).mean(-1, keepdim=True) - mu * mu + EPS)
    xhat = (x - mu) * inv
    return (xhat * lns + lnb).to(mode.dtype), xhat, inv


def _ksteps(a, b, mode=BF16):
    """``a @ b`` of stream-dtype operands in f32, each k step's product
    summed apart and added in f32."""
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], mode.kstep):
        acc += mode.product(a[:, k0:k0 + mode.kstep].float(), b[k0:k0 + mode.kstep].float())
    return acc


def _gate_tiles(a_gate, a_proj, w_gate, w_proj, b_gate, b_proj, mode):
    """The gate GEMM's output tiles: (row tile index, rows, columns, the
    gate's sigmoid, the projection plus its bias), all f32."""
    n, C = a_gate.shape[0], w_gate.shape[1]
    for t, r0 in enumerate(range(0, n, BM)):
        rows = slice(r0, min(n, r0 + BM))
        for n0 in range(0, C, GATE_N):
            cols = slice(n0, n0 + GATE_N)
            sg = torch.sigmoid(_ksteps(a_gate[rows], w_gate[:, cols], mode) + b_gate[cols])
            pj = _ksteps(a_proj[rows], w_proj[:, cols], mode) + b_proj[cols]
            yield t, rows, cols, sg, pj


def _gate_fwd(a_gate, a_proj, w_gate, w_proj, b_gate, b_proj, mask, mode=BF16):
    """The forward's gate GEMM: sigmoid(G + bg) (P + bp) m in f32, cast once."""
    out = torch.zeros((a_gate.shape[0], w_gate.shape[1]), dtype=mode.dtype)
    for _, rows, cols, sg, pj in _gate_tiles(a_gate, a_proj, w_gate, w_proj, b_gate, b_proj, mode):
        out[rows, cols] = (sg * pj * mask[rows, None]).to(mode.dtype)
    return out


def _gate(a_gate, a_proj, w_gate, w_proj, b_gate, b_proj, ct, mask, mode=BF16):
    """The gate GEMM with its epilogue: the gradients (gate, projection) in
    the stream dtype and the f32 column sums of each 128-row tile."""
    n, C = a_gate.shape[0], w_gate.shape[1]
    d = [torch.zeros((n, C), dtype=mode.dtype) for _ in range(2)]
    sums = torch.zeros((2, (n + BM - 1) // BM, C))
    for t, rows, cols, sg, pj in _gate_tiles(a_gate, a_proj, w_gate, w_proj, b_gate, b_proj, mode):
        ctm = ct[rows, cols].float() * mask[rows, None]
        grads = (ctm * pj * sg * (1.0 - sg), ctm * sg)
        for h, g in enumerate(grads):
            d[h][rows, cols] = g.to(mode.dtype)
            sums[h, t, cols] = g.sum(0)
    return d, sums


def _back(planes, weights, mode=BF16):
    """dsrc (f32) = sum_k planes[k] @ weights[k]^T in 128 x 128 tiles, the
    k steps running over the planes in order."""
    n, C = planes[0].shape[0], weights[0].shape[0]
    dsrc = torch.zeros((n, C))
    for r0 in range(0, n, BM):
        rows = slice(r0, min(n, r0 + BM))
        for n0 in range(0, C, BACK_N):
            cols = slice(n0, min(C, n0 + BACK_N))
            acc = torch.zeros((rows.stop - r0, cols.stop - n0))
            for p, w in zip(planes, weights):
                acc += _ksteps(p[rows], w[cols].t(), mode)
            dsrc[rows, cols] = acc
    return dsrc


def _ln_bwd(dsrc, xhat, inv, lns, mode=BF16):
    """dx (in the stream dtype) and each 128-row tile's column sums of dsrc *
    xhat and dsrc."""
    dxh = dsrc * lns
    dx = inv * (dxh - dxh.mean(-1, keepdim=True) - xhat * (dxh * xhat).mean(-1, keepdim=True))
    tiles = [slice(r0, r0 + BM) for r0 in range(0, dsrc.shape[0], BM)]
    sums = torch.stack([torch.stack([(dsrc[r] * xhat[r]).sum(0), dsrc[r].sum(0)]) for r in tiles], 1)
    return dx.to(mode.dtype), sums


def _in_tile_order(tile_sums, mode=BF16):
    """(tiles, C) partials summed tile by tile, cast once."""
    acc = torch.zeros(tile_sums.shape[-1])
    for part in tile_sums:
        acc += part
    return acc.to(mode.dtype)


def _wgrad(s, d, mode=BF16):
    """s^T @ d from the planes in steps of 64 rows (bf16: each step's product
    exact in f32; float32: each k8 step's 3xTF32 product summed apart), the
    chunks of rows summed in chunk order."""
    C = s.shape[1]
    out = torch.zeros((C, C))
    for c0 in range(0, s.shape[0], WG_CHUNK):
        part = torch.zeros((C, C))
        for r0 in range(c0, min(s.shape[0], c0 + WG_CHUNK), WG_STEP):
            rows = slice(r0, min(s.shape[0], c0 + WG_CHUNK, r0 + WG_STEP))
            step = s[rows].float().t(), d[rows].float()
            part += mode.product(*step) if mode.dtype == torch.bfloat16 else _ksteps(*step, mode)
        out += part
    return out.to(mode.dtype)


def _emulated_k4(x, m, lns, lnb, wag, bag, wap, bap, wbg, bbg, wbp, bbp, mode=BF16):
    f = lambda v: v.float()  # noqa: E731
    s, _, _ = _ln(x.float(), f(lns), f(lnb), mode)
    return tuple(_gate_fwd(s, s, wg, wp, f(bg), f(bp), m.float(), mode)
                 for wg, bg, wp, bp in ((wag, bag, wap, bap), (wbg, bbg, wbp, bbp)))


def _emulated_k6(x, p, ln1s, ln1b, wog, bog, ln2s, ln2b, wo, bo, mode=BF16):
    f = lambda v: v.float()  # noqa: E731
    s, _, _ = _ln(x.float(), f(ln1s), f(ln1b), mode)
    t, _, _ = _ln(p.float(), f(ln2s), f(ln2b), mode)
    return _gate_fwd(s, t, wog, wo, f(bog), f(bo), torch.ones(x.shape[0]), mode)


def _emulated_k5(x, m, lns, lnb, wag, bag, wap, bap, wbg, bbg, wbp, bbp, da, db, mode=BF16):
    f = lambda v: v.float()  # noqa: E731
    s, xhat, inv = _ln(x.float(), f(lns), f(lnb), mode)
    planes, vec = [], {}
    for h, (wg, bg, wp, bp, ct) in enumerate(((wag, bag, wap, bap, da), (wbg, bbg, wbp, bbp, db))):
        d, sums = _gate(s, s, wg, wp, f(bg), f(bp), ct, m.float(), mode)
        planes += d
        vec[2 + 2 * h], vec[3 + 2 * h] = sums
    dsrc = _back(planes, (wag, wap, wbg, wbp), mode)
    dx, (vec[0], vec[1]) = _ln_bwd(dsrc, xhat, inv, f(lns), mode)
    v = [_in_tile_order(vec[i], mode) for i in range(6)]
    w = [_wgrad(s, p, mode) for p in planes]
    return (dx, v[0], v[1], w[0], v[2], w[1], v[3], w[2], v[4], w[3], v[5])


def _emulated_k7(x, p, ln1s, ln1b, wog, bog, ln2s, ln2b, wo, bo, do, mode=BF16):
    f = lambda v: v.float()  # noqa: E731
    s, xhat1, inv1 = _ln(x.float(), f(ln1s), f(ln1b), mode)
    t, xhat2, inv2 = _ln(p.float(), f(ln2s), f(ln2b), mode)
    (dpre, du), (sum_pre, sum_u) = _gate(s, t, wog, wo, f(bog), f(bo), do, torch.ones(x.shape[0]),
                                         mode)
    dx, (v0, v1) = _ln_bwd(_back([dpre], [wog], mode), xhat1, inv1, f(ln1s), mode)
    dp, (v3, v4) = _ln_bwd(_back([du], [wo], mode), xhat2, inv2, f(ln2s), mode)
    v = [_in_tile_order(a, mode) for a in (v0, v1, sum_pre, v3, v4, sum_u)]
    return (dx, dp, v[0], v[1], _wgrad(s, dpre, mode), v[2], v[3], v[4], _wgrad(t, du, mode), v[5])


def _draw(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) * scale + shift for shape, scale, shift in shapes]


def _ln_shapes(C):
    return [((C,), 0.2, 1.0), ((C,), 0.2, 0.0)]


def _lin_shapes(C):
    return [((C, C), C ** -0.5, 0.0), ((C,), 0.1, 0.0)]


def _check(ref, got, name):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, name
    err, scale = float(np.abs(ref - got).max()), float(np.abs(ref).max())
    assert err <= 5e-2 * max(scale, 1e-3), (name, err, scale)


def _check_f32(ref, got, name):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, name
    err, limit = float(np.abs(ref - got).max()), 2e-5 * max(1.0, float(np.abs(ref).max()))
    assert err <= limit, (name, err, limit)


def _bf16(arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _jax(arrays, dtype=jnp.bfloat16):
    out = [jnp.asarray(a).astype(dtype) for a in arrays]
    return [a.reshape(1, -1) if a.ndim == 1 else a for a in out]


def _mask():
    """N = 3 x 10 x 10 pair rows with one masked residue's rows and columns."""
    mask = np.ones((3, 10, 10), bool)
    mask[2, 7:, :] = mask[2, :, 7:] = False
    return mask.reshape(N).astype(np.float32)


K5_NAMES = ("dx", "lns", "lnb", "wag", "bag", "wap", "bap", "wbg", "bbg", "wbp", "bbp")
K7_NAMES = ("dx", "dp", "ln1s", "ln1b", "wog", "bog", "ln2s", "ln2b", "wo", "bo")


@pytest.mark.parametrize("kernel, C", [("k5", 256), ("k7", 256), ("k5", 144), ("k7", 144)],
                         ids=["k5", "k7", "k5-C144", "k7-C144"])
def test_wide_route_matches_plain_and_pallas(kernel, C):
    if kernel == "k5":
        rows = [((N, C), 1.0, 0.3)]
        weights = _ln_shapes(C) + _lin_shapes(C) * 4
        x, *w, da, db = _draw(18, *rows, *weights, ((N, C), 1.0, 0.0), ((N, C), 1.0, 0.0))
        m = _mask()
        args = _bf16([x, m, *w, da, db])
        got, plain = _emulated_k5(*args), _prologue_bwd_plain(*args)
        jm = jnp.asarray(m[:, None]).astype(jnp.bfloat16)
        jx = _jax([x, *w])
        _, vjp = jax.vjp(lambda x, *w: _prologue_op(128, True, x, jm, *w), *jx)
        ref = vjp(tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in (da, db)))
        names = K5_NAMES
    else:
        weights = _ln_shapes(C) + _lin_shapes(C) + _ln_shapes(C) + _lin_shapes(C)
        x, p, *w, do = _draw(19, ((N, C), 1.0, 0.3), ((N, C), 3.0, 0.0), *weights, ((N, C), 1.0, 0.0))
        args = _bf16([x, p, *w, do])
        got, plain = _emulated_k7(*args), _epilogue_bwd_plain(*args)
        _, vjp = jax.vjp(lambda *a: _epilogue_op(128, True, *a), *_jax([x, p, *w]))
        ref = vjp(jnp.asarray(do).astype(jnp.bfloat16))
        names = K7_NAMES
    for name, r, pl, g in zip(names, ref, plain, got):
        assert g.dtype == torch.bfloat16 and g.shape == pl.shape, name
        _check(pl.float().numpy(), g.float().numpy(), f"{name} vs plain")
        _check(np.asarray(jnp.asarray(r, jnp.float32)).reshape(pl.shape), g.float().numpy(),
               f"{name} vs pallas")


@pytest.mark.parametrize("kernel, C, mode", [("k4", 256, BF16), ("k6", 256, BF16), ("k4", 144, BF16),
                                             ("k6", 144, BF16), ("k4", 160, BF16), ("k6", 160, BF16),
                                             ("k4", 256, F32), ("k6", 256, F32), ("k4", 80, F32),
                                             ("k6", 80, F32)],
                         ids=["k4", "k6", "k4-C144", "k6-C144", "k4-C160", "k6-C160",
                              "k4-f32", "k6-f32", "k4-f32-C80", "k6-f32-C80"])
def test_wide_forward_matches_plain_and_pallas(kernel, C, mode):
    """K4's and K6's wide chains (bf16, or float32 with f32 planes and the
    gate GEMM in 3xTF32) against the plain versions and the Pallas ops."""
    f32 = mode.dtype == torch.float32
    jdtype, check = (jnp.float32, _check_f32) if f32 else (jnp.bfloat16, _check)
    if kernel == "k4":
        x, *w = _draw(16, ((N, C), 1.0, 0.3), *_ln_shapes(C), *(_lin_shapes(C) * 4))
        m = _mask()
        args = [torch.from_numpy(a).to(mode.dtype) for a in (x, m, *w)]
        got, plain = _emulated_k4(*args, mode=mode), _prologue_fwd_plain(*args)
        jx = _jax([x, *w], jdtype)
        ref = _prologue_op(128, True, jx[0], jnp.asarray(m[:, None]).astype(jdtype), *jx[1:])
        names = "ab"
    else:
        weights = _ln_shapes(C) + _lin_shapes(C) + _ln_shapes(C) + _lin_shapes(C)
        arrays = _draw(17, ((N, C), 1.0, 0.3), ((N, C), 3.0, 0.0), *weights)
        args = [torch.from_numpy(a).to(mode.dtype) for a in arrays]
        got, plain, ref = ((_emulated_k6(*args, mode=mode),), (_epilogue_fwd_plain(*args),),
                           (_epilogue_op(128, True, *_jax(arrays, jdtype)),))
        names = ("out",)
    for name, r, pl, g in zip(names, ref, plain, got):
        assert g.dtype == mode.dtype and g.shape == pl.shape, name
        check(pl.float().numpy(), g.float().numpy(), f"{name} vs plain")
        check(np.asarray(jnp.asarray(r, jnp.float32)), g.float().numpy(), f"{name} vs pallas")
        if kernel == "k4":
            assert not g[torch.from_numpy(m) == 0].any(), f"{name}: masked rows not zero"


def _f32_inputs(kernel, C):
    """K5's (x, m, ten weights, da, db) or K7's (x, p, eight weights, do) as
    float32 arrays."""
    if kernel == "k5":
        x, *w, da, db = _draw(20, ((N, C), 1.0, 0.3), *_ln_shapes(C), *(_lin_shapes(C) * 4),
                              ((N, C), 1.0, 0.0), ((N, C), 1.0, 0.0))
        return [x, _mask(), *w, da, db]
    weights = _ln_shapes(C) + _lin_shapes(C) + _ln_shapes(C) + _lin_shapes(C)
    return _draw(21, ((N, C), 1.0, 0.3), ((N, C), 3.0, 0.0), *weights, ((N, C), 1.0, 0.0))


@pytest.mark.parametrize("kernel, C", [("k5", 256), ("k7", 256), ("k5", 80), ("k7", 80)],
                         ids=["k5-f32", "k7-f32", "k5-f32-C80", "k7-f32-C80"])
def test_wide_route_f32_matches_plain_and_pallas(kernel, C):
    arrays = _f32_inputs(kernel, C)
    args = [torch.from_numpy(a) for a in arrays]
    if kernel == "k5":
        got, plain = _emulated_k5(*args, mode=F32), _prologue_bwd_plain(*args)
        x, m, *w, da, db = arrays
        jm = jnp.asarray(m[:, None])
        _, vjp = jax.vjp(lambda x, *w: _prologue_op(128, True, x, jm, *w), *_jax([x, *w], jnp.float32))
        ref = vjp((jnp.asarray(da), jnp.asarray(db)))
        names = K5_NAMES
    else:
        got, plain = _emulated_k7(*args, mode=F32), _epilogue_bwd_plain(*args)
        _, vjp = jax.vjp(lambda *a: _epilogue_op(128, True, *a), *_jax(arrays[:-1], jnp.float32))
        ref = vjp(jnp.asarray(arrays[-1]))
        names = K7_NAMES
    for name, r, pl, g in zip(names, ref, plain, got):
        assert g.dtype == torch.float32 and g.shape == pl.shape, name
        _check_f32(pl.numpy(), g.numpy(), f"{name} vs plain")
        _check_f32(np.asarray(r).reshape(pl.shape), g.numpy(), f"{name} vs pallas")


def test_wide_route_f32_limit_needs_3xtf32():
    """The f32 limit has teeth: K5's wide chain with the small terms dropped
    (one TF32 product a step) breaks 2e-5 * max(1, max|ref|) against the
    plain version at C = 256."""
    args = [torch.from_numpy(a) for a in _f32_inputs("k5", 256)]
    got, plain = _emulated_k5(*args, mode=F32_1XTF32), _prologue_bwd_plain(*args)
    worst = max(float((p - g).abs().max()) / (2e-5 * max(1.0, float(p.abs().max())))
                for p, g in zip(plain, got))
    assert worst > 1.0, worst


def test_route_counters_name_every_route():
    """K4-K7 count launches by resident and wide: every kernel has a
    resident route (bf16 C <= 128, float32 C <= 64) and a wide one above
    those widths, in both dtypes; there is no third route."""
    assert ROUTES == ("resident", "wide")
    for name, counts in ROUTE_LAUNCHES.items():
        assert tuple(counts) == ROUTES, name
