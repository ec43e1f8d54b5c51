"""K4's, K5's, K6's and K7's schedules on the card, emulated in plain torch
and checked on the CPU.

K5 (the triangle prologue backward) and K7 (the epilogue backward),
``csrc/tri_mul.cu``, run as a rows pass with their weights resident in shared
memory, then a weight-gradient pass and two ordered reductions; K4 (the
prologue forward) is K5's forward half and K6 (the epilogue forward) K7's.
Their sums run in another order than the plain versions', and their products
on the tensor cores.  This file emulates those schedules step by step:

* rows in tiles of 16 (one warp each), the last tile ragged; tile ``i`` goes
  to warp ``i % (grid * warps)`` of the persistent grid;
* LayerNorm in f32 (fast variance), ``s`` (and K6's and K7's ``t``) cast
  to the stream dtype;
* per chunk of columns (16 in bf16, 8 in float32; K6 16 in both): the gate
  and projection products (K6: the gate and the product applied to them in
  f32, the result cast once), the gate backward in f32, ``dpre`` (K7:
  ``dpre`` and ``du``) cast to the stream dtype once; ``dsrc`` summed over
  the chunks' back-projection products in f32 (K7: ``dsrc`` then ``dt``,
  each from its cast cotangent as stored);
* bias and LayerNorm gradients as column sums per tile, summed in each
  warp's walk order, then warp by warp within a block, then block by block;
* weight gradients split over chunks of rows, 64 rows a step, the chunk
  partials reduced in chunk order.

bfloat16 products are exact in f32 (a plain f32 product of the cast
operands); float32 products are taken as 3xTF32 (``big = tf32(x)``, ``small
= tf32(x - big)``, ``a_small b_big + a_big b_small + a_big b_big``), as
tests/test_torch_flash_split.py emulates K8's, each 64-row step of the weight
gradients summed apart.  Each emulation is held to the plain version
(``_prologue_fwd_plain``, ``_prologue_bwd_plain``, ``_epilogue_fwd_plain``,
``_epilogue_bwd_plain``) and to the Pallas op in interpret mode
(``_prologue_op`` and ``_epilogue_op``, and ``jax.vjp`` of each) on a row
count ragged against every tile, at C = 16, 64 and 128: bf16 within 5e-2 of
max|ref|, f32 within 2e-5 * max(1, max|ref|) (tests/test_tri_mul.py:49-60).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.ops.tri_mul import _epilogue_op, _prologue_op
from protstruc_tpu_torch.ops import tri_mul
from protstruc_tpu_torch.ops.tri_mul import (_epilogue_bwd_plain, _epilogue_fwd_plain,
                                             _prologue_bwd_plain, _prologue_fwd_plain)

torch.set_num_threads(1)

N = 2 * 13 * 13          # 338 rows: ragged against 16-row tiles and 64-row steps
TILE, WARPS, GRID = 16, 3, 2
STEP, CHUNK_ROWS = 64, 128
EPS = 1e-6
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tf32(x):
    """float32 rounded to TF32, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b, dtype):
    """``a @ b`` of stream-dtype operands as the tensor cores take it, in f32."""
    a, b = a.float(), b.float()
    if dtype == torch.bfloat16:
        return a @ b
    a_big, b_big = _tf32(a), _tf32(b)
    return _tf32(a - a_big) @ b_big + a_big @ _tf32(b - b_big) + a_big @ b_big


def _ln(x, lns, lnb, dtype):
    mu = x.mean(-1, keepdim=True)
    inv = torch.rsqrt((x * x).mean(-1, keepdim=True) - mu * mu + EPS)
    xhat = (x - mu) * inv
    return (xhat * lns + lnb).to(dtype), xhat, inv


def _emulated_bwd(x, m, lns, lnb, wag, bag, wap, bap, wbg, bbg, wbp, bbp, da, db):
    dtype = x.dtype
    n, C = x.shape
    mats = (wag, wap, wbg, wbp)
    vecs = [v.float() for v in (lns, lnb, bag, bap, bbg, bbp)]
    dx = torch.empty_like(x)
    dpre = torch.zeros((4, n, C), dtype=dtype)
    warps = GRID * WARPS
    walk = [torch.zeros((6, C)) for _ in range(warps)]  # each warp's column sums
    for tile, r0 in enumerate(range(0, n, TILE)):
        rows = slice(r0, min(n, r0 + TILE))
        s, xhat, inv = _ln(x[rows].float(), vecs[0], vecs[1], dtype)
        mf = m[rows].float()[:, None]
        cts = (da[rows].float() * mf, db[rows].float() * mf)
        dsrc = torch.zeros((s.shape[0], C))
        sums = torch.zeros((6, C))
        width = 16 if dtype == torch.bfloat16 else 8
        for n0 in range(0, C, width):
            cols = slice(n0, n0 + width)
            for h in range(2):
                wg, wp = mats[2 * h], mats[2 * h + 1]
                sg = torch.sigmoid(_product(s, wg[:, cols], dtype) + vecs[2 + 2 * h][cols])
                pj = _product(s, wp[:, cols], dtype) + vecs[3 + 2 * h][cols]
                ct = cts[h][:, cols]
                dg, dp = ct * pj * sg * (1.0 - sg), ct * sg
                sums[2 + 2 * h, cols] = dg.sum(0)
                sums[3 + 2 * h, cols] = dp.sum(0)
                dgc, dpc = dg.to(dtype), dp.to(dtype)
                dpre[2 * h, rows, cols] = dgc
                dpre[2 * h + 1, rows, cols] = dpc
                dsrc += _product(dgc, wg[:, cols].t(), dtype)
                dsrc += _product(dpc, wp[:, cols].t(), dtype)
        dx[rows] = _ln_bwd(dsrc, xhat, inv, vecs[0]).to(dtype)
        sums[0], sums[1] = (dsrc * xhat).sum(0), dsrc.sum(0)
        walk[tile % warps] += sums
    v = _vector_grads(walk, dtype)
    w = _weight_grads([(x, vecs[0], vecs[1])] * 4, dpre)
    return (dx, v[0], v[1], w[0], v[2], w[1], v[3], w[2], v[4], w[3], v[5])


def _vector_grads(walk, dtype):
    """The warps' column sums warp by warp within a block, then block by block."""
    vec_grads = torch.zeros_like(walk[0])
    for block in range(GRID):
        block_sums = torch.zeros_like(walk[0])
        for w in range(WARPS):
            block_sums += walk[block * WARPS + w]
        vec_grads += block_sums
    return [g.to(dtype) for g in vec_grads]


def _weight_grads(sources, dpre):
    """The weight-gradient pass: job j sums LN(src_j)^T @ dpre[j] over chunks
    of rows, 64 rows a step, the chunk partials in chunk order."""
    n, C = dpre.shape[1:]
    dtype = dpre.dtype
    mat_grads = torch.zeros((len(sources), C, C))
    for c0 in range(0, n, CHUNK_ROWS):
        part = torch.zeros_like(mat_grads)
        for r0 in range(c0, min(n, c0 + CHUNK_ROWS), STEP):
            rows = slice(r0, min(n, c0 + CHUNK_ROWS, r0 + STEP))
            for j, (src, sc, bi) in enumerate(sources):
                s, _, _ = _ln(src[rows].float(), sc, bi, dtype)
                part[j] += _product(s.t(), dpre[j, rows], dtype)
        mat_grads += part
    return [g.to(dtype) for g in mat_grads]


def _ln_bwd(dsrc, xhat, inv, lns):
    dxh = dsrc * lns
    return inv * (dxh - dxh.mean(-1, keepdim=True) - xhat * (dxh * xhat).mean(-1, keepdim=True))


def _emulated_epilogue_bwd(x, p, ln1s, ln1b, wog, bog, ln2s, ln2b, wo, bo, do):
    """K7: the resident rows pass (gate backward per chunk, dpre and du cast
    once and stored, then dsrc and dt each from its stored cast cotangent,
    chunk by chunk), the weight-gradient pass and the reductions."""
    dtype = x.dtype
    n, C = x.shape
    vecs = [v.float() for v in (ln1s, ln1b, bog, ln2s, ln2b, bo)]
    dx, dp = torch.empty_like(x), torch.empty_like(p)
    dpre = torch.zeros((2, n, C), dtype=dtype)  # dpre, du
    width = 16 if dtype == torch.bfloat16 else 8
    warps = GRID * WARPS
    walk = [torch.zeros((6, C)) for _ in range(warps)]
    for tile, r0 in enumerate(range(0, n, TILE)):
        rows = slice(r0, min(n, r0 + TILE))
        s, xhat1, inv1 = _ln(x[rows].float(), vecs[0], vecs[1], dtype)
        t, xhat2, inv2 = _ln(p[rows].float(), vecs[3], vecs[4], dtype)
        dout = do[rows].float()
        sums = torch.zeros((6, C))
        for n0 in range(0, C, width):
            cols = slice(n0, n0 + width)
            g = torch.sigmoid(_product(s, wog[:, cols], dtype) + vecs[2][cols])
            u = _product(t, wo[:, cols], dtype) + vecs[5][cols]
            du, dpr = dout[:, cols] * g, dout[:, cols] * u * g * (1.0 - g)
            sums[2, cols], sums[5, cols] = dpr.sum(0), du.sum(0)
            dpre[0, rows, cols], dpre[1, rows, cols] = dpr.to(dtype), du.to(dtype)
        for k, (w, xhat, inv, lns, out) in enumerate(((wog, xhat1, inv1, vecs[0], dx),
                                                     (wo, xhat2, inv2, vecs[3], dp))):
            dsrc = torch.zeros((xhat.shape[0], C))
            for n0 in range(0, C, width):
                cols = slice(n0, n0 + width)
                dsrc += _product(dpre[k, rows, cols], w[:, cols].t(), dtype)
            out[rows] = _ln_bwd(dsrc, xhat, inv, lns).to(dtype)
            sums[3 * k], sums[3 * k + 1] = (dsrc * xhat).sum(0), dsrc.sum(0)
        walk[tile % warps] += sums
    v = _vector_grads(walk, dtype)
    w = _weight_grads([(x, vecs[0], vecs[1]), (p, vecs[3], vecs[4])], dpre)
    return (dx, dp, v[0], v[1], w[0], v[2], v[3], v[4], w[1], v[5])


def _emulated_prologue_fwd(x, m, lns, lnb, wag, bag, wap, bap, wbg, bbg, wbp, bbp):
    """K4: K5's walk and forward half, the gates and the mask per chunk."""
    dtype = x.dtype
    n, C = x.shape
    mats, biases = (wag, wap, wbg, wbp), [v.float() for v in (bag, bap, bbg, bbp)]
    out = (torch.empty_like(x), torch.empty_like(x))
    width = 16 if dtype == torch.bfloat16 else 8
    for r0 in range(0, n, TILE):
        rows = slice(r0, min(n, r0 + TILE))
        s, _, _ = _ln(x[rows].float(), lns.float(), lnb.float(), dtype)
        mf = m[rows].float()[:, None]
        for n0 in range(0, C, width):
            cols = slice(n0, n0 + width)
            for h in range(2):
                sg = torch.sigmoid(_product(s, mats[2 * h][:, cols], dtype) + biases[2 * h][cols])
                pj = _product(s, mats[2 * h + 1][:, cols], dtype) + biases[2 * h + 1][cols]
                out[h][rows, cols] = (sg * pj * mf).to(dtype)
    return out


def _emulated_epilogue_fwd(x, p, ln1s, ln1b, wog, bog, ln2s, ln2b, wo, bo):
    """K6: K7's walk and forward half, 16-column chunks in both dtypes, the
    gate and the product on each chunk's f32 pre-activations, cast once."""
    dtype = x.dtype
    n, C = x.shape
    vecs = [v.float() for v in (ln1s, ln1b, bog, ln2s, ln2b, bo)]
    out = torch.empty_like(x)
    for r0 in range(0, n, TILE):
        rows = slice(r0, min(n, r0 + TILE))
        s, _, _ = _ln(x[rows].float(), vecs[0], vecs[1], dtype)
        t, _, _ = _ln(p[rows].float(), vecs[3], vecs[4], dtype)
        for n0 in range(0, C, 16):
            cols = slice(n0, n0 + 16)
            g = torch.sigmoid(_product(s, wog[:, cols], dtype) + vecs[2][cols])
            u = _product(t, wo[:, cols], dtype) + vecs[5][cols]
            out[rows, cols] = (g * u).to(dtype)
    return out


def _inputs(C, seed):
    rng = np.random.RandomState(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (rng.randn(*shape) * scale + shift).astype(np.float32)

    mask = np.ones((2, 13), bool)
    mask[1, 9:] = False
    mask[0, 2] = False
    m = (mask[:, :, None] & mask[:, None, :]).reshape(-1).astype(np.float32)
    weights = [r(C, scale=0.2, shift=1.0), r(C, scale=0.2)]
    for _ in range(4):
        weights += [r(C, C, scale=C ** -0.5), r(C, scale=0.1)]
    return r(N, C, shift=0.3), m, weights, r(N, C), r(N, C)


def _epilogue_inputs(C, seed):
    rng = np.random.RandomState(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (rng.randn(*shape) * scale + shift).astype(np.float32)

    ln = lambda: [r(C, scale=0.2, shift=1.0), r(C, scale=0.2)]  # noqa: E731
    lin = lambda: [r(C, C, scale=C ** -0.5), r(C, scale=0.1)]  # noqa: E731
    weights = ln() + lin() + ln() + lin()  # ln1s ln1b wog bog ln2s ln2b wo bo
    return r(N, C, shift=0.3), r(N, C, scale=3.0), weights, r(N, C)


def _jax_rows(arrays, jdt):
    """numpy rows and weights as JAX arrays, vectors as (1, C) rows."""
    out = [jnp.asarray(a).astype(jdt) for a in arrays]
    return [a.reshape(1, -1) if a.ndim == 1 else a for a in out]


def _check(ref, got, dtype, name):
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, name
    err, scale = float(np.abs(ref - got).max()), float(np.abs(ref).max())
    limit = 2e-5 * max(1.0, scale) if dtype == "f32" else 5e-2 * max(scale, 1e-3)
    assert err <= limit, (name, err, limit)


NAMES = ("dx", "lns", "lnb", "wag", "bag", "wap", "bap", "wbg", "bbg", "wbp", "bbp")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_k5_schedule_matches_plain_and_jax(dtype, C):
    x, m, weights, da, db = _inputs(C, seed=C)
    tdt, jdt = DTYPES[dtype]
    tt = [torch.from_numpy(a).to(tdt) for a in (x, m, *weights, da, db)]
    got = _emulated_bwd(*tt)
    plain = _prologue_bwd_plain(*tt)

    jx = [jnp.asarray(a).astype(jdt) for a in (x, *weights)]
    jx = [a.reshape(1, -1) if a.ndim == 1 and i > 0 else a for i, a in enumerate(jx)]
    jm = jnp.asarray(m[:, None]).astype(jdt)
    _, vjp = jax.vjp(lambda x, *w: _prologue_op(128, True, x, jm, *w), *jx)
    ref = vjp((jnp.asarray(da).astype(jdt), jnp.asarray(db).astype(jdt)))

    for name, r, p, g in zip(NAMES, ref, plain, got):
        assert g.dtype == tdt and g.shape == p.shape, name
        _check(p.float().numpy(), g.float().numpy(), dtype, f"{name} vs plain")
        _check(np.asarray(jnp.asarray(r, jnp.float32)).reshape(p.shape), g.float().numpy(), dtype,
               f"{name} vs jax")


def test_backward_wrappers_hand_over_aligned_tensors():
    """K5 and K7 copy rows and weights in 16-byte pieces: their wrappers pass
    a tensor that starts off a 16-byte boundary as an aligned copy, and an
    aligned one as it is."""
    from protstruc_tpu_torch.ops.tri_mul import _aligned16

    off = torch.arange(65, dtype=torch.float32)[1:].view(8, 8)
    assert off.data_ptr() % 16 != 0
    copy = _aligned16(off)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, off)
    aligned = torch.zeros(8, 8)
    assert _aligned16(aligned) is aligned


EPI_NAMES = ("dx", "dp", "ln1s", "ln1b", "wog", "bog", "ln2s", "ln2b", "wo", "bo")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_k7_schedule_matches_plain_and_jax(dtype, C):
    x, p, weights, do = _epilogue_inputs(C, seed=100 + C)
    tdt, jdt = DTYPES[dtype]
    tt = [torch.from_numpy(a).to(tdt) for a in (x, p, *weights, do)]
    got = _emulated_epilogue_bwd(*tt)
    plain = _epilogue_bwd_plain(*tt)

    jx = _jax_rows((x, p, *weights), jdt)
    _, vjp = jax.vjp(lambda *a: _epilogue_op(128, True, *a), *jx)
    ref = vjp(jnp.asarray(do).astype(jdt))

    for name, r, pl, g in zip(EPI_NAMES, ref, plain, got):
        assert g.dtype == tdt and g.shape == pl.shape, name
        _check(pl.float().numpy(), g.float().numpy(), dtype, f"{name} vs plain")
        _check(np.asarray(jnp.asarray(r, jnp.float32)).reshape(pl.shape), g.float().numpy(), dtype,
               f"{name} vs jax")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_k4_schedule_matches_plain_and_pallas(dtype, C):
    x, m, weights, _, _ = _inputs(C, seed=200 + C)
    tdt, jdt = DTYPES[dtype]
    tt = [torch.from_numpy(a).to(tdt) for a in (x, m, *weights)]
    got = _emulated_prologue_fwd(*tt)
    plain = _prologue_fwd_plain(*tt)
    jx = _jax_rows((x, *weights), jdt)
    ref = _prologue_op(128, True, jx[0], jnp.asarray(m[:, None]).astype(jdt), *jx[1:])
    for name, r, pl, g in zip("ab", ref, plain, got):
        assert g.dtype == tdt and g.shape == pl.shape, name
        _check(pl.float().numpy(), g.float().numpy(), dtype, f"{name} vs plain")
        _check(np.asarray(jnp.asarray(r, jnp.float32)), g.float().numpy(), dtype, f"{name} vs pallas")
        assert not g[torch.from_numpy(m) == 0].any(), f"{name}: masked rows not zero"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 64, 128])
def test_k6_schedule_matches_plain_and_pallas(dtype, C):
    x, p, weights, _ = _epilogue_inputs(C, seed=300 + C)
    tdt, jdt = DTYPES[dtype]
    tt = [torch.from_numpy(a).to(tdt) for a in (x, p, *weights)]
    got = _emulated_epilogue_fwd(*tt)
    plain = _epilogue_fwd_plain(*tt)
    ref = _epilogue_op(128, True, *_jax_rows((x, p, *weights), jdt))
    assert got.dtype == tdt and got.shape == plain.shape
    _check(plain.float().numpy(), got.float().numpy(), dtype, "out vs plain")
    _check(np.asarray(jnp.asarray(ref, jnp.float32)), got.float().numpy(), dtype, "out vs pallas")


_WRAPPERS = {  # name: (CUDA wrapper, entry point, tensors the kernel takes in pieces)
    "prologue_fwd": ("_prologue_fwd_cuda", "ps_tri_prologue_fwd", "x w"),
    "prologue_bwd": ("_prologue_bwd_cuda", "ps_tri_prologue_bwd", "x w ct"),
    "epilogue_fwd": ("_epilogue_fwd_cuda", "ps_tri_epilogue_fwd", "x aux w"),
    "epilogue_bwd": ("_epilogue_bwd_cuda", "ps_tri_epilogue_bwd", "x aux w ct"),
}


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrappers_hand_over_aligned_copies(name, monkeypatch):
    """K4-K7 copy rows and weights in 16-byte pieces and read cotangents in
    pairs: each wrapper hands the library 16-byte aligned
    copies of those tensors when it is given views off a 16-byte boundary
    (the library is faked: no card here)."""
    wrapper, entry, kinds = _WRAPPERS[name]
    C = 16
    x, m, pro_w, da, db = _inputs(C, seed=7)
    _, p, epi_w, do = _epilogue_inputs(C, seed=7)
    args = {"prologue_fwd": (x, m, *pro_w), "prologue_bwd": (x, m, *pro_w, da, db),
            "epilogue_fwd": (x, p, *epi_w), "epilogue_bwd": (x, p, *epi_w, do)}[name]
    n_w = len(epi_w) if name.startswith("epilogue") else len(pro_w)

    def off(a):  # a contiguous copy that starts 4 bytes past a 16-byte boundary
        buf = torch.empty(a.size + 4, dtype=torch.float32)
        start = (-buf.data_ptr() // 4) % 4 + 1
        t = buf[start:start + a.size].view(a.shape)
        t.copy_(torch.from_numpy(a))
        return t

    given = [off(a) for a in args]
    assert all(t.data_ptr() % 16 for t in given)
    handed = []

    lib = types.SimpleNamespace(ps_tri_workspace=lambda *a: 0, **{entry: None})
    monkeypatch.setattr(tri_mul, "load_library", lambda: lib)
    monkeypatch.setattr(tri_mul, "_launch", lambda nm, fn, x, *a: handed.extend(a))
    getattr(tri_mul, wrapper)(*given)
    inputs = handed[:len(given)]
    roles = {"x": [0], "aux": [1], "w": list(range(2, 2 + n_w)),
             "ct": list(range(2 + n_w, len(given)))}
    for kind in kinds.split():
        for i in roles[kind]:
            assert inputs[i].data_ptr() % 16 == 0, (name, kind, i)
            assert torch.equal(inputs[i], given[i]), (name, kind, i)
    assert all(t.data_ptr() % 16 == 0 for t in handed[len(given):] if isinstance(t, torch.Tensor))
