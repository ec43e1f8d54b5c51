"""K5's schedule on the card, emulated in plain torch and checked on the CPU.

K5 (the triangle prologue backward, ``csrc/tri_mul.cu``) runs as a rows pass
with the four weights resident in shared memory, then a weight-gradient pass
and two ordered reductions.  Its sums run in another order than the plain
version's, and its products on the tensor cores.  This file emulates that
schedule step by step:

* rows in tiles of 16 (one warp each), the last tile ragged; tile ``i`` goes
  to warp ``i % (grid * warps)`` of the persistent grid;
* LayerNorm in f32 (fast variance), ``s`` cast to the stream dtype;
* per chunk of columns (16 in bf16, 8 in float32): the gate and projection
  products, the gate backward in f32, ``dpre`` cast to the stream dtype
  once, ``dsrc`` summed over the chunks' back-projection products in f32;
* bias and LayerNorm gradients as column sums per tile, summed in each
  warp's walk order, then warp by warp within a block, then block by block;
* weight gradients split over chunks of rows, 64 rows a step, the chunk
  partials reduced in chunk order.

bfloat16 products are exact in f32 (a plain f32 product of the cast
operands); float32 products are taken as 3xTF32 (``big = tf32(x)``, ``small
= tf32(x - big)``, ``a_small b_big + a_big b_small + a_big b_big``), as
tests/test_torch_flash_split.py emulates K8's, each 64-row step of the weight
gradients summed apart.  The emulation is held to ``_prologue_bwd_plain`` and
to ``jax.vjp`` of the Pallas ``_prologue_op`` (interpret) on a row count
ragged against every tile, at C = 16, 64 and 128: bf16 within 5e-2 of
max|ref|, f32 within 2e-5 * max(1, max|ref|) (tests/test_tri_mul.py:49-60).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.ops.tri_mul import _prologue_op
from protstruc_tpu_torch.ops.tri_mul import _prologue_bwd_plain

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
        dxh = dsrc * vecs[0]
        dx[rows] = (inv * (dxh - dxh.mean(-1, keepdim=True)
                           - xhat * (dxh * xhat).mean(-1, keepdim=True))).to(dtype)
        sums[0], sums[1] = (dsrc * xhat).sum(0), dsrc.sum(0)
        walk[tile % warps] += sums
    vec_grads = torch.zeros((6, C))
    for block in range(GRID):
        block_sums = torch.zeros((6, C))
        for w in range(WARPS):
            block_sums += walk[block * WARPS + w]
        vec_grads += block_sums
    mat_grads = torch.zeros((4, C, C))
    for c0 in range(0, n, CHUNK_ROWS):
        part = torch.zeros((4, C, C))
        for r0 in range(c0, min(n, c0 + CHUNK_ROWS), STEP):
            rows = slice(r0, min(n, c0 + CHUNK_ROWS, r0 + STEP))
            s, _, _ = _ln(x[rows].float(), vecs[0], vecs[1], dtype)
            for j in range(4):
                part[j] += _product(s.t(), dpre[j, rows], dtype)
        mat_grads += part
    v = [g.to(dtype) for g in vec_grads]
    w = [g.to(dtype) for g in mat_grads]
    return (dx, v[0], v[1], w[0], v[2], w[1], v[3], w[2], v[4], w[3], v[5])


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
