"""Triangle-multiplication kernels K4-K7: the port's plain versions vs the JAX package.

* forward: ``_prologue_fwd_plain`` / ``_epilogue_fwd_plain`` against the
  Pallas ``_prologue_op`` / ``_epilogue_op`` run with ``interpret=True`` (as
  tests/test_tri_mul.py runs them on the CPU), on a ragged row count with
  masked rows: f32 within 2e-5 abs, bf16 within 5e-2 of the largest value
  (the JAX package's own budgets, tests/test_tri_mul.py:49-60);
* backward: the port's ``autograd.Function``s on CPU tensors against
  ``jax.vjp`` of ``fused_triangle_multiplication`` (interpret) for ``dpair``
  and every param leaf, outgoing and incoming;
* the plain backward, written out in formulas, against torch autograd of
  the plain forward.

The CUDA kernels themselves run only on the card, where ``python3
chip_smoke.py`` holds each against its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.ops.tri_mul import _epilogue_op, _prologue_op
from protstruc_tpu.ops.tri_mul import fused_triangle_multiplication as jax_tri_mul
from protstruc_tpu_torch.ops import tri_mul
from protstruc_tpu_torch.ops.tri_mul import (
    _epilogue_bwd_plain,
    _epilogue_fwd_plain,
    _prologue_bwd_plain,
    _prologue_fwd_plain,
    fused_triangle_multiplication,
)

torch.set_num_threads(1)

B, L = 2, 13           # N = 338 rows: ragged against the 128-row Pallas tile
TILE = 128
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "bf16": (np.float32, torch.bfloat16, jnp.bfloat16)}
PARAM_ORDER = ("ln_in", "a_gate", "a_proj", "b_gate", "b_proj", "out_gate",
               "ln_out", "out_proj")


def _mask():
    mask = np.ones((B, L), bool)
    mask[1, L - 4:] = False
    mask[0, 2] = False
    return mask


def _inputs(C, seed=0):
    """Pair, product rows, cotangents and weights as f32 numpy arrays."""
    rng = np.random.RandomState(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (rng.randn(*shape) * scale + shift).astype(np.float32)

    params = {}
    for name in PARAM_ORDER:
        if name.startswith("ln"):
            params[name] = (r(C, scale=0.2, shift=1.0), r(C, scale=0.2))
        else:
            params[name] = (r(C, C, scale=C ** -0.5), r(C, scale=0.1))
    return {"pair": r(B, L, L, C, shift=0.3), "prod": r(B * L * L, C, scale=3.0),
            "ct_a": r(B * L * L, C), "ct_b": r(B * L * L, C), "ct": r(B, L, L, C),
            "params": params}


def _budget(ref, out, dtype, name):
    ref = np.asarray(ref, np.float32)
    out = np.asarray(out, np.float32)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    err = np.max(np.abs(ref - out)) if ref.size else 0.0
    if dtype == "f32":
        assert err <= 2e-5 * max(1.0, np.abs(ref).max()), (name, err)
    else:
        assert err <= 5e-2 * max(np.abs(ref).max(), 1e-3), (name, err)


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(DTYPES[dtype][2])


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(DTYPES[dtype][1])


def _as_f32(t):
    return np.asarray(t.float()) if isinstance(t, torch.Tensor) else np.asarray(
        jnp.asarray(t, jnp.float32))


def _prologue_args(d, conv, dtype, row_vec):
    p = d["params"]
    m2 = (_mask()[:, :, None] & _mask()[:, None, :]).reshape(-1).astype(np.float32)
    x = d["pair"].reshape(-1, d["pair"].shape[-1])
    vec = (lambda v: conv(v, dtype).reshape(1, -1)) if row_vec else (lambda v: conv(v, dtype))
    m = conv(m2[:, None] if row_vec else m2, dtype)
    w = [vec(p["ln_in"][0]), vec(p["ln_in"][1])]
    for name in ("a_gate", "a_proj", "b_gate", "b_proj"):
        w += [conv(p[name][0], dtype), vec(p[name][1])]
    return conv(x, dtype), m, w


def _epilogue_args(d, conv, dtype, row_vec):
    p = d["params"]
    vec = (lambda v: conv(v, dtype).reshape(1, -1)) if row_vec else (lambda v: conv(v, dtype))
    x = d["pair"].reshape(-1, d["pair"].shape[-1])
    w = [vec(p["ln_in"][0]), vec(p["ln_in"][1]), conv(p["out_gate"][0], dtype),
         vec(p["out_gate"][1]), vec(p["ln_out"][0]), vec(p["ln_out"][1]),
         conv(p["out_proj"][0], dtype), vec(p["out_proj"][1])]
    return conv(x, dtype), conv(d["prod"], dtype), w


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 32])
def test_prologue_fwd_matches_pallas(dtype, C):
    d = _inputs(C)
    x, m, w = _prologue_args(d, _to_jax, dtype, True)
    ref = _prologue_op(TILE, True, x, m, *w)
    xt, mt, wt = _prologue_args(d, _to_torch, dtype, False)
    out = _prologue_fwd_plain(xt, mt, *wt)
    for name, r, o in zip("ab", ref, out):
        assert o.dtype == DTYPES[dtype][1] and o.shape == (B * L * L, C)
        _budget(_as_f32(r), _as_f32(o), dtype, name)
    # masked rows are exactly zero
    m2 = (_mask()[:, :, None] & _mask()[:, None, :]).reshape(-1)
    assert not out[0][~torch.from_numpy(m2)].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", [16, 32])
def test_epilogue_fwd_matches_pallas(dtype, C):
    d = _inputs(C, seed=1)
    x, p, w = _epilogue_args(d, _to_jax, dtype, True)
    ref = _epilogue_op(TILE, True, x, p, *w)
    xt, pt, wt = _epilogue_args(d, _to_torch, dtype, False)
    out = _epilogue_fwd_plain(xt, pt, *wt)
    assert out.dtype == DTYPES[dtype][1]
    _budget(_as_f32(ref), _as_f32(out), dtype, "out")


def _jax_params(d, dtype):
    return {k: tuple(_to_jax(v, dtype) for v in d["params"][k]) for k in PARAM_ORDER}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("outgoing", [True, False])
def test_backward_matches_jax_vjp(dtype, outgoing):
    """dpair and every param leaf through the port's autograd.Functions (CPU)
    against jax.vjp of the Pallas op (interpret)."""
    C = 16
    d = _inputs(C, seed=2)
    mask = _mask()
    params = _jax_params(d, dtype)
    pair = _to_jax(d["pair"], dtype)

    def f(pair, params):
        return jax_tri_mul(pair, jnp.asarray(mask), params, outgoing=outgoing,
                           interpret=True, tile_rows=TILE)

    out_ref, vjp = jax.vjp(f, pair, params)
    dpair_ref, dparams_ref = vjp(_to_jax(d["ct"], dtype))

    pt = _to_torch(d["pair"], dtype).requires_grad_()
    prm = {k: tuple(_to_torch(v, dtype).requires_grad_() for v in d["params"][k])
           for k in PARAM_ORDER}
    out = fused_triangle_multiplication(pt, torch.from_numpy(mask), prm, outgoing)
    leaves = [pt] + [v for k in PARAM_ORDER for v in prm[k]]
    grads = torch.autograd.grad(out, leaves, _to_torch(d["ct"], dtype))

    _budget(_as_f32(out_ref), _as_f32(out.detach()), dtype, "out")
    _budget(_as_f32(dpair_ref), _as_f32(grads[0]), dtype, "dpair")
    ref_leaves = [v for k in PARAM_ORDER for v in dparams_ref[k]]
    names = [f"{k}[{i}]" for k in PARAM_ORDER for i in range(2)]
    for name, r, g in zip(names, ref_leaves, grads[1:]):
        assert g.dtype == DTYPES[dtype][1], name
        _budget(_as_f32(r), _as_f32(g), dtype, name)


def _autograd_of_plain(fn, inputs, cts):
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    return torch.autograd.grad(out, leaves, cts, allow_unused=True)


@pytest.mark.parametrize("part", ["prologue", "epilogue"])
def test_plain_backward_matches_autograd(part):
    """The formulas of the plain backward against torch autograd of the plain
    forward (f32; the mask gets no gradient)."""
    d = _inputs(16, seed=3)
    if part == "prologue":
        x, m, w = _prologue_args(d, _to_torch, "f32", False)
        cts = (_to_torch(d["ct_a"], "f32"), _to_torch(d["ct_b"], "f32"))
        got = _prologue_bwd_plain(x, m, *w, *cts)
        ref = _autograd_of_plain(lambda x, *w: _prologue_fwd_plain(x, m, *w), [x, *w], cts)
    else:
        x, p, w = _epilogue_args(d, _to_torch, "f32", False)
        cts = (_to_torch(d["ct_a"], "f32"),)
        got = _epilogue_bwd_plain(x, p, *w, *cts)
        ref = _autograd_of_plain(_epilogue_fwd_plain, [x, p, *w], cts)
    assert len(got) == len(ref)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == r.shape, i
        tol = 1e-5 * max(1.0, float(r.abs().max()))
        assert float((r - g).abs().max()) <= tol, i


def test_cpu_dispatch_counts_no_launch_and_other_devices_raise():
    d = _inputs(16, seed=4)
    x, m, w = _prologue_args(d, _to_torch, "f32", False)
    before = dict(tri_mul.LAUNCHES)
    a, b = tri_mul.prologue_fwd(x, m, *w)
    ref = _prologue_fwd_plain(x, m, *w)
    assert torch.equal(a, ref[0]) and torch.equal(b, ref[1])
    assert tri_mul.LAUNCHES == before  # CPU tensors never count as launches
    with pytest.raises(ValueError, match="no implementation for device meta"):
        tri_mul.prologue_fwd(x.to("meta"), m.to("meta"), *[t.to("meta") for t in w])
