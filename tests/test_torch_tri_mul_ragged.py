"""K4-K7 at pair widths C that are not a multiple of 16, checked on the CPU.

The Pallas kernels take any C as one ``(C, C)`` block.  The port's kernels
work on ``padded_width(C) = round_up(C, 16)``: at a ragged C the CUDA
wrappers stage rows, weights and cotangents into zero-padded copies that
wide, hand the library the logical C (the LayerNorms' divisor), and cut the
outputs back.  Here, at C = 7, 24 and 40 (and the multiples 16 and 48 for
the no-copy path), float32 and bfloat16:

* the port's plain versions and ``fused_triangle_multiplication`` against
  the Pallas ``_prologue_op`` / ``_epilogue_op`` in interpret mode and
  ``jax.vjp`` of the JAX op;
* the padded schedule: the CUDA wrappers on CPU tensors with the launch
  replaced by the plain formulas run on the staged tensors, every column
  past C zero and the LayerNorms divided by C (what ``csrc/tri_mul.cu``
  computes at Cp), against the plain version at C; the staged tensors'
  widths, zeros and alignment; no copy at a multiple of 16;
* the padded width of a table of C, and the logical C handed to the
  library's route and workspace queries.

Budgets (tests/test_tri_mul.py:49-60): f32 ``2e-5 max(1, max|ref|)``, bf16
``5e-2 max|ref|``.  The kernels themselves run only on the card, where
``chip_smoke.py`` phase 24 holds them to these plain versions.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.ops.tri_mul import _epilogue_op, _prologue_op
from protstruc_tpu.ops.tri_mul import fused_triangle_multiplication as jax_tri_mul
from protstruc_tpu_torch.ops import tri_mul

torch.set_num_threads(1)

B, L = 2, 11           # N = 242 rows: ragged against 16-row tiles
N = B * L * L
TILE = 128
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
PARAMS = ("ln_in", "a_gate", "a_proj", "b_gate", "b_proj", "out_gate", "ln_out", "out_proj")
RAGGED = (7, 24, 40)


def _mask():
    mask = np.ones((B, L), bool)
    mask[1, L - 3:] = False
    mask[0, 2] = False
    return mask


def _inputs(C, seed):
    rng = np.random.RandomState(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (rng.randn(*shape) * scale + shift).astype(np.float32)

    params = {name: ((r(C, scale=0.2, shift=1.0), r(C, scale=0.2)) if name.startswith("ln")
                     else (r(C, C, scale=C ** -0.5), r(C, scale=0.1))) for name in PARAMS}
    return {"pair": r(B, L, L, C, shift=0.3), "prod": r(N, C, scale=3.0), "ct_a": r(N, C),
            "ct_b": r(N, C), "ct": r(B, L, L, C), "params": params}


def _budget(ref, out, dtype, name):
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape, (name, ref.shape, out.shape)
    err = float(np.abs(ref - out).max())
    top = float(np.abs(ref).max())
    tol = 2e-5 * max(1.0, top) if dtype == "f32" else 5e-2 * max(top, 1e-3)
    assert err <= tol, (name, err, tol)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32))


def _args(d, kind, conv, row_vec):
    """K4's (x, m, weights) or K6's (x, p, weights), ``conv(array)`` each;
    vectors as (1, C) rows for the Pallas ops."""
    p = d["params"]
    vec = (lambda a: conv(a).reshape(1, -1)) if row_vec else conv
    x = conv(d["pair"].reshape(N, -1))
    if kind == "prologue":
        m = (_mask()[:, :, None] & _mask()[:, None, :]).reshape(-1).astype(np.float32)
        w = [vec(p["ln_in"][0]), vec(p["ln_in"][1])]
        for name in ("a_gate", "a_proj", "b_gate", "b_proj"):
            w += [conv(p[name][0]), vec(p[name][1])]
        return x, conv(m[:, None] if row_vec else m), w
    w = [vec(p["ln_in"][0]), vec(p["ln_in"][1]), conv(p["out_gate"][0]), vec(p["out_gate"][1]),
         vec(p["ln_out"][0]), vec(p["ln_out"][1]), conv(p["out_proj"][0]), vec(p["out_proj"][1])]
    return x, conv(d["prod"]), w


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", RAGGED)
def test_forwards_match_pallas_at_ragged_widths(C, dtype):
    tdt, jdt = DTYPES[dtype]
    d = _inputs(C, seed=C)
    to_j = lambda a: jnp.asarray(a).astype(jdt)           # noqa: E731
    to_t = lambda a: torch.from_numpy(np.asarray(a)).to(tdt)  # noqa: E731
    x, m, w = _args(d, "prologue", to_j, True)
    ref = _prologue_op(TILE, True, x, m, *w)
    x, m, w = _args(d, "prologue", to_t, False)
    out = tri_mul._prologue_fwd_plain(x, m, *w)
    for name, r, o in zip("ab", ref, out):
        assert o.shape == (N, C) and o.dtype == tdt
        _budget(_f32(r), _f32(o), dtype, name)
    x, p, w = _args(d, "epilogue", to_j, True)
    ref = _epilogue_op(TILE, True, x, p, *w)
    x, p, w = _args(d, "epilogue", to_t, False)
    _budget(_f32(ref), _f32(tri_mul._epilogue_fwd_plain(x, p, *w)), dtype, "out")


@pytest.mark.parametrize("dtype,outgoing", [("f32", True), ("bf16", False)])
@pytest.mark.parametrize("C", RAGGED)
def test_op_and_gradients_match_jax_vjp_at_ragged_widths(C, dtype, outgoing):
    """The port's op (both autograd Functions, plain versions on the CPU)
    against ``jax.vjp`` of the Pallas op in interpret mode: the output,
    dpair and every parameter leaf."""
    tdt, jdt = DTYPES[dtype]
    d = _inputs(C, seed=2 * C)
    mask = _mask()
    params = {k: tuple(jnp.asarray(v).astype(jdt) for v in d["params"][k]) for k in PARAMS}
    out_ref, vjp = jax.vjp(lambda pr, pa: jax_tri_mul(pr, jnp.asarray(mask), pa, outgoing=outgoing,
                                                       interpret=True, tile_rows=TILE),
                           jnp.asarray(d["pair"]).astype(jdt), params)
    dpair_ref, dparams_ref = vjp(jnp.asarray(d["ct"]).astype(jdt))
    pair = torch.from_numpy(d["pair"]).to(tdt).requires_grad_()
    prm = {k: tuple(torch.from_numpy(v).to(tdt).requires_grad_() for v in d["params"][k]) for k in PARAMS}
    out = tri_mul.fused_triangle_multiplication(pair, torch.from_numpy(mask), prm, outgoing)
    leaves = [pair] + [v for k in PARAMS for v in prm[k]]
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(d["ct"]).to(tdt))
    _budget(_f32(out_ref), _f32(out.detach()), dtype, "out")
    _budget(_f32(dpair_ref), _f32(grads[0]), dtype, "dpair")
    for (k, i), r, g in zip([(k, i) for k in PARAMS for i in range(2)],
                            [v for k in PARAMS for v in dparams_ref[k]], grads[1:]):
        assert g.dtype == tdt and g.shape == tuple(r.shape), (k, i)
        _budget(_f32(r), _f32(g), dtype, f"{k}[{i}]")


# -- the padded schedule ------------------------------------------------------


def _padded_ln(C):
    """``_ln_f32`` and ``_ln_bwd`` over rows zero past C, divided by C: the
    kernels' LayerNorms at the padded width."""
    def ln(x, scale, bias):
        mu = x.sum(-1, keepdim=True) / C
        var = (x * x).sum(-1, keepdim=True) / C - mu * mu
        inv = torch.rsqrt(var + tri_mul._EPS)
        xhat = (x - mu) * inv
        return xhat * scale.float() + bias.float(), xhat, inv

    def ln_bwd(dsrc, xhat, inv, scale):
        dxh = dsrc * scale.float()
        return inv * (dxh - dxh.sum(-1, keepdim=True) / C - xhat * ((dxh * xhat).sum(-1, keepdim=True) / C))

    return ln, ln_bwd


_WRAPPERS = {  # name: (CUDA wrapper, plain version, row tensors, vector/matrix kinds, outputs)
    "prologue_fwd": ("_prologue_fwd_cuda", "_prologue_fwd_plain", 1, tri_mul._PRO_W, 2),
    "prologue_bwd": ("_prologue_bwd_cuda", "_prologue_bwd_plain", 1, tri_mul._PRO_W, 2),
    "epilogue_fwd": ("_epilogue_fwd_cuda", "_epilogue_fwd_plain", 2, tri_mul._EPI_W, 1),
    "epilogue_bwd": ("_epilogue_bwd_cuda", "_epilogue_bwd_plain", 2, tri_mul._EPI_W, 1),
}


def _kernel_args(name, d, tdt):
    to_t = lambda a: torch.from_numpy(np.asarray(a)).to(tdt)  # noqa: E731
    x, aux, w = _args(d, name.split("_")[0], to_t, False)
    cts = {"prologue_bwd": [to_t(d["ct_a"]), to_t(d["ct_b"])], "epilogue_bwd": [to_t(d["prod"] * 0.5)]}
    return [x, aux, *w, *cts.get(name, [])]


def _emulated_launch(name, C, handed, monkeypatch):
    """A ``_launch`` that runs the plain formulas on the staged tensors with
    the LayerNorms divided by C and writes them into the kernel's outputs,
    recording what it was handed."""
    plain = getattr(tri_mul, _WRAPPERS[name][1])
    n_in = {"prologue_fwd": 12, "prologue_bwd": 14, "epilogue_fwd": 10, "epilogue_bwd": 11}[name]

    def launch(nm, fn, x, *args):
        assert nm == name and x.shape[1] == C
        handed.extend(args)
        ins, outs = args[:n_in], args[n_in:]
        with monkeypatch.context() as mp:
            ln, ln_bwd = _padded_ln(C)
            mp.setattr(tri_mul, "_ln_f32", ln)
            mp.setattr(tri_mul, "_ln_bwd", ln_bwd)
            got = plain(*ins)
        got = got if isinstance(got, tuple) else (got,)
        if name.endswith("_bwd"):  # dx (dp), then the vector and matrix gradients
            rows = 1 if name == "prologue_bwd" else 2
            dvec, dmat = outs[rows], outs[rows + 1]
            kinds = _WRAPPERS[name][3]
            for o, g in zip(outs[:rows], got[:rows]):
                o.copy_(g)
            iv = im = 0
            for g, kind in zip(got[rows:], kinds):
                if kind == "v":
                    dvec[iv].copy_(g)
                    iv += 1
                else:
                    dmat[im].copy_(g)
                    im += 1
        else:
            for o, g in zip(outs, got):
                o.copy_(g)

    return launch


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("C", RAGGED + (16, 48))
@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_padded_schedule_matches_the_plain_version(name, C, dtype, monkeypatch):
    tdt = DTYPES[dtype][0]
    args = _kernel_args(name, _inputs(C, seed=3 * C), tdt)
    Cp = tri_mul.padded_width(C)
    handed = []
    lib = types.SimpleNamespace(ps_tri_workspace=lambda *a: 0, **{f"ps_tri_{name}": None})
    monkeypatch.setattr(tri_mul, "load_library", lambda: lib)
    monkeypatch.setattr(tri_mul, "_launch", _emulated_launch(name, C, handed, monkeypatch))
    got = getattr(tri_mul, _WRAPPERS[name][0])(*args)
    ref = getattr(tri_mul, _WRAPPERS[name][1])(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.shape == r.shape and g.dtype == r.dtype, i
        _budget(_f32(r), _f32(g), dtype, f"{name} output {i}")
    # what the library was handed: rows, mask, weights, cotangents, then outputs
    n_rows, kinds = _WRAPPERS[name][2], _WRAPPERS[name][3]
    rows = [handed[0]] + ([handed[1]] if n_rows == 2 else [])
    weights = handed[2:2 + len(kinds)]
    cts = handed[2 + len(kinds):len(args)]
    for t in rows + cts:
        assert t.shape == (N, Cp) and t.is_contiguous() and t.data_ptr() % 16 == 0
        assert not t[:, C:].any()
    for t, kind in zip(weights, kinds):
        assert t.shape == ((Cp, Cp) if kind == "m" else (Cp,)) and t.data_ptr() % 16 == 0
        assert not t[..., C:].any() and (kind == "v" or not t[C:].any())
    for t in handed[len(args):]:
        if isinstance(t, torch.Tensor) and t.dim() and t.shape[-1] in (C, Cp):
            assert t.shape[-1] == Cp
    if C % 16 == 0:  # a multiple of 16 runs as before: the caller's own tensors
        assert handed[0] is args[0] and all(h is a for h, a in zip(handed[2:len(args)], args[2:]))


def test_padded_width_and_the_width_the_library_is_asked_at(monkeypatch):
    table = {1: 16, 7: 16, 8: 16, 15: 16, 16: 16, 17: 32, 24: 32, 40: 48, 64: 64, 72: 80,
             100: 112, 128: 128, 129: 144, 200: 208, 1024: 1024}
    assert {C: tri_mul.padded_width(C) for C in table} == table
    asked = []

    def ps_tri_route(device, kind, dtype, n, C, out):
        asked.append(("route", C))
        out._obj.value = 1
        return 0

    def ps_tri_workspace(device, kind, dtype, n, C, out):
        asked.append(("workspace", n, C))
        out._obj.value = 5
        return 0

    lib = types.SimpleNamespace(ps_tri_route=ps_tri_route, ps_tri_workspace=ps_tri_workspace)
    monkeypatch.setattr(tri_mul, "load_library", lambda: lib)
    tri_mul._route.cache_clear()
    tri_mul._workspace_floats.cache_clear()
    try:
        x = torch.empty((10, 24))
        assert tri_mul.route("prologue_bwd", x) == "wide"
        assert tri_mul._workspace_floats("prologue_bwd", torch.float32, 10, 24, None) == 5
    finally:
        tri_mul._route.cache_clear()
        tri_mul._workspace_floats.cache_clear()
    assert asked == [("route", 24), ("workspace", 10, 24)]
