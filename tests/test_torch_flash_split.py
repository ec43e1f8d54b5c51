"""K8's and K9's float32 numerics and host-side choices, checked on the CPU.

K8 (``csrc/flash_attn.cu``) computes its float32 products on the tensor
cores as "3xTF32": each operand ``x`` is split into ``big = tf32(x)`` and
``small = tf32(x - big)`` (TF32 keeps 10 mantissa bits; the kernel rounds
with ``cvt.rna``, to nearest with ties away from zero), and ``a b`` is summed
as ``a_small b_big + a_big b_small + a_big b_big`` with float32 accumulation.
Here that split is emulated in plain torch (a TF32 value times a TF32 value
is exact in float32, so a float32 matrix product of split operands is what
the tensor core sums) at the FoldModel train shape (B=4, H=4, dh=32, L=256;
``randn`` q, k, v and bias from numpy seeds, as ``chip_smoke.py`` draws them)
and held to the float32 budget against K8's plain version: out and lse
within ``2e-5 * max(1, max|ref|)`` (tests/test_flash_attn.py,
BASELINE.md:31-37).  A single TF32 pass must miss that budget: that is why
the kernel pays for three; the split also holds at the JAX smoke gate's
head widths 64 and 128 (B=1, H=2, L=96).

K9 runs all four of its products (s^T = K Q^T, dp^T = V dO^T, dv += p^T dO,
dk += ds^T Q) as 3xTF32 and sums each query tile's dv and dk products apart
in float32; that schedule, emulated the same way, is held to the JAX
package's backward (``jax.vjp`` of ``flash_pair_bias_attention(
interpret=True)``) under the float32 budget: ds 5e-4, dk and dv 5e-5, each
times ``max(1, max|ref|)``, at the train shape and at L = 640.

Also checked: the library's ctypes signatures are set once, and the wrappers
launch for B*H = 70000 (past the 65535 blocks of a grid's y or z) with a
faked library.
"""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protstruc_tpu.ops.flash_attn import flash_pair_bias_attention as jflash
from protstruc_tpu_torch.ops import cuda_lib
from protstruc_tpu_torch.ops import flash_attn as fa

torch.set_num_threads(1)

BUDGET = 2e-5


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half of the dropped 13 bits to the magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b, passes):
    """``a @ b`` from TF32 operands: one pass, or the three of 3xTF32."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _emulated_fwd(q, k, v, bias, kmask, passes):
    """K8's forward with its two products taken as the tensor cores take
    them; the softmax in float32 as in the plain version."""
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # (B, H, L, dh)
    s = _product(qh, kh.transpose(-1, -2), passes) * fa._scale(q.shape[-1]) + bias
    allowed = kmask[:, None, None, :]
    s = torch.where(allowed, s, fa.NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = (_product(p, vh, passes) / l).permute(0, 2, 1, 3)
    return out, (m + torch.log(l))[..., 0]


def _train_inputs(seed=0, B=4, H=4, dh=32, L=256):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(B, L, H, dh).astype(np.float32)) for _ in range(3))
    bias = torch.from_numpy(rng.randn(B, H, L, L).astype(np.float32))
    kmask = torch.ones((B, L), dtype=torch.bool)
    kmask[0, -7:] = False
    return q, k, v, bias, kmask


def _errors(passes, **shape):
    args = _train_inputs(**shape)
    ref_out, ref_lse = fa._flash_fwd_plain(*args)
    out, lse = _emulated_fwd(*args, passes)
    return {name: (float((got - ref).abs().max()), BUDGET * max(1.0, float(ref.abs().max())))
            for name, got, ref in (("out", out, ref_out), ("lse", lse, ref_lse))}


def test_tf32_rounding_keeps_ten_mantissa_bits_and_the_split_is_exact():
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(np.float32) * 7)
    big = _tf32(x)
    assert (big.view(torch.int32) & 0x1FFF == 0).all()
    assert ((x - big).abs() <= x.abs() * 2.0 ** -11).all()
    small = _tf32(x - big)
    assert ((x - big - small).abs() <= x.abs() * 2.0 ** -21).all()
    # ties go away from zero
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _tf32(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


@pytest.mark.parametrize("shape", [dict(), dict(B=1, H=2, dh=64, L=96), dict(B=1, H=2, dh=128, L=96)],
                         ids=["train", "dh64", "dh128"])
def test_3xtf32_meets_the_float32_budget(shape):
    for name, (err, tol) in _errors(passes=3, **shape).items():
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


def test_one_tf32_pass_misses_the_float32_budget():
    errs = _errors(passes=1)
    assert any(err > tol for err, tol in errs.values()), errs


def test_library_signatures_are_set_once(monkeypatch):
    class Fn:
        pass

    class Lib:
        ps_flash_fwd, ps_flash_bwd = Fn(), Fn()

    loads = []
    monkeypatch.setattr(cuda_lib, "load", lambda *a: loads.append(a) or Lib())
    monkeypatch.setattr(fa, "_LIB", None)
    lib = fa.load_library()
    assert fa.load_library() is lib and len(loads) == 1
    assert len(lib.ps_flash_fwd.argtypes) == 16 and lib.ps_flash_fwd.argtypes[6] is ctypes.c_float
    assert lib.ps_flash_fwd.argtypes[7] is ctypes.c_void_p
    assert len(lib.ps_flash_bwd.argtypes) == 20


LOG2E = 1.4426950408889634


def _emulated_bwd(q, k, v, bias, kmask, do, lse, delta, tile=64):
    """K9 as the card computes it in float32: s^T = K Q^T and dp^T = V dO^T
    for the keys of a block, p^T = exp2((s^T scale + bias - lse) log2 e) on
    allowed keys, ds^T = p^T (dp^T - delta), then dv += p^T dO and dk +=
    ds^T Q with each ``tile`` of queries summed apart and added in float32;
    every product 3xTF32."""
    qh, kh, gh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, do, v))  # (B, H, L, dh)
    scale = fa._scale(q.shape[-1])
    s_t = _product(kh, qh.transpose(-1, -2), 3)                     # (B, H, keys, queries)
    x = (s_t * scale + bias.transpose(-1, -2) - lse[..., None, :]) * LOG2E
    p_t = torch.where(kmask[:, None, :, None], torch.exp2(x), 0.0)
    ds_t = p_t * (_product(vh, gh.transpose(-1, -2), 3) - delta[..., None, :])
    dk, dv = torch.zeros_like(kh), torch.zeros_like(kh)
    for i0 in range(0, q.shape[1], tile):
        rows = slice(i0, i0 + tile)
        dv = dv + _product(p_t[..., rows], gh[..., rows, :], 3)
        dk = dk + _product(ds_t[..., rows], qh[..., rows, :], 3)
    return ds_t.transpose(-1, -2), (dk * scale).permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


@pytest.mark.parametrize("shape", [dict(), dict(B=1, H=2, L=640)], ids=["train", "L640"])
def test_emulated_3xtf32_backward_meets_the_float32_budget_against_jax(shape):
    q, k, v, bias, kmask = _train_inputs(**shape)
    do = torch.from_numpy(np.random.RandomState(7).randn(*q.shape).astype(np.float32))
    out, lse = fa._flash_fwd_plain(q, k, v, bias, kmask)
    delta = (do * out).sum(-1).permute(0, 2, 1)
    got = _emulated_bwd(q, k, v, bias, kmask, do, lse, delta)
    _, vjp = jax.vjp(lambda *a: jflash(*a, jnp.asarray(kmask.numpy()), interpret=True),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v, bias)))
    _, rdk, rdv, rds = vjp(jnp.asarray(do.numpy()))
    for name, g, r, budget in (("ds", got[0], rds, 5e-4), ("dk", got[1], rdk, 5e-5),
                               ("dv", got[2], rdv, 5e-5)):
        r = np.asarray(r)
        err, tol = float(np.abs(g.numpy() - r).max()), budget * max(1.0, float(np.abs(r).max()))
        assert err <= tol, f"{name}: {err:.3e} > {tol:.3e}"


@pytest.mark.parametrize("part", ["fwd", "bwd"])
def test_wrappers_launch_for_any_batch_times_heads(part, monkeypatch):
    handed = []
    lib = types.SimpleNamespace(ps_flash_fwd=lambda *a: handed.append(a) or 0,
                                ps_flash_bwd=lambda *a: handed.append(a) or 0)
    monkeypatch.setattr(fa, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(fa.LAUNCHES, part, 0)
    B, H, L, dh = 17500, 4, 3, 16
    q, k, v, do = (torch.empty((B, L, H, dh), device="meta") for _ in range(4))
    bias = torch.empty((B, H, L, L), device="meta")
    kmask = torch.ones((B, L), dtype=torch.bool, device="meta")
    if part == "fwd":
        outs = fa._flash_fwd_cuda(q, k, v, bias, kmask)
        shapes = [(B, L, H, dh), (B, H, L)]
    else:
        lse, delta = (torch.empty((B, H, L), device="meta") for _ in range(2))
        outs = fa._flash_bwd_cuda(q, k, v, bias, kmask, do, lse, delta)
        shapes = [(B, H, L, L), (B, L, H, dh), (B, L, H, dh)]
    assert [tuple(t.shape) for t in outs] == shapes
    (args,) = handed
    assert args[2:6] == (B, H, L, dh) and fa.LAUNCHES[part] == 1
