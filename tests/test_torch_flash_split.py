"""K8's float32 numerics and host-side choices, checked on the CPU.

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
head widths 64 and 128 (B=1, H=2, L=96).  Also checked: the library's ctypes
signatures are set once.
"""

import ctypes

import numpy as np
import pytest
import torch

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
