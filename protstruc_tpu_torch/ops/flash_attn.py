"""Flash pair-bias attention: the hand-written CUDA kernels (K8 forward, K9
backward) and their plain versions.

Port of ``protstruc_tpu/ops/flash_attn.py`` (``flash_pair_bias_attention``,
kernels ``_fwd_kernel`` and ``_bwd_kernel``).  The op is TrFold's node
attention, ``softmax(q k^T / sqrt(dh) + bias) v`` over the keys ``kmask``
allows, computed without the ``(B, H, L, L)`` probabilities in device memory:

* K8 (forward) streams key tiles through an online softmax on the tensor
  cores (``mma.sync``: bf16, or float32 as three TF32 products) and returns
  the output and the per-row logsumexp ``lse (B, H, L)``;
* K9 (backward) recomputes ``p = exp(s - lse)`` per tile on the tensor
  cores (``mma.sync``, as K8), accumulates dk and dv per key tile and
  streams ``ds`` (the bias gradient) out;
  ``delta = sum(dO * out)`` before it and ``dq = ds k * scale`` after it are
  plain PyTorch, as in the JAX package.

Conventions, as in the JAX kernels: masked logits use the finite sentinel
-1e30; a query row with no allowed key outputs zeros, its ``lse`` is pinned
to +1e30 and every gradient through it is 0; ``scale = 1 / sqrt(dh)``
multiplies (the einsum path of ``PairBiasAttention`` divides); p is rounded
to the value dtype before ``p v``.

Layouts: ``q, k, v`` are ``(B, L, H, dh)`` and may be strided views (the
kernels read them through their strides, so the three can be slices of one
``qkv`` projection); ``bias`` is ``(B, H, L, L)`` through any strides (the
pair-bias Dense's ``(B, L, L, H)`` output permuted, read in place) and ``ds``
comes back with the bias's strides.  The kernels mask ragged L themselves:
the wrapper pads and copies nothing.

The wrappers :func:`flash_fwd` and :func:`flash_bwd` dispatch on the tensor's
device and nothing else: a CUDA tensor launches ``csrc/flash_attn.cu`` (or
raises), a CPU tensor takes the plain version below.  The plain backward is
the explicit formulas, not autograd of the plain forward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from protstruc_tpu_torch.ops import cuda_lib

__all__ = ["flash_pair_bias_attention", "pair_bias_attention_reference", "flash_fwd",
           "flash_bwd", "dq_from_ds", "load_library", "library_path", "LAUNCHES"]

_SOURCES = ("flash_attn.cu",)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)  # the kernels' instantiations (csrc/flash_attn.cu PS_DISPATCH)
NEG = -1e30          # masked-logit sentinel
LSE_MASKED = 1e30    # logsumexp pin of a query row with no allowed key

#: Kernel launches made by the CUDA wrappers in this process (K8 fwd, K9 bwd).
LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd": 0}


def _scale(dh: int) -> float:
    return 1.0 / math.sqrt(dh)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the Pallas bodies, flash_attn.py:79-129, 184-251)
# ---------------------------------------------------------------------------


def _logits(q, k, bias, kmask):
    """f32 ``q k^T * scale + bias`` with masked keys at the sentinel, and the
    ``(B, 1, 1, L)`` allowed-key mask."""
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * _scale(q.shape[-1])
    s = s + bias.float()
    allowed = kmask[:, None, None, :]
    return torch.where(allowed, s, NEG), allowed


def _flash_fwd_plain(q, k, v, bias, kmask) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8 in plain PyTorch: ``(out (B, L, H, dh) in q's dtype, lse (B, H, L) f32)``."""
    s, allowed = _logits(q, k, bias, kmask)
    m = s.amax(-1, keepdim=True)
    p = torch.where(allowed, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    has_keys = l > 0.0
    acc = torch.einsum("bhlm,bmhd->blhd", p.to(v.dtype).float(), v.float())
    safe_l = torch.where(has_keys, l, 1.0)[..., 0].permute(0, 2, 1)[..., None]
    out = torch.where(has_keys[..., 0].permute(0, 2, 1)[..., None], acc / safe_l, 0.0)
    lse = torch.where(has_keys, m + torch.log(torch.where(has_keys, l, 1.0)), LSE_MASKED)
    return out.to(q.dtype), lse[..., 0]


def _flash_bwd_plain(q, k, v, bias, kmask, do, lse, delta
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K9 in plain PyTorch: ``(ds (B, H, L, L) in the bias's dtype, dk, dv
    (B, L, H, dh) in q's dtype)`` from p, dv, dp, ds, dk written out."""
    s, allowed = _logits(q, k, bias, kmask)
    p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bhlm,blhd->bmhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("blhd,bmhd->bhlm", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("bhlm,blhd->bmhd", ds.to(q.dtype).float(), q.float()) * _scale(q.shape[-1])
    return ds.to(bias.dtype), dk.to(q.dtype), dv.to(q.dtype)


def pair_bias_attention_reference(q, k, v, bias, kmask):
    """The einsum path's semantics (``PairBiasAttention`` without flash):
    q/k/v ``(B, L, H, dh)``, bias ``(B, H, L, L)``, kmask ``(B, L)`` bool ->
    ``(B, L, H, dh)``."""
    dh = q.shape[-1]
    logits = torch.einsum("blhd,bmhd->bhlm", q, k) / torch.sqrt(
        torch.tensor(dh, dtype=q.dtype, device=q.device))
    logits = logits + bias
    allowed = kmask[:, None, None, :]
    logits = torch.where(allowed, logits, torch.tensor(-1e9, dtype=logits.dtype,
                                                       device=q.device))
    attn = torch.where(allowed, torch.softmax(logits, dim=-1), 0.0)
    return torch.einsum("bhlm,bmhd->blhd", attn.to(v.dtype), v)


# ---------------------------------------------------------------------------
# the CUDA kernels (csrc/flash_attn.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the K8/K9 library; raises if it cannot."""
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("flash_attn", _SOURCES, cuda_lib.NVCC_FLAGS_FMA)
        head = [_I] * 6 + [ctypes.c_float]  # device, dtype, B, H, L, dh, scale
        lib.ps_flash_fwd.restype = _I
        # q, k, v, bias, kmask, strides, out, lse; then the stream
        lib.ps_flash_fwd.argtypes = head + [_P] * 8 + [_P]
        lib.ps_flash_bwd.restype = _I
        # q, k, v, bias, kmask, dO, lse, delta, strides, ds, dk, dv; then the stream
        lib.ps_flash_bwd.argtypes = head + [_P] * 12 + [_P]
        _LIB = lib
    return _LIB


def library_path():
    """Where the K8/K9 library is built (keyed by its source and flags)."""
    return cuda_lib.library_path("flash_attn", _SOURCES, cuda_lib.NVCC_FLAGS_FMA)


def _check(q, k, v, bias, kmask, *extra):
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, got {q.dtype}")
    B, L, H, dh = q.shape
    if dh not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels take dh in {_HEAD_DIMS}, got {dh}")
    for name, t in (("k", k), ("v", v), *extra):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {tuple(t.shape)} {t.dtype} on {t.device}; "
                             f"q is {tuple(q.shape)} {q.dtype} on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous head dim")
    if q.stride(-1) != 1:
        raise ValueError("q needs a contiguous head dim")
    if bias.shape != (B, H, L, L) or bias.dtype != q.dtype or bias.device != q.device:
        raise ValueError(f"bias must be ({B}, {H}, {L}, {L}) {q.dtype} on {q.device}, "
                         f"got {tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if kmask.shape != (B, L) or kmask.dtype != torch.bool or kmask.device != q.device:
        raise ValueError(f"kmask must be ({B}, {L}) bool on {q.device}")


def _strides(q, k, v, g, bias):
    """The 16 element strides ps_flash_* read: (b, l, h) of q, k, v, dO, then
    (b, h, i, j) of the bias (and ds)."""
    vals = [s for t in (q, k, v, g) for s in t.stride()[:3]] + list(bias.stride())
    return (ctypes.c_longlong * 16)(*vals)


def _flash_fwd_cuda(q, k, v, bias, kmask):
    _check(q, k, v, bias, kmask)
    B, L, H, dh = q.shape
    out = torch.empty((B, L, H, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device)
    if B == 0 or L == 0 or H == 0:
        return out, lse
    lib = load_library()
    km = kmask.contiguous().view(torch.uint8)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ps_flash_fwd(q.device.index, _DTYPES[q.dtype], B, H, L, dh, _scale(dh),
                          q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                          km.data_ptr(), _strides(q, k, v, q, bias), out.data_ptr(),
                          lse.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention forward kernel launch failed with code {rc}")
    LAUNCHES["fwd"] += 1
    return out, lse


def _flash_bwd_cuda(q, k, v, bias, kmask, do, lse, delta):
    _check(q, k, v, bias, kmask, ("do", do))
    B, L, H, dh = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, L) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 ({B}, {H}, {L})")
    ds = torch.empty_like(bias)  # the bias's strides (dense layouts keep them)
    if ds.stride() != bias.stride():
        raise ValueError(f"bias strides {bias.stride()} are not a dense layout")
    dk = torch.empty((B, L, H, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if B == 0 or L == 0 or H == 0:
        return ds, dk, dv
    lib = load_library()
    km = kmask.contiguous().view(torch.uint8)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.ps_flash_bwd(q.device.index, _DTYPES[q.dtype], B, H, L, dh, _scale(dh),
                          q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                          km.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          _strides(q, k, v, do, bias), ds.data_ptr(), dk.data_ptr(),
                          dv.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed with code {rc}")
    LAUNCHES["bwd"] += 1
    return ds, dk, dv


# ---------------------------------------------------------------------------
# device dispatch and the differentiable op
# ---------------------------------------------------------------------------


def _on_device(name, x, cuda_fn, plain_fn):
    if x.device.type == "cuda":
        return cuda_fn
    if x.device.type == "cpu":
        return plain_fn
    raise ValueError(f"flash attention {name} has no implementation for device {x.device}")


def flash_fwd(q, k, v, bias, kmask) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: ``(out (B, L, H, dh), lse (B, H, L) f32)``."""
    return _on_device("fwd", q, _flash_fwd_cuda, _flash_fwd_plain)(q, k, v, bias, kmask)


def flash_bwd(q, k, v, bias, kmask, do, lse, delta):
    """K9: ``(ds (B, H, L, L) like bias, dk, dv (B, L, H, dh))`` given K8's
    inputs, the output cotangent ``do``, ``lse`` and ``delta (B, H, L)``."""
    fn = _on_device("bwd", q, _flash_bwd_cuda, _flash_bwd_plain)
    return fn(q, k, v, bias, kmask, do, lse, delta)


def dq_from_ds(ds, k):
    """``dq = ds k * scale`` in q's dtype: one batched product outside the
    kernels, as in the JAX package (flash_attn.py:503-509)."""
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k).float() * _scale(k.shape[-1])
    return dq.to(k.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, kmask):
        out, lse = flash_fwd(q, k, v, bias, kmask)
        ctx.save_for_backward(q, k, v, bias, kmask, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, kmask, out, lse = ctx.saved_tensors
        g = g.contiguous()
        # delta_i = sum_d dO_id * O_id, (B, H, L)
        delta = (g.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
        ds, dk, dv = flash_bwd(q, k, v, bias, kmask, g, lse, delta)
        return dq_from_ds(ds, k), dk, dv, ds, None


def flash_pair_bias_attention(q, k, v, bias, kmask):
    """Fused attention with additive pair bias and key masking.

    q, k, v: ``(B, L, H, dh)`` float32 or bfloat16 (strided views allowed,
    head dim contiguous); bias: ``(B, H, L, L)`` of the same dtype, any dense
    strides; kmask: ``(B, L)`` bool.  Returns ``(B, L, H, dh)`` in q's dtype,
    differentiable in q, k, v and bias through K9.
    """
    return _FlashAttention.apply(q, k, v, bias, kmask)
