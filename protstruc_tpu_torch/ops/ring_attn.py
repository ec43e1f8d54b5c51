"""Ring flash attention: sequence-parallel pair-bias attention over ranks.

Port of ``protstruc_tpu/ops/ring_attn.py``.  Each rank of the ring holds one
``L / n`` block of the residue axis: its queries, keys, values and key mask,
and the bias rows of its queries over every key, ``(B, H, L/n, L)``.  The
key/value blocks travel round the ring; each rank attends its queries to the
block it holds and merges the result into a running ``(out, lse)`` pair by
the online-softmax merge, so neither the keys nor the bias are ever gathered.

* n - 1 exchanges, not n: the last visiting block is attended without a
  rotation after it.
* At step t a rank holds the block of rank ``(r + t) mod n``, and attends it
  with the bias columns ``src * Lq : (src + 1) * Lq``.  The bias is split
  into its n column blocks once (views, no copy); K8 reads a block through
  its strides in place.  In the backward K9 writes ``ds`` with the bias's
  strides, which must be a dense layout, so each block is copied once into a
  dense ``(B, H, Lq, Lq)`` there (``flash_pair_bias_attention_lse``), and
  autograd's split backward writes the n ``ds`` blocks into the bias
  gradient (one more copy of the ``(B, H, Lq, L)`` rows).
* The merge takes ``-inf`` as its empty element: a block with no allowed key
  for a row adds nothing, and a row with no allowed key anywhere gives zeros
  with zero gradients.
* ``torch.distributed`` point-to-point operations carry no gradient, so the
  rotation is a pair of autograd functions (``parallel/p2p.py``): one posts
  the exchange (``batch_isend_irecv``) before the block is attended, the
  other waits for it after; their backwards run the exchange the other way
  round the ring, so the key and value gradients come home to the rank that
  owns the block.  Every rank issues its exchanges in the same order,
  forward and backward.

``local`` picks the per-block attention: ``"flash"`` (the K8/K9 kernels
through :func:`~protstruc_tpu_torch.ops.flash_attn.flash_pair_bias_attention_lse`)
or ``"plain"`` (the einsum form); the default is flash on a CUDA tensor and
plain on a CPU tensor.  :func:`attend_merge` is one step, usable over blocks
on one device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from protstruc_tpu_torch.ops.flash_attn import flash_pair_bias_attention_lse
from protstruc_tpu_torch.parallel.mesh import mesh_coords
from protstruc_tpu_torch.parallel.p2p import finish_rotation, post_rotation

__all__ = ["ring_pair_bias_attention", "ring_attention_sharded", "attend_merge",
           "local_attention_lse"]


def local_attention_lse(q, k, v, bias, kmask, local: str = "plain"):
    """One (queries x key block) attention -> ``(out (B, Lq, H, dh) in q's
    dtype, lse (B, H, Lq) float32)``, ``lse = -inf`` on a row with no
    allowed key in the block.  ``local="flash"`` runs K8/K9, ``"plain"`` the
    einsum form (the JAX package's ``jnp`` local)."""
    if local == "flash":
        return flash_pair_bias_attention_lse(q, k, v, bias, kmask)
    if local != "plain":
        raise ValueError(f"local must be 'flash' or 'plain', got {local!r}")
    dh = q.shape[-1]
    logits = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) / (dh ** 0.5) + bias.float()
    allowed = kmask[:, None, None, :]
    s = torch.where(allowed, logits, -1e30)
    m = s.amax(-1)                                            # (B, H, Lq)
    p = torch.where(allowed, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    has = l > 0.0
    out = torch.einsum("bhlm,bmhd->blhd", p, v.float()) / torch.where(
        has, l, 1.0).permute(0, 2, 1)[..., None]
    out = torch.where(has.permute(0, 2, 1)[..., None], out, 0.0)
    lse = torch.where(has, m + torch.log(torch.where(has, l, 1.0)), -math.inf)
    return out.to(q.dtype), lse


def _logaddexp(a, b):
    """``log(exp a + exp b)`` with ``-inf`` as the empty element and zero
    gradients (not NaN) where both are ``-inf``."""
    m = torch.maximum(a, b)
    m = torch.where(torch.isfinite(m), m, 0.0).detach()  # d/dm of the sum is 0
    s = torch.exp(a - m) + torch.exp(b - m)
    has = s > 0.0
    return torch.where(has, m + torch.log(torch.where(has, s, 1.0)), -math.inf)


def attend_merge(acc, lse_tot, q, k_s, v_s, b_s, km_s, local: str = "plain"):
    """One ring step: attend ``q`` to the visiting block ``(k_s, v_s, b_s,
    km_s)`` and merge it into the running ``(acc (B, Lq, H, dh) float32,
    lse_tot (B, H, Lq))``; returns the new pair."""
    out_s, lse_s = local_attention_lse(q, k_s, v_s, b_s, km_s, local)
    new = _logaddexp(lse_tot, lse_s)
    safe = torch.where(torch.isfinite(new), new, 0.0)
    w_prev = torch.exp(lse_tot - safe).permute(0, 2, 1)[..., None]
    w_new = torch.exp(lse_s - safe).permute(0, 2, 1)[..., None]
    return acc * w_prev + out_s.float() * w_new, new


def ring_pair_bias_attention(q, k, v, bias, kmask, *, group=None,
                             local: Optional[str] = None):
    """Per-rank ring attention over the ranks of ``group`` (all ranks when
    None), on this rank's blocks.

    Args:
      q, k, v: ``(B, Lq, H, dh)``, this rank's residue block (``Lq = L / n``);
        q stays, k and v travel.
      bias: ``(B, H, Lq, L)``, the bias rows of the local queries over every
        key (the global ``(B, H, L, L)`` bias split along its query axis).
      kmask: ``(B, Lq)`` bool, the validity of the local key block.
      local: ``"flash"`` or ``"plain"`` (default: flash on CUDA, plain on CPU).

    Returns ``(B, Lq, H, dh)`` in q's dtype; a query row with no allowed key
    in the whole ring gives zeros with zero gradients.  Differentiable in q,
    k, v and bias: the backward runs the ring's exchanges in reverse.  k and
    v travel stacked, one tensor, so a step is two exchanges (k/v and the
    key mask) forward and one backward.
    """
    B, Lq, H, dh = q.shape
    L = bias.shape[-1]
    if L % Lq:
        raise ValueError(f"global key length {L} must be a multiple of the local block {Lq} "
                         f"(pad L to the ring size before sharding)")
    n = L // Lq
    ranks = dist.get_world_size(group) if dist.is_initialized() else 1
    if n != ranks:
        raise ValueError(f"the bias covers {n} key blocks but the ring has {ranks} ranks")
    if local is None:
        local = "flash" if q.device.type == "cuda" else "plain"
    r = dist.get_rank(group) if n > 1 else 0
    blocks = bias.split(Lq, dim=-1)            # n column views of the rows
    acc = torch.zeros((B, Lq, H, dh), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, Lq), -math.inf, dtype=torch.float32, device=q.device)
    kv, km = torch.stack([k, v]), kmask.to(torch.uint8)
    if n > 1:
        glob = (lambda i: i) if group is None else (lambda i: dist.get_global_rank(group, i))
        to, frm = glob((r - 1) % n), glob((r + 1) % n)
    for t in range(n):
        src = (r + t) % n
        if t < n - 1:  # post the rotation of block t before attending it
            kv_next = post_rotation(kv, group, to, frm, 4 * t)
            km_next = post_rotation(km, group, to, frm, 4 * t + 2)
        acc, lse = attend_merge(acc, lse, q, kv[0], kv[1], blocks[src], km.bool(), local)
        if t < n - 1:
            kv, km = finish_rotation(kv_next), finish_rotation(km_next)
    return acc.to(q.dtype)


def ring_attention_sharded(q, k, v, bias, kmask, mesh, *, axis: str = "sp",
                           batch_axis: Optional[str] = "dp", head_axis: Optional[str] = "tp",
                           local: Optional[str] = None):
    """Ring attention over GLOBAL tensors on a ``DeviceMesh``
    (``parallel.mesh.make_mesh``): every rank passes the same global q, k, v
    ``(B, L, H, dh)``, bias ``(B, H, L, L)`` and kmask ``(B, L)``, takes its
    block (batch over ``batch_axis``, heads over ``head_axis``, residues over
    ``axis``), runs :func:`ring_pair_bias_attention` over the ``axis`` group
    and returns ITS block of the output, ``(B/dp, L/sp, H/tp, dh)``.

    The JAX package's shard_map wrapper returns the global array; PyTorch
    has no global tensor here, so the caller gathers the blocks if it needs
    them.  Gradients reach the global inputs' blocks this rank read, the
    key/value blocks through the ring from every rank.
    """
    (bi, nb), (si, ns), (hi, nh) = (mesh_coords(mesh, a) for a in (batch_axis, axis, head_axis))
    B, L, H, _ = q.shape
    for what, size, parts in (("B", B, nb), ("L", L, ns), ("H", H, nh)):
        if size % parts:
            raise ValueError(f"{what}={size} is not divisible by its mesh axis ({parts})")
    b = slice(bi * B // nb, (bi + 1) * B // nb)
    lq = slice(si * L // ns, (si + 1) * L // ns)
    h = slice(hi * H // nh, (hi + 1) * H // nh)
    group = mesh.get_group(axis) if ns > 1 else None
    return ring_pair_bias_attention(q[b, lq, h], k[b, lq, h], v[b, lq, h], bias[b, h, lq],
                                    kmask[b, lq], group=group, local=local)
