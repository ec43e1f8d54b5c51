"""Layers with flax.linen's semantics (flax 0.12), for the ported models.

The JAX models are flax modules; the port's are ``torch.nn.Module``s that
compute what flax computes and store what flax stores:

* parameters are float32 and keep flax's names and shapes -- a Dense kernel
  is ``(*in_shape, *out_shape)`` (``(in, out)`` for a plain Dense, the
  transpose of ``torch.nn.Linear.weight``), an Embed table is ``embedding``
  ``(num, features)``, a LayerNorm has ``scale`` and ``bias`` -- so a flax
  parameter tree maps onto a ``state_dict`` leaf for leaf
  (``protstruc_tpu_torch.convert``);
* the compute ``dtype`` is applied as flax applies it: Dense casts input,
  kernel and bias to ``dtype`` and rounds the product before adding the bias;
  Embed casts the table before the gather; LayerNorm takes float32
  statistics in the fast-variance form ``E[x^2] - mu^2`` (clipped at 0),
  ``eps = 1e-6``, ``(x - mu) * (rsqrt(var + eps) * scale) + bias``, and casts
  the result to ``dtype``.  ``torch.nn.functional.layer_norm`` (eps 1e-5, the
  two-pass variance) and ``torch.nn.Linear`` are not these;
* initializers are flax's: ``lecun_normal`` kernels (a normal truncated at
  two standard deviations, scaled to variance ``1 / fan_in``), zero biases,
  LayerNorm ones and zeros, Embed ``N(0, 1 / features)``.  They draw from an
  explicit ``torch.Generator`` (flax's ``PRNGKey`` streams are not
  reproducible here, so the values differ; the distributions do not).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "LayerNorm", "Embed", "gelu", "layer_norm", "lecun_normal_", "LN_EPS"]

LN_EPS = 1e-6  # flax.linen.LayerNorm default (torch's is 1e-5)

Shape = Union[int, Sequence[int]]


def _tuple(s: Shape) -> Tuple[int, ...]:
    return (s,) if isinstance(s, int) else tuple(s)


def lecun_normal_(t: torch.Tensor, gen: torch.Generator, fan_in: int) -> None:
    """Fill ``t`` with flax's ``lecun_normal``: a standard normal truncated to
    [-2, 2] (the inverse CDF of a uniform draw), times ``sqrt(1 / fan_in) /
    0.8796...`` (the truncated normal's standard deviation).  Drawn on the
    generator's device, copied to ``t``'s."""
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    u = torch.empty(t.shape, dtype=torch.float64, device=gen.device).uniform_(lo, hi, generator=gen)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        t.copy_(torch.erfinv(u) * (math.sqrt(2.0) * std))


class Dense(nn.Module):
    """flax ``nn.Dense`` / ``nn.DenseGeneral`` over the trailing axes.

    Contracts the last ``len(in_shape)`` axes of the input with ``kernel
    (*in_shape, *out_shape)`` and adds ``bias (*out_shape,)``: ``Dense(C, F)``
    is ``nn.Dense(F)``, ``Dense(D, (3, h, dh))`` is ``nn.DenseGeneral((3, h,
    dh))`` and ``Dense((h, dh), D)`` is ``nn.DenseGeneral(D, axis=(-2, -1))``.
    """

    def __init__(self, in_shape: Shape, out_shape: Shape, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.in_shape, self.out_shape = _tuple(in_shape), _tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(self.in_shape + self.out_shape, device=device))
        self.bias = nn.Parameter(torch.zeros(self.out_shape, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        lecun_normal_(self.kernel, gen, math.prod(self.in_shape))
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, k = self.dtype, len(self.in_shape)
        n_in, n_out = math.prod(self.in_shape), math.prod(self.out_shape)
        lead = x.shape[:x.dim() - k]
        y = x.to(dt).reshape(*lead, n_in) @ self.kernel.to(dt).reshape(n_in, n_out)
        return (y + self.bias.to(dt).reshape(n_out)).reshape(*lead, *self.out_shape)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm`` over the last axis (see the module docstring)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(-1, keepdim=True) - mu * mu, 0.0)
    mul = torch.rsqrt(var + LN_EPS) * scale
    return ((x - mu) * mul + bias).to(dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=dtype)`` over the last axis, ``features`` wide."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.dtype)


class Embed(nn.Module):
    """flax ``nn.Embed(num, features, dtype=dtype)``: the table cast to
    ``dtype``, then gathered.

    Through ``F.embedding``, whose backward sums the rows of each index by a
    sort and segment reduction: the gradient of an advanced-indexing gather
    (``table[idx]``) is an ``index_put_`` that adds an index's duplicates one
    after another, and the pair embeddings gather a 36- or 66-row table at
    every one of B*L*L pairs (533 ms of a 1.39 s train step at B=4, L=512 on
    an H100).
    """

    def __init__(self, num: int, features: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty((num, features), device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        std = math.sqrt(1.0 / self.embedding.shape[1])
        z = torch.randn(self.embedding.shape, generator=gen, device=gen.device, dtype=torch.float64)
        with torch.no_grad():
            self.embedding.copy_(z * std)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx.long(), self.embedding.to(self.dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation (flax's default)."""
    return F.gelu(x, approximate="tanh")
