"""Bucketed serving featurizer (port of ``protstruc_tpu/utils/aot.py``).

Serving wants steady latency from the first request.  PyTorch runs eagerly,
so there is no XLA program to compile ahead of time; what the JAX package's
``precompile_featurizer`` moved out of the request path is here the CUDA
build of the K1 library and one warm call per (batch size, bucket length),
which also fills PyTorch's caching allocator for those shapes.  Requests are
then padded to the smallest warmed bucket (xyz NaN, atom mask False,
chain_idx -1), featurized, and trimmed back, exactly as in the JAX package.

The pair maps go through K1 on a CUDA device and through the arccos form
(``_inter_residue_geometry``) on the CPU, unless the caller says otherwise:
the JAX package's rule (Pallas on the TPU, its jnp path elsewhere) with the
card in the TPU's place, so CPU serving gives the JAX package's CPU maps.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from protstruc_tpu_torch import geometry as geom
from protstruc_tpu_torch.batch import (
    DeviceLike,
    PAD_IDX,
    _backbone_dihedrals,
    _inter_residue_geometry,
    resolve_device,
)
from protstruc_tpu_torch.constants import MAX_N_ATOMS_PER_RESIDUE
from protstruc_tpu_torch.ops import pair_maps
from protstruc_tpu_torch.utils.buckets import DEFAULT_BUCKETS, bucket_length

__all__ = ["precompile_featurizer", "CompiledFeaturizer"]

Features = Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor, torch.Tensor]


def _featurize(xyz, atom_mask, chain_idx, use_kernel: bool = True) -> Features:
    """Pair maps + masks, backbone dihedrals + mask, and N-CA-C frames.

    ``use_kernel=False`` takes the arccos-form broadcast path for the maps:
    the plain path the kernel path is timed against.
    """
    if use_kernel:
        g = pair_maps.trrosetta_features(xyz, atom_mask)
    else:
        g = _inter_residue_geometry(xyz, atom_mask)
    d, m = _backbone_dihedrals(xyz, chain_idx, atom_mask)
    frames = geom.gram_schmidt(xyz[:, :, 0], xyz[:, :, 1], xyz[:, :, 2])
    return g, d, m, frames


def _pad(x: torch.Tensor, B: int, L: int, fill) -> torch.Tensor:
    out = torch.full((B, L) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=x.device)
    out[: x.shape[0], : x.shape[1]] = x
    return out


class CompiledFeaturizer:
    """Dispatcher over the warmed (B, L-bucket) shapes on one device.

    Call with a StructureBatch on :attr:`device`; the batch is padded to the
    smallest warmed bucket, featurized, and trimmed back to its own (B, L);
    the pair maps go through K1 if ``use_kernel``, else the arccos form.
    """

    def __init__(self, shapes: Sequence[Tuple[int, int]], buckets: Sequence[int],
                 device: torch.device, use_kernel: bool):
        self._shapes = frozenset(shapes)
        self._buckets = tuple(sorted(buckets))
        self._batch_sizes = tuple(sorted({b for b, _ in self._shapes}))
        self.device = device
        self.use_kernel = use_kernel

    @property
    def shapes(self):
        return sorted(self._shapes)

    def __call__(self, batch) -> Features:
        if batch.device != self.device:
            raise ValueError(
                f"batch is on {batch.device}, the featurizer on {self.device}")
        B, L = batch.chain_idx.shape
        Lb = bucket_length(L, self._buckets)
        Bb = next((b for b in self._batch_sizes if b >= B), None)
        if Bb is None or (Bb, Lb) not in self._shapes:
            raise KeyError(
                f"no warmed featurizer for B<={B}, L={Lb}; have {self.shapes}")

        with torch.inference_mode():
            g, d, m, frames = _featurize(
                _pad(batch.xyz, Bb, Lb, float("nan")),
                _pad(batch.atom_mask, Bb, Lb, False),
                _pad(batch.chain_idx, Bb, Lb, PAD_IDX),
                self.use_kernel,
            )
        g = {k: v[:B, :L, :L] for k, v in g.items()}
        return g, d[:B, :L], m[:B, :L], frames[:B, :L]


def precompile_featurizer(
    batch_sizes: Sequence[int] = (1,),
    buckets: Sequence[int] = DEFAULT_BUCKETS[:5],
    device: DeviceLike = "cuda",
    use_kernel: Optional[bool] = None,
) -> CompiledFeaturizer:
    """Build the kernels and warm featurization for every (B, bucket) pair.

    Args:
        batch_sizes: exact batch sizes to warm (requests round up).
        buckets: residue-length buckets to warm.
        device: where the featurizer runs; ``"cuda"`` without a card raises.
        use_kernel: pair maps through K1 (``True``) or the arccos form
            (``False``); ``None`` takes K1 on a CUDA device and the arccos
            form on the CPU, as the JAX package takes Pallas only on a TPU.

    Returns a :class:`CompiledFeaturizer`.  A kernel that does not build
    raises here, not on the first request.
    """
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    shapes = [(B, L) for B in batch_sizes for L in buckets]
    with torch.inference_mode():
        for B, L in shapes:
            xyz = torch.full((B, L, MAX_N_ATOMS_PER_RESIDUE, 3), float("nan"),
                             device=dev)
            am = torch.zeros((B, L, MAX_N_ATOMS_PER_RESIDUE), dtype=torch.bool,
                             device=dev)
            ci = torch.full((B, L), PAD_IDX, dtype=torch.int32, device=dev)
            _featurize(xyz, am, ci, use_kernel)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return CompiledFeaturizer(shapes, buckets, dev, use_kernel)
