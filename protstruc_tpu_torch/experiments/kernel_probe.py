"""Roofline probes of the pair-map kernel K1 on the card.

Port of ``experiments/kernel_probe.py``: run on a machine with an NVIDIA
Hopper GPU (``sm_90a``) as

    python -m protstruc_tpu_torch.experiments.kernel_probe [packed] [sweep]

It times, at B=256, L=512 (``randn * 10``, numpy seed 0), variants of K1 that
isolate where its time goes (``csrc/pair_maps_probe.cu``):

  full         K1's arithmetic and stores (the code K1 runs)
  write-only   the same six ``(B, L, L)`` outputs, each ``|CA_i - CA_j|``: K1's
               stores with about a twentieth of its arithmetic
  dist3        the three distance maps (half the stores)
  opt-dN[-fdiv]  K1 with the TPU kernel's odd minimax atan2 of degree N
               (9, 11, 13, 15), the ratio by an exact divide or ``-fdiv``'s
               ``min * rsqrt(max^2)``

``packed`` adds ``dist3`` and one plane-major ``(B, 6, L, L)`` output (P2) at
block j-widths 32, 64 and 128 (the TPU probe's ``tile_j`` 128/256/512);
``sweep`` times only ``full`` and ``write-only`` over block shapes around
K1's 32 x 8 (P3, the TPU probe's ``tile_i`` sweep).  Each line: name, ms
(CUDA events, 2 warm-up + 10 timed), maps, GB written, effective GB/s.  If
``write-only`` is close to ``full``, K1 is bound by its stores; if it is much
faster, by its arithmetic.

:func:`probe` launches a variant on a CUDA tensor (or raises) and takes
:func:`probe_plain`, its plain PyTorch version, on a CPU tensor.  Nothing on a
main path of the package calls either.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch

from protstruc_tpu_torch.ops import cuda_lib
from protstruc_tpu_torch.ops.pair_maps import MAP_NAMES, _check_maps, _pair_maps_plain

__all__ = ["VARIANTS", "K1_BLOCK", "PACKED_BLOCKS", "SWEEP_BLOCKS", "probe", "probe_plain",
           "poly_atan2", "run_variant", "run_packed_variant", "packed_variants", "tile_sweep",
           "load_library", "library_path", "LAUNCHES", "main"]

B, L = 256, 512
WARMUP, ITERS = 2, 10
_SOURCES = ("pair_maps_probe.cu",)
_DEGREES = (9, 11, 13, 15)

#: variant name -> the kernel's op code
VARIANTS: Dict[str, int] = {"full": 0, "write-only": 1}
VARIANTS.update({f"opt-d{d}{'-fdiv' if f else ''}": 2 + 2 * n + f
                 for n, d in enumerate(_DEGREES) for f in (0, 1)})
#: (threads along j, threads along i, pairs per thread down i)
K1_BLOCK = (32, 8, 1)
PACKED_BLOCKS = ((32, 8, 1), (64, 4, 1), (128, 2, 1))
SWEEP_BLOCKS = ((32, 4, 1), (32, 8, 1), (32, 16, 1), (32, 8, 2), (32, 8, 4))
_BLOCKS = {"full": set(PACKED_BLOCKS) | set(SWEEP_BLOCKS), "write-only": set(SWEEP_BLOCKS)}

#: the TPU probe's polynomial coefficients (c1, c3, c5, ...) by degree
_POLY = {
    9: (9.998663318e-01, -3.303047936e-01, 1.801592832e-01, -8.515630106e-02,
        2.084508111e-02),
    11: (9.999772197e-01, -3.326228327e-01, 1.935403833e-01, -1.164264699e-01,
         5.264731915e-02, -1.171911837e-02),
    13: (9.999961117e-01, -3.331736824e-01, 1.980781622e-01, -1.323334264e-01,
         7.962366137e-02, -3.360419960e-02, 6.811783856e-03),
    15: (9.999999228e-01, -3.333223262e-01, 1.997402858e-01, -1.404782123e-01,
         1.000220526e-01, -6.087448222e-02, 2.533170106e-02, -5.021063911e-03),
}
_PI, _PI_2 = 3.141592653589793, 1.5707963267948966

#: Probe launches made by :func:`probe` in this process.
LAUNCHES = 0


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the probe library; raises if it cannot."""
    lib = cuda_lib.load("pair_maps_probe", _SOURCES)
    fn = lib.ps_pair_maps_probe_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p])
    return lib


def library_path():
    """Where the probe library is built (keyed by its source and flags)."""
    return cuda_lib.library_path("pair_maps_probe", _SOURCES)


def _check(variant: str, block: Tuple[int, int, int]) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown probe variant {variant!r}; valid: {tuple(VARIANTS)}")
    if block != K1_BLOCK and block not in _BLOCKS.get(variant, ()):
        raise ValueError(f"probe variant {variant!r} has no block {block}")


def probe(xyz: torch.Tensor, variant: str = "full", maps: Sequence[str] = MAP_NAMES,
          block: Tuple[int, int, int] = K1_BLOCK, packed: bool = False
          ) -> Union[Dict[str, torch.Tensor], torch.Tensor]:
    """One probe variant's maps of ``xyz (B, L, A, 3)``: a dict of ``(B, L, L)``
    f32 maps, or with ``packed`` (all six maps) one ``(B, 6, L, L)`` tensor.

    A CUDA tensor launches the probe kernel with ``block``; a CPU tensor
    takes :func:`probe_plain` (``block`` changes no value).
    """
    global LAUNCHES
    maps = _check_maps(maps)
    _check(variant, block)
    if packed and maps != MAP_NAMES:
        raise ValueError("a packed probe writes all six maps")
    if xyz.device.type == "cpu":
        return probe_plain(xyz, variant, maps, packed)
    if xyz.device.type != "cuda":
        raise ValueError(f"probe has no implementation for device {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 4 or xyz.shape[2] < 5 or xyz.shape[3] != 3:
        raise ValueError(f"probe takes float32 xyz (B, L, A>=5, 3), got {xyz.dtype} "
                         f"{tuple(xyz.shape)}")
    if not xyz.is_contiguous() or xyz.shape[0] > 65535:
        raise ValueError("probe takes a contiguous xyz with B <= 65535")
    Bx, Lx, A, _ = xyz.shape
    if packed:
        out = torch.empty((Bx, 6, Lx, Lx), dtype=torch.float32, device=xyz.device)
        ptrs = [out[:, k].data_ptr() for k in range(6)]
        bstride = 6 * Lx * Lx
    else:
        out = {k: torch.empty((Bx, Lx, Lx), dtype=torch.float32, device=xyz.device)
               for k in maps}
        ptrs = [out[k].data_ptr() if k in out else None for k in MAP_NAMES]
        bstride = Lx * Lx
    if Bx == 0 or Lx == 0:
        return out
    bits = sum(1 << MAP_NAMES.index(k) for k in maps)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = load_library().ps_pair_maps_probe_f32(
        xyz.device.index, VARIANTS[variant], *block, xyz.data_ptr(), Bx, Lx, A, bits, *ptrs,
        bstride, stream)
    if err != 0:
        raise RuntimeError(f"probe {variant} {block} launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def poly_atan2(deg: int, fast_div: bool) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The TPU probe's atan2 (``_make_opt_kernel``'s ``atan2_opt`` with the
    NaN re-where kept) in plain PyTorch, in the kernel's order of operations."""
    coeffs = [float(np.float32(c)) for c in _POLY[deg]]

    def atan2(y, x):
        ax, ay = x.abs(), y.abs()
        maxv, minv = torch.maximum(ax, ay), torch.minimum(ax, ay)
        if fast_div:
            safe = torch.where(maxv == 0.0, 1.0, maxv)
            t = minv * torch.rsqrt(safe * safe)
        else:
            t = minv / torch.where(maxv == 0.0, 1.0, maxv)
        zz = t * t
        p = torch.full_like(t, coeffs[-1])
        for c in coeffs[-2::-1]:
            p = p * zz + c
        p = p * t
        r = torch.where(ay > ax, _PI_2 - p, p)
        r = torch.where(x < 0.0, _PI - r, r)
        r = torch.where(y < 0.0, -r, r)
        return torch.where(torch.isnan(x) | torch.isnan(y), torch.nan, r)

    return atan2


def probe_plain(xyz: torch.Tensor, variant: str = "full", maps: Sequence[str] = MAP_NAMES,
                packed: bool = False) -> Union[Dict[str, torch.Tensor], torch.Tensor]:
    """A probe variant in plain PyTorch: full is K1's plain version,
    write-only its ``d_ca`` repeated, ``opt-*`` K1's plain version with
    :func:`poly_atan2`; packed stacks the six maps plane-major."""
    maps = _check_maps(maps)
    _check(variant, K1_BLOCK)
    if variant == "write-only":
        d = _pair_maps_plain(xyz, ("d_ca",))["d_ca"]
        out = {k: d for k in maps}
    elif variant == "full":
        out = _pair_maps_plain(xyz, maps)
    else:
        deg, fast_div = int(variant.split("-")[1][1:]), variant.endswith("-fdiv")
        out = _pair_maps_plain(xyz, maps, atan2=poly_atan2(deg, fast_div))
    if packed:
        return torch.stack([out[k] for k in MAP_NAMES], 1)
    return out


def _time_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def run_variant(name: str, xyz: torch.Tensor, variant: str, maps: Sequence[str] = MAP_NAMES,
                block: Tuple[int, int, int] = K1_BLOCK, log=print) -> float:
    """P1: time one variant into separate ``(B, L, L)`` outputs; logs the TPU
    probe's line and returns ms per call."""
    ms = _time_ms(lambda: probe(xyz, variant, maps, block))
    gb = len(maps) * xyz.shape[0] * xyz.shape[1] ** 2 * 4 / 1e9
    log(f"[{name:>10}] {ms:.4f} ms  ({len(maps)} maps, {gb:.2f} GB written, "
        f"{gb / ms * 1e3:.0f} GB/s effective)")
    return ms


def run_packed_variant(name: str, xyz: torch.Tensor, variant: str,
                       block: Tuple[int, int, int] = K1_BLOCK, log=print) -> float:
    """P2: time one variant into one plane-major ``(B, 6, L, L)`` output."""
    ms = _time_ms(lambda: probe(xyz, variant, block=block, packed=True))
    gb = 6 * xyz.shape[0] * xyz.shape[1] ** 2 * 4 / 1e9
    log(f"[{name:>16}] {ms:.4f} ms  (packed 6-plane, {gb:.2f} GB written, "
        f"{gb / ms * 1e3:.0f} GB/s effective)")
    return ms


def packed_variants() -> Dict[str, Tuple[str, Tuple[int, int, int]]]:
    """P2's variants: name -> (variant, block)."""
    out = {"write-only-packed": ("write-only", K1_BLOCK)}
    out.update({f"full-packed-j{bj}": ("full", (bj, bi, bp)) for bj, bi, bp in PACKED_BLOCKS})
    return out


def tile_sweep(xyz: torch.Tensor, log=print) -> Dict[Tuple[str, Tuple[int, int, int]], float]:
    """P3: full and write-only over the block shapes of :data:`SWEEP_BLOCKS`."""
    res = {}
    gb = 6 * xyz.shape[0] * xyz.shape[1] ** 2 * 4 / 1e9
    for variant in ("full", "write-only"):
        for block in SWEEP_BLOCKS:
            ms = _time_ms(lambda: probe(xyz, variant, block=block))
            res[(variant, block)] = ms
            log(f"[{variant} {block[0]}x{block[1]}x{block[2]}] {ms:.4f} ms  "
                f"({gb / ms * 1e3:.0f} GB/s)")
    return res


def main(argv: Sequence[str] = ()) -> int:
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device; the probes run on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}")
    xyz = torch.from_numpy(np.random.RandomState(0).randn(B, L, 15, 3).astype(np.float32)
                           * 10).to(dev)
    if "sweep" in argv:
        tile_sweep(xyz)
        return 0
    run_variant("full", xyz, "full")
    run_variant("write-only", xyz, "write-only")
    if "packed" in argv:
        run_variant("dist3", xyz, "full", maps=("d_ca", "d_cb", "d_no"))
        for name, (variant, block) in packed_variants().items():
            run_packed_variant(name, xyz, variant, block)
    # the (degree, divide) grid, two passes each to see through run variance
    results = {}
    for rep in range(2):
        for name in [v for v in VARIANTS if v.startswith("opt")] + ["full"]:
            results[name] = min(results.get(name, float("inf")),
                                run_variant(f"{name}#{rep}", xyz, name))
    for name, ms in sorted(results.items(), key=lambda kv: kv[1]):
        print(f"BEST {name:>14}: {ms:.4f} ms  ({B / ms * 1e3:.0f} structures/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
