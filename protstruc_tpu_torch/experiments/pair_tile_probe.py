"""Timing-only probes of the port's tile kernels: K1 and K3, the pair-map
kernels on one tile skeleton, and the backward kernels K2 and K9.

    python -m protstruc_tpu_torch.experiments.pair_tile_probe [K1 K2 K3 K9]

Each probe is the checkout's own ``csrc/pair_maps.cu``,
``csrc/model_features.cu``, ``csrc/pair_maps_bwd.cu`` or
``csrc/flash_attn.cu`` (with the headers) with one phase
dropped or one choice changed, made by replacing a line of the source (each
anchor is checked, so a probe fails loudly once the source moves on), built
with the library's own nvcc flags, and timed beside the kernel as it
stands, in turns, by CUDA events: K1, K2 and K3 at B=256, L=512 (``randn *
10``, numpy seed 0; K2 with six ``randn`` cotangents from a card generator
seeded 1), K9 at the FoldModel train shape (f32, B=4, H=4, dh=32, L=256,
the bias permuted from (B, L, L, H)) and bench.py's ``[attn]`` shape (bf16,
B=1, H=8, dh=32, L=4096, last 100 keys masked), lse and delta from its
plain forward.  The probes:

* ``no stores``: the values are computed and not written (a test no value
  passes guards the store);
* ``no i-side hoist``: residue i's terms (``PairI``) are built for every
  pair and map again, as before the split, not once a row;
* ``no arithmetic``: a staged coordinate is written where each value was;
* K1 at 2 and 3 blocks an SM (its launch bounds; the kernel runs 4), and on
  a persistent grid of 4 blocks an SM walking the tiles (``tile_plan``'s
  grid clamped there; the wrappers launch one block a tile);
* K3's f32 planes stored straight from each lane, and its bf16 planes
  through the shared transpose that its f32 planes take;
* K2 at 2 and 4 blocks an SM (its launch bounds; the kernel runs 3), at 2
  pairs a lane (64-column tiles, the plan's tile shape changed with the
  source), and with the j atoms read from the stage where each map needs
  them (volatile loads, map by map) rather than once a pair;
* K9's bf16 instantiations at dh <= 32 at any register count (the kernel
  holds them to 128 for four blocks an SM).

A probe that drops a phase computes wrong values by design; its outputs are
never read.  The card's name and power limit head the output.  This module
imports torch and numpy only; it runs only on the card.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import subprocess
import sys
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from protstruc_tpu_torch.ops import cuda_lib, flash_attn, model_features, pair_maps

__all__ = ["VARIANTS", "variant_sources", "main"]

# an expression that reads each float through an opaque move, so that the
# compiler cannot reuse what it computed from the same atoms before
_LAUNDER = '''
__device__ __forceinline__ float launder(float x) {
  asm volatile("mov.f32 %0, %0;" : "+f"(x));
  return x;
}
__device__ __forceinline__ V3 launder(V3 a) { return V3{launder(a.x), launder(a.y), launder(a.z)}; }
'''

# (kernel, probe) -> {file: [(anchor, replacement)]}
VARIANTS: Dict[Tuple[str, str], Dict[str, Sequence[Tuple[str, str]]]] = {
    ("K1", "as built"): {},
    ("K1", "no stores"): {"pair_maps.cu": [(
        "      store_run(planes[k] + o, v, n, vec);",
        "      if (v[0] + v[1] + v[2] + v[3] == 1234567.0f) store_run(planes[k] + o, v, n, vec);")]},
    ("K1", "no i-side hoist"): {"pair_maps.cu": [
        ("// one map's value of one pair", _LAUNDER + "// one map's value of one pair"),
        ("        pair_maps_pair(I, pair_j(",
         "        pair_maps_pair(pair_i(launder(I.n), launder(I.ca), launder(I.cb), bit), pair_j(")]},
    ("K1", "no arithmetic"): {"pair_maps.cu": [(
        "        pair_maps_pair(I, pair_j(ca[q], cb[q], ox[q], bit), bit, Atan2f{}, ValueStore{&v[q]});",
        "        v[q] = I.ca.x - ca[q].x + cb[q].y + ox[q].z;")]},
    ("K1", "3 blocks an SM"): {"pair_maps.cu": [(
        "__launch_bounds__(kPairThreads, 4)", "__launch_bounds__(kPairThreads, 3)")]},
    ("K1", "2 blocks an SM"): {"pair_maps.cu": [(
        "__launch_bounds__(kPairThreads, 4)", "__launch_bounds__(kPairThreads, 2)")]},
    ("K1", "persistent grid"): {},
    ("K3", "as built"): {},
    ("K3", "no stores"): {"model_features.cu": [(
        "    if (!vec) {\n",
        "    {\n      float s = 0.0f;\n      for (int q = 0; q < kPairsJ; ++q)\n"
        "        for (int k = 0; k < 6; ++k) s += v[q][k] + bn[q];\n"
        "      if (s != 1234567.0f) return;\n    }\n    if (!vec) {\n")]},
    ("K3", "no i-side hoist"): {"model_features.cu": [
        ("// one pair's bin and its six planes", _LAUNDER + "// one pair's bin and its six planes"),
        ("      features_pair(I, pair_j(",
         "      features_pair(pair_i(launder(I.n), launder(I.ca), launder(I.cb), kAllMaps), pair_j(")]},
    ("K3", "no arithmetic"): {"model_features.cu": [(
        "      features_pair(I, pair_j(ca, cb, ca, kAllMaps), n_bins, ratio, max_dist, &bn[q], v[q]);",
        "      bn[q] = (int32_t)ca.x;\n      for (int k = 0; k < 6; ++k) v[q][k] = I.ca.x - cb.y + k;")]},
    ("K3", "f32 planes from the lane"): {"model_features.cu": [(
        "  static constexpr bool kTranspose = sizeof(T) == 4;",
        "  static constexpr bool kTranspose = false;")]},
    ("K3", "bf16 planes transposed"): {"model_features.cu": [(
        "  static constexpr bool kTranspose = sizeof(T) == 4;",
        "  static constexpr bool kTranspose = true;")]},
    ("K2", "as built"): {},
    ("K2", "2 blocks an SM"): {"pair_maps_bwd.cu": [(
        "__launch_bounds__(kPairThreads, 3)", "__launch_bounds__(kPairThreads, 2)")]},
    ("K2", "4 blocks an SM"): {"pair_maps_bwd.cu": [(
        "__launch_bounds__(kPairThreads, 3)", "__launch_bounds__(kPairThreads, 4)")]},
    ("K2", "2 pairs a lane"): {"pair_maps.cuh": [(
        "constexpr int kPairsJ = 4; ", "constexpr int kPairsJ = 2; ")]},
    ("K2", "j atoms map by map"): {"pair_maps_bwd.cu": [(
        "      const V3 ca_j{sc[0], sc[kJStride], sc[2 * kJStride]};\n"
        "      const V3 cb_j{sc[3 * kJStride], sc[4 * kJStride], sc[5 * kJStride]};\n"
        "      const V3 o_j{sc[6 * kJStride], sc[7 * kJStride], sc[8 * kJStride]};\n"
        "      float aj[kSide] = {};\n"
        "      pair_bwd(I, ca_j, cb_j, o_j, mask, g, ai, aj);\n",
        "      float aj[kSide] = {};\n"
        "      const volatile float* vc = sc;\n"
        "#pragma unroll\n"
        "      for (int m = 0; m < 6; ++m) {\n"
        "        const int bit = 1 << m;\n"
        "        if (!(mask & bit)) continue;\n"
        "        V3 ca_j{}, cb_j{}, o_j{};\n"
        "        if (bit & (kDCa | kOmega)) ca_j = V3{vc[0], vc[kJStride], vc[2 * kJStride]};\n"
        "        if (bit & (kDCb | kOmega | kTheta | kPhi))\n"
        "          cb_j = V3{vc[3 * kJStride], vc[4 * kJStride], vc[5 * kJStride]};\n"
        "        if (bit & kDNo) o_j = V3{vc[6 * kJStride], vc[7 * kJStride], vc[8 * kJStride]};\n"
        "        pair_bwd(I, ca_j, cb_j, o_j, bit, g, ai, aj);\n"
        "      }\n")]},
    ("K9", "as built"): {},
    ("K9", "bf16 dh <= 32 unbounded"): {"flash_attn.cu": [(
        "__launch_bounds__(kBwdWarps * 32, (sizeof(T) == 2 && DH <= 32) ? 4 : 1)",
        "__launch_bounds__(kBwdWarps * 32)")]},
}

# probes that change the launch plan: blocks an SM of the grid, and the tile
# shape the plan hands the kernel (pair_maps.PAIR_TILE)
_GRID_BLOCKS_PER_SM = {("K1", "persistent grid"): 4}
_PAIR_TILE = {("K2", "2 pairs a lane"): (2, 64, 32, 8)}

_MAIN = {"K1": "pair_maps.cu", "K2": "pair_maps_bwd.cu", "K3": "model_features.cu",
         "K9": "flash_attn.cu"}
_FLAGS = {"K9": cuda_lib.NVCC_FLAGS_FMA}   # the others: cuda_lib.NVCC_FLAGS
_HEADERS = ("pair_maps.cuh", "device_scope.cuh", "mma.cuh")


def variant_sources(kernel: str, probe: str) -> Dict[str, str]:
    """The probe's sources by file name (its kernel's .cu and the headers),
    each anchor replaced exactly once; raises if an anchor is missing."""
    files = {name: (cuda_lib.CSRC / name).read_text() for name in (_MAIN[kernel], *_HEADERS)}
    for name, subs in VARIANTS[(kernel, probe)].items():
        for anchor, repl in subs:
            if files[name].count(anchor) != 1:
                raise RuntimeError(f"probe {kernel} {probe!r}: anchor not found once in {name}: "
                                   f"{anchor.splitlines()[0]!r}")
            files[name] = files[name].replace(anchor, repl)
    return files


def _build(kernel: str, probe: str, out_dir: pathlib.Path) -> pathlib.Path:
    d = out_dir / f"{kernel}-{probe.replace(' ', '_')}"
    d.mkdir(parents=True, exist_ok=True)
    for name, text in variant_sources(kernel, probe).items():
        (d / name).write_text(text)
    so = d / "lib.so"
    flags = _FLAGS.get(kernel, cuda_lib.NVCC_FLAGS)
    proc = subprocess.run([cuda_lib.find_nvcc(), *flags, "-I", str(d), "-o", str(so),
                           str(d / _MAIN[kernel])], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for probe {kernel} {probe!r}:\n{proc.stdout}{proc.stderr}")
    return so


def _time_ms(fn: Callable[[], object], warmup: int = 2, iters: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _flash_args(dev, dtype, B, H, dh, L, permuted, masked, seed=0):
    """K9's arguments at one shape: q, k, v views of one projection, the
    bias (permuted from (B, L, L, H) or contiguous), the last ``masked``
    keys off, dO, and lse and delta from the plain forward."""
    gen = torch.Generator(dev).manual_seed(seed)
    qkv = torch.randn((B, L, 3, H, dh), generator=gen, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if permuted:
        bias = torch.randn((B, L, L, H), generator=gen, device=dev).to(dtype).permute(0, 3, 1, 2)
    else:
        bias = torch.randn((B, H, L, L), generator=gen, device=dev).to(dtype)
    kmask = torch.ones((B, L), dtype=torch.bool, device=dev)
    if masked:
        kmask[:, -masked:] = False
    do = torch.randn((B, L, H, dh), generator=gen, device=dev).to(dtype)
    out, lse = flash_attn._flash_fwd_plain(q, k, v, bias, kmask)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, bias, kmask, do, lse, delta


def _load_flash():
    flash_attn._LIB = None
    return flash_attn.load_library()


def main(argv: Sequence[str] = ()) -> int:
    if not torch.cuda.is_available():
        print("pair_tile_probe: no CUDA device; the probes run only on the card", file=sys.stderr)
        return 1
    kernels = tuple(argv) or tuple(_MAIN)
    unknown = set(kernels) - set(_MAIN)
    if unknown:
        print(f"pair_tile_probe: unknown kernels {sorted(unknown)}; known: {sorted(_MAIN)}",
              file=sys.stderr)
        return 2
    variants = [kp for kp in VARIANTS if kp[0] in kernels]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = cuda_lib.BUILD_DIR / "probes"
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        libs = dict(zip(variants, ex.map(lambda kp: _build(*kp, out_dir), variants)))
    dev = torch.device("cuda", 0)
    xyz = torch.from_numpy(np.random.RandomState(0).randn(256, 512, 15, 3).astype(np.float32)
                           * 10).to(dev)
    calls = {"K1": (("pair_maps", pair_maps.load_library),
                    {"f32 B=256 L=512": lambda: pair_maps.pairwise_maps_forward(xyz),
                     "bf16 B=256 L=512": lambda: pair_maps.pairwise_maps_forward(
                         xyz, out_dtype=torch.bfloat16)}),
             "K3": (("model_features", model_features.load_library),
                    {"bf16 B=256 L=512": lambda: model_features.model_features(
                        xyz, 36, 20.0, torch.bfloat16),
                     "f32 B=256 L=512": lambda: model_features.model_features(
                         xyz, 36, 20.0, torch.float32)})}
    if "K2" in kernels:
        gen = torch.Generator(dev).manual_seed(1)
        g = {k: torch.randn((256, 512, 512), generator=gen, device=dev) for k in pair_maps.MAP_NAMES}
        calls["K2"] = (("pair_maps_bwd", pair_maps.load_bwd_library),
                       {"f32 B=256 L=512 six maps": lambda: pair_maps.maps_bwd(xyz, g)})
    if "K9" in kernels:
        train = _flash_args(dev, torch.float32, 4, 4, 32, 256, permuted=True, masked=0)
        attn = _flash_args(dev, torch.bfloat16, 1, 8, 32, 4096, permuted=False, masked=100)
        calls["K9"] = (("flash_attn", _load_flash),
                       {"f32 train B=4 H=4 dh=32 L=256": lambda: flash_attn.flash_bwd(*train),
                        "bf16 [attn] B=1 H=8 dh=32 L=4096": lambda: flash_attn.flash_bwd(*attn)})
    kept = {stem: cuda_lib._LIBS.get(stem) for stem in ("pair_maps", "model_features", "pair_maps_bwd",
                                                         "flash_attn")}
    kept_flash = flash_attn._LIB
    max_grid, sms = pair_maps._MAX_GRID, torch.cuda.get_device_properties(dev).multi_processor_count
    pair_tile = pair_maps.PAIR_TILE
    times: Dict[Tuple[str, str, str], list] = {}
    try:
        for rnd in range(2):
            for kernel, probe in (variants if rnd == 0 else variants[::-1]):
                (stem, load), fns = calls[kernel]
                cuda_lib._LIBS[stem] = ctypes.CDLL(str(libs[(kernel, probe)]))
                load()
                pair_maps._MAX_GRID = _GRID_BLOCKS_PER_SM.get((kernel, probe), 0) * sms or max_grid
                pair_maps.PAIR_TILE = _PAIR_TILE.get((kernel, probe), pair_tile)
                for shape, fn in fns.items():
                    times.setdefault((kernel, probe, shape), []).append(_time_ms(fn))
                pair_maps._MAX_GRID, pair_maps.PAIR_TILE = max_grid, pair_tile
    finally:
        pair_maps._MAX_GRID, pair_maps.PAIR_TILE = max_grid, pair_tile
        flash_attn._LIB = kept_flash
        for stem, lib in kept.items():
            if lib is None:
                cuda_lib._LIBS.pop(stem, None)
            else:
                cuda_lib._LIBS[stem] = lib
    for (kernel, probe, shape), ms in times.items():
        print(f"[{smi}] {kernel} {shape} {probe:<26} " + ", ".join(f"{t:.4f}" for t in ms) + " ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
