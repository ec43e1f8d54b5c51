"""Timing-only probes of K1 and K3, the pair-map kernels on one tile skeleton.

    python -m protstruc_tpu_torch.experiments.pair_tile_probe

Each probe is the checkout's own ``csrc/pair_maps.cu`` or
``csrc/model_features.cu`` (with ``csrc/pair_maps.cuh``) with one phase
dropped or one choice changed, made by replacing a line of the source (each
anchor is checked, so a probe fails loudly once the source moves on), built
with the library's own nvcc flags, and timed at B=256, L=512 (``randn * 10``,
numpy seed 0) beside the kernel as it stands, in turns, by CUDA events:

* ``no stores``: the values are computed and not written (a test no value
  passes guards the store);
* ``no i-side hoist``: residue i's terms (``PairI``) are built for every
  pair and map again, as before the split, not once a row;
* ``no arithmetic``: a staged coordinate is written where each value was;
* K1 at 2 and 3 blocks an SM (its launch bounds; the kernel runs 4), and on
  a persistent grid of 4 blocks an SM walking the tiles (``tile_plan``'s
  grid clamped there; the wrappers launch one block a tile);
* K3's f32 planes stored straight from each lane, and its bf16 planes
  through the shared transpose that its f32 planes take.

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

from protstruc_tpu_torch.ops import cuda_lib, model_features, pair_maps

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
}

# probes that change the launch plan, not the source: blocks an SM of the grid
_GRID_BLOCKS_PER_SM = {("K1", "persistent grid"): 4}

_MAIN = {"K1": "pair_maps.cu", "K3": "model_features.cu"}
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
    proc = subprocess.run([cuda_lib.find_nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(d), "-o", str(so),
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


def main(argv: Sequence[str] = ()) -> int:
    if not torch.cuda.is_available():
        print("pair_tile_probe: no CUDA device; the probes run only on the card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    out_dir = cuda_lib.BUILD_DIR / "probes"
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        libs = dict(zip(VARIANTS, ex.map(lambda kp: _build(*kp, out_dir), VARIANTS)))
    dev = torch.device("cuda", 0)
    xyz = torch.from_numpy(np.random.RandomState(0).randn(256, 512, 15, 3).astype(np.float32)
                           * 10).to(dev)
    calls = {"K1": (("pair_maps", pair_maps.load_library),
                    {"f32": lambda: pair_maps.pairwise_maps_forward(xyz),
                     "bf16": lambda: pair_maps.pairwise_maps_forward(xyz, out_dtype=torch.bfloat16)}),
             "K3": (("model_features", model_features.load_library),
                    {"bf16": lambda: model_features.model_features(xyz, 36, 20.0, torch.bfloat16),
                     "f32": lambda: model_features.model_features(xyz, 36, 20.0, torch.float32)})}
    kept = {stem: cuda_lib._LIBS.get(stem) for stem in ("pair_maps", "model_features")}
    max_grid, sms = pair_maps._MAX_GRID, torch.cuda.get_device_properties(dev).multi_processor_count
    times: Dict[Tuple[str, str, str], list] = {}
    try:
        for rnd in range(2):
            for kernel, probe in (list(VARIANTS) if rnd == 0 else list(VARIANTS)[::-1]):
                (stem, load), fns = calls[kernel]
                cuda_lib._LIBS[stem] = ctypes.CDLL(str(libs[(kernel, probe)]))
                load()
                pair_maps._MAX_GRID = _GRID_BLOCKS_PER_SM.get((kernel, probe), 0) * sms or max_grid
                for dtype, fn in fns.items():
                    times.setdefault((kernel, probe, dtype), []).append(_time_ms(fn))
                pair_maps._MAX_GRID = max_grid
    finally:
        pair_maps._MAX_GRID = max_grid
        for stem, lib in kept.items():
            if lib is None:
                cuda_lib._LIBS.pop(stem, None)
            else:
                cuda_lib._LIBS[stem] = lib
    for (kernel, probe, dtype), ms in times.items():
        print(f"[{smi}] {kernel} {dtype:>4} B=256 L=512 {probe:<26} "
              + ", ".join(f"{t:.4f}" for t in ms) + " ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
