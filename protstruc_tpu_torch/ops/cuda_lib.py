"""Build and load the port's hand-written CUDA kernels.

Each kernel library is a plain-C shared object compiled by ``nvcc`` from the
sources under ``protstruc_tpu_torch/csrc/`` at first use, and bound with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The build lands in
``protstruc_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.  Each
library names its own flags (:data:`NVCC_FLAGS` or :data:`NVCC_FLAGS_FMA`).
The compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, Optional, Sequence

__all__ = ["NVCC_FLAGS", "NVCC_FLAGS_FMA", "CSRC", "BUILD_DIR", "find_nvcc", "library_path", "load"]

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later kernels.
#: No ``--use_fast_math``, and ``-fmad=false``: each operation rounds once, as
#: in the plain PyTorch versions the kernels are held to (a contracted cross
#: product differs from the plain one by far more than an ulp where the
#: dihedral is ill-conditioned).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: The same without ``-fmad=false``: nvcc contracts ``a * b + c`` into one
#: FMA.  For the matrix-product kernels (``csrc/tri_mul.cu``), whose FMA loops
#: would otherwise take a multiply and an add per step; their plain versions
#: are float32 matrix products, which round the same way.
NVCC_FLAGS_FMA = tuple(f for f in NVCC_FLAGS if f != "-fmad=false")

_LIBS: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> Optional[str]:
    """Path of ``nvcc`` from the CUDA toolkit PyTorch resolves, else ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    return shutil.which("nvcc")


def library_path(stem: str, sources: Sequence[str],
                 flags: Sequence[str] = NVCC_FLAGS) -> pathlib.Path:
    """Where ``lib<stem>`` built from ``sources`` with ``flags`` lives (keyed
    by their hash)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sources:
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def load(stem: str, sources: Sequence[str],
         flags: Sequence[str] = NVCC_FLAGS) -> ctypes.CDLL:
    """Compile (once per source and flag hash) and ``dlopen`` ``lib<stem>``.

    Raises ``RuntimeError`` when ``nvcc`` is missing or the build fails: a
    kernel that cannot be built is an error, never a silent fallback.
    """
    lib = _LIBS.get(stem)
    if lib is not None:
        return lib
    out = library_path(stem, sources, flags)
    if not out.is_file():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"cannot build lib{stem}: no nvcc (set CUDA_HOME or put nvcc on PATH)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *flags, "-o", str(tmp), *(str(CSRC / s) for s in sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for lib{stem} (rc {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    _LIBS[stem] = lib
    return lib
