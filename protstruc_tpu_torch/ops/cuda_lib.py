"""Build and load the port's hand-written CUDA kernels.

Each kernel library is a plain-C shared object compiled by ``nvcc`` from the
sources under ``protstruc_tpu_torch/csrc/`` at first use, and bound with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The build lands in
``protstruc_tpu_torch/_build/`` under a name keyed by a hash of the sources
and flags, so an edited source rebuilds and an unchanged one is reused.  Each
library names its own flags (:data:`NVCC_FLAGS` or :data:`NVCC_FLAGS_FMA`).
The compiler's output (``-Xptxas -v``: registers, shared memory, spills) is
kept beside the library as ``<name>.log``; :func:`ptxas_lines` reads it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
from typing import Dict, Optional, Sequence

__all__ = ["NVCC_FLAGS", "NVCC_FLAGS_FMA", "CSRC", "BUILD_DIR", "find_nvcc", "library_path", "load",
           "nested_name", "ptxas_lines"]

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
    by their hash and that of the shared headers, ``csrc/*.cuh``)."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in [CSRC / s for s in sources] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
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


def nested_name(mangled):
    """The last name of a mangled ``_ZN<len><name>...E...`` entry (a kernel in
    an anonymous namespace), else ``mangled``."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name


def ptxas_lines(log_path):
    """One line per kernel from an ``nvcc -Xptxas -v`` log: its (demangled
    enough) name, registers, stack and spills."""
    if not log_path.is_file():
        return []
    out, name = [], None
    for ln in log_path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            spill = ""
            k = re.search(r"\d+([a-z_]+_kernel)I((?:f|13__nv_bfloat16|L[ib]\d+E)+)E", m.group(1))
            args = [{"f": "float", "13__nv_bfloat16": "bf16", "Lb1E": "true", "Lb0E": "false"}.get(a, a[2:-1])
                    for a in re.findall(r"f|13__nv_bfloat16|L[ib]\d+E", k.group(2))] if k else []
            row = re.search(r"RowArgsI(f|13__nv_bfloat16)E", m.group(1))  # an overload on the rows' dtype
            if k and row and all(a in ("true", "false") for a in args):
                args = [{"f": "float"}.get(row.group(1), "bf16"), *args]
            name = f"{k.group(1)}<{', '.join(args)}>" if k else nested_name(m.group(1))
        elif "spill" in ln and name:
            spill = ln.strip()
        elif "registers" in ln and name:
            out.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out
