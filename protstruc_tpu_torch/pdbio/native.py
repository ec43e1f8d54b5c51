"""ctypes binding of the C++ PDB atom-record scanner (``csrc/pdb_parser.cpp``).

The port of ``protstruc_tpu/pdbio/native.py``.  The shared library is built at
first use with ``g++ -O3 -shared -fPIC -std=c++17`` into
``protstruc_tpu_torch/_build/`` under a name keyed by a hash of the source
(as ``ops/cuda_lib.py`` keys the kernel builds), then ``dlopen``-ed.  The
build writes a file of its own process's name and renames it into place, so
processes that build at once do not race.

Without ``g++`` on ``PATH`` the scanner is unavailable: :func:`load_native`
returns None and ``parse_pdb`` takes the NumPy scanner.  With ``g++`` present
a failed build raises, with the compiler's output; nothing falls back
without a word.

:data:`CALLS` counts the scans this scanner made (``parse_atom_records_native``
calls that reached the library), so a caller can show that a path ran it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import numpy as np

from protstruc_tpu_torch.ops.cuda_lib import BUILD_DIR, CSRC

__all__ = ["load_native", "parse_atom_records_native", "native_available", "CALLS"]

SOURCE = CSRC / "pdb_parser.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

#: Scans made by the C++ scanner in this process.
CALLS = 0

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path():
    """Where the scanner built from :data:`SOURCE` with :data:`CXX_FLAGS` lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpspdb-{h.hexdigest()[:16]}.so"


def load_native() -> Optional[ctypes.CDLL]:
    """Build (once per source hash) and load the scanner.

    Returns None when there is no ``g++`` on ``PATH`` and no build of this
    source; raises ``RuntimeError`` with the compiler's output when the build
    fails.
    """
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.is_file():
            cxx = shutil.which("g++")
            if cxx is None:
                return None
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {SOURCE.name} (rc {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.ps_parse_atoms.restype = ctypes.c_int64
        lib.ps_parse_atoms.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the C++ scanner is built or can be (raises if its build fails)."""
    return load_native() is not None


def parse_atom_records_native(data: bytes) -> Optional[Dict[str, np.ndarray]]:
    """Scan raw PDB bytes with the C++ scanner.

    Returns the same dict of arrays as ``parser._parse_atom_records``
    (``atom_name``/``altloc``/``res_name``/``chain_id``/``icode`` as byte
    strings, ``res_num`` int32, ``xyz`` float32), or None when the scanner is
    unavailable (no ``g++``).

    It differs from the NumPy scanner on malformed input only: its
    fixed-field readers (``pdb_parser.cpp`` ``parse_fixed_float``/``int``)
    stop at the first character they cannot read and give 0 for a corrupt
    numeric field where the NumPy scanner raises ``ValueError``, and it skips
    ATOM/HETATM lines shorter than 54 characters.  Well-formed files parse
    identically; a caller that wants strictness sets
    ``PROTSTRUC_TPU_NO_NATIVE=1`` or passes ``use_native=False``.
    """
    global CALLS
    lib = load_native()
    if lib is None:
        return None

    # upper bound on records: one per newline (+1 for no trailing newline)
    max_n = data.count(b"\n") + 1
    atom_name = np.empty(max_n * 4, dtype=np.uint8)
    altloc = np.empty(max_n, dtype=np.uint8)
    res_name = np.empty(max_n * 3, dtype=np.uint8)
    chain = np.empty(max_n, dtype=np.uint8)
    res_num = np.empty(max_n, dtype=np.int32)
    icode = np.empty(max_n, dtype=np.uint8)
    xyz = np.empty((max_n, 3), dtype=np.float32)

    n = lib.ps_parse_atoms(
        data, len(data),
        atom_name.ctypes.data_as(ctypes.c_void_p),
        altloc.ctypes.data_as(ctypes.c_void_p),
        res_name.ctypes.data_as(ctypes.c_void_p),
        chain.ctypes.data_as(ctypes.c_void_p),
        res_num.ctypes.data_as(ctypes.c_void_p),
        icode.ctypes.data_as(ctypes.c_void_p),
        xyz.ctypes.data_as(ctypes.c_void_p),
        max_n,
    )
    with _lock:
        CALLS += 1
    if n < 0:
        raise RuntimeError("native PDB parser overflow (record bound too small)")
    if n == 0:
        raise ValueError("no ATOM/HETATM records found")

    # byte-string (S) arrays end to end: unicode happens once per residue in
    # parser._build_structure
    def to_s(arr, w):
        v = arr[: n * w].view(f"S{w}")
        return np.char.strip(v) if w > 1 else v

    return {
        "atom_name": to_s(atom_name, 4),
        "altloc": altloc[:n].view("S1"),
        "res_name": to_s(res_name, 3),
        "chain_id": np.char.strip(chain[:n].view("S1")),
        "res_num": res_num[:n].copy(),
        "icode": np.char.strip(icode[:n].view("S1")),
        "xyz": xyz[:n].copy(),
    }
