"""Cache-first PDB fetching (a copy of ``protstruc_tpu/pdbio/fetch.py``).

Replaces the reference's live ``biotite.database.rcsb.fetch``
(protstruc.py:225) with a local-cache-first fetcher so pipelines work in
air-gapped environments (and tests never hit the network).

Cache search order:
1. ``$PROTSTRUC_TPU_PDB_CACHE`` (colon-separated directories),
2. ``~/.cache/protstruc_tpu/pdb``.

On miss, attempts an RCSB download into the cache — legacy ``.pdb`` first,
then ``.cif`` (RCSB serves no ``.pdb`` for large structures; the parser
layer handles both, including ``.gz``).  A clear error is raised when the
network is unavailable.
"""

from __future__ import annotations

import os
import pathlib
from typing import List

__all__ = ["fetch_pdb", "cache_dirs"]

_RCSB_URL = "https://files.rcsb.org/download/{name}"
# legacy PDB first (parity with the reference's rcsb.fetch(id, "pdb")),
# then PDBx/mmCIF — the only format available for large structures
_FORMATS = (".pdb", ".cif")


def cache_dirs() -> List[pathlib.Path]:
    dirs: List[pathlib.Path] = []
    env = os.environ.get("PROTSTRUC_TPU_PDB_CACHE")
    if env:
        dirs.extend(pathlib.Path(p) for p in env.split(":") if p)
    dirs.append(pathlib.Path.home() / ".cache" / "protstruc_tpu" / "pdb")
    return dirs


def fetch_pdb(pdb_id: str, timeout: float = 30.0) -> str:
    """Return a local path for ``pdb_id``, downloading into the cache on miss.

    Checks every cache directory for ``.pdb``/``.cif`` (and ``.gz``)
    variants before touching the network; downloads try legacy PDB first
    and fall back to mmCIF.
    """
    pdb_id = pdb_id.strip()
    candidates = []
    for d in cache_dirs():
        for stem in (pdb_id, pdb_id.lower(), pdb_id.upper()):
            for ext in (".pdb", ".cif", ".pdb.gz", ".cif.gz"):
                candidates.append(d / f"{stem}{ext}")
    for c in candidates:
        if c.is_file():
            return str(c)

    # cache miss: try the network, .pdb then .cif
    target_dir = cache_dirs()[-1]
    target_dir.mkdir(parents=True, exist_ok=True)
    errors = []
    for ext in _FORMATS:
        name = f"{pdb_id.upper()}{ext}"
        target = target_dir / name
        url = _RCSB_URL.format(name=name)
        try:
            import urllib.request

            with urllib.request.urlopen(url, timeout=timeout) as resp:
                target.write_bytes(resp.read())
            return str(target)
        except Exception as e:  # try the next format
            errors.append(f"{url}: {type(e).__name__}: {e}")

    raise IOError(
        f"PDB entry {pdb_id!r} not found in local caches "
        f"({[str(d) for d in cache_dirs()]}) and RCSB download failed "
        f"({'; '.join(errors)}). Pre-populate a cache directory or "
        f"set PROTSTRUC_TPU_PDB_CACHE."
    )
