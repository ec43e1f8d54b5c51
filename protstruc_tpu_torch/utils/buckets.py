"""Bucketed padding of the residue axis (port of ``protstruc_tpu/utils/buckets.py``).

Serving pads every request's residue axis up to one of a few bucket lengths,
so the featurizer sees a bounded set of shapes (``utils/aot.py``).
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["DEFAULT_BUCKETS", "bucket_length"]

#: Default residue-length buckets: fine-grained at common protein sizes,
#: multiples of 128 from 256 up.
DEFAULT_BUCKETS = (64, 128, 256, 384, 512, 768, 1024, 1536, 2048)


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n; rounds up to a multiple of 128 beyond the table."""
    for b in buckets:
        if n <= b:
            return b
    return (n + 127) // 128 * 128
