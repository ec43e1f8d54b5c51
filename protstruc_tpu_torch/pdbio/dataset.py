"""Bucketed streaming dataset: PDB files -> StructureBatches on the card
(port of ``protstruc_tpu/pdbio/dataset.py``).

* Parse in a thread pool, with lazy bounded submission.
* Group structures into batches by length bucket (``utils/buckets.py``), so
  each batch is padded to a bucket length.
* A producer thread keeps ``prefetch`` batches ready.  Each batch is padded
  and stacked on the host, then moved to ``device`` with one pinned,
  non-blocking copy per tensor, so the copy overlaps the consumer's work.
* A process-global, byte-budgeted LRU of parsed structures, keyed by
  ``(path, mtime_ns, size)``, so epoch 2+ skips parsing
  (:func:`parsed_cache_stats` counts its hits and misses,
  :func:`clear_parsed_cache` empties it).
* Epoch order: ``np.random.RandomState(seed + epoch).shuffle``, the JAX
  package's exact order.

    ds = StructureDataset(paths, batch_size=8, device="cuda")
    for batch in ds:                      # StructureBatch per iteration
        feats = batch.inter_residue_geometry()
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Sequence

import numpy as np

from protstruc_tpu_torch.utils.buckets import DEFAULT_BUCKETS, bucket_length

__all__ = ["StructureDataset", "parsed_cache_stats", "clear_parsed_cache"]

#: Name of an epoch's producer thread.
PRODUCER_THREAD = "StructureDataset-producer"


def _parsed_nbytes(parsed) -> int:
    return sum(getattr(v, "nbytes", 64) for v in vars(parsed).values())


class _ParsedLRU:
    """Process-global byte-budgeted LRU of ParsedStructure objects."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._od: "OrderedDict" = OrderedDict()
        self.bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key):
        with self._lock:
            item = self._od.get(key)
            if item is None:
                self.misses += 1
                return None
            self._od.move_to_end(key)
            self.hits += 1
            return item[0]

    def put(self, key, parsed):
        nb = _parsed_nbytes(parsed)
        if nb > self.max_bytes:
            return
        with self._lock:
            old = self._od.pop(key, None)
            if old is not None:
                self.bytes -= old[1]
            self._od[key] = (parsed, nb)
            self.bytes += nb
            while self.bytes > self.max_bytes and len(self._od) > 1:
                _, (_, freed) = self._od.popitem(last=False)
                self.bytes -= freed

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._od), "bytes": self.bytes,
                    "hits": self.hits, "misses": self.misses,
                    "hit_rate": self.hits / max(self.hits + self.misses, 1)}

    def clear(self):
        """Drop every entry (the hit and miss counts stay)."""
        with self._lock:
            self._od.clear()
            self.bytes = 0


# default budget 1 GiB of host-side arrays; PROTSTRUC_TPU_PARSE_CACHE_BYTES overrides
_CACHE = _ParsedLRU(int(os.environ.get("PROTSTRUC_TPU_PARSE_CACHE_BYTES", 1 << 30)))


def parsed_cache_stats() -> dict:
    """Entries, bytes, hits, misses and hit rate of the process-global
    parsed-structure cache."""
    return _CACHE.stats()


def clear_parsed_cache():
    """Empty the process-global parsed-structure cache."""
    _CACHE.clear()


class StructureDataset:
    """Iterable over bucketed StructureBatches assembled from PDB files.

    Args:
        paths: PDB/mmCIF file paths.
        batch_size: max structures per emitted batch.
        buckets: padded-length table (see utils/buckets.py).
        shuffle: reshuffle file order each epoch.
        seed: shuffle seed.
        n_workers: parser threads.
        prefetch: batches to keep assembled ahead of the consumer.
        drop_remainder: drop the final short batch of each bucket.
        use_cache: serve repeat files from the parsed-structure LRU.
        device: where the batches are delivered (default cuda, which raises
            without a card).
    """

    def __init__(self, paths: Sequence[str], batch_size: int = 8,
                 buckets: Sequence[int] = DEFAULT_BUCKETS, shuffle: bool = False, seed: int = 0,
                 n_workers: int = 4, prefetch: int = 2, drop_remainder: bool = False,
                 use_cache: bool = True, device="cuda"):
        from protstruc_tpu_torch.batch import resolve_device

        self.paths = list(paths)
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self.n_workers = n_workers
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        self.use_cache = use_cache
        self.device = resolve_device(device)
        self._epoch = 0

    def _parse(self, path):
        from protstruc_tpu_torch.pdbio.parser import parse_pdb

        if not self.use_cache:
            return parse_pdb(path)
        try:
            st = os.stat(path)
            key = (os.fspath(path), st.st_mtime_ns, st.st_size)
        except OSError:
            return parse_pdb(path)  # non-path sources: parse uncached
        hit = _CACHE.get(key)
        if hit is not None:
            return hit
        parsed = parse_pdb(path)
        _CACHE.put(key, parsed)
        return parsed

    def __len__(self) -> int:
        return len(self.paths)

    def _epoch_paths(self) -> List[str]:
        order = np.arange(len(self.paths))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        return [self.paths[i] for i in order]

    def _assemble(self, group):
        """Pad and stack a group on the host at its bucket length, then one
        pinned, non-blocking copy per tensor to the device."""
        from protstruc_tpu_torch.batch import StructureBatch

        max_l = bucket_length(max(p.n_residues for p in group), self.buckets)
        host = StructureBatch._from_parsed(group, target_length=max_l, device="cpu")
        if self.device.type == "cpu":
            return host
        moved = {f: getattr(host, f).pin_memory().to(self.device, non_blocking=True)
                 for f in ("xyz", "atom_mask", "chain_idx", "residue_idx")}
        return dataclasses.replace(host, **moved)

    def __iter__(self) -> Iterator:
        paths = self._epoch_paths()
        self._epoch += 1

        out: "queue.Queue" = queue.Queue(maxsize=max(self.prefetch, 1))
        _END = object()
        error: List[BaseException] = []
        # abandoning the epoch (break / GeneratorExit) sets `stop`, so the
        # producer never blocks forever on a full queue
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                pending = {b: [] for b in self.buckets}
                pending[None] = []  # beyond-table lengths
                with ThreadPoolExecutor(self.n_workers) as pool:
                    path_it = iter(paths)
                    inflight: deque = deque()

                    def top_up():
                        while len(inflight) < 2 * self.n_workers and not stop.is_set():
                            try:
                                inflight.append(pool.submit(self._parse, next(path_it)))
                            except StopIteration:
                                break

                    top_up()
                    while inflight:
                        parsed = inflight.popleft().result()
                        if stop.is_set():
                            for f in inflight:
                                f.cancel()
                            return
                        top_up()
                        b = bucket_length(parsed.n_residues, self.buckets)
                        key = b if b in pending else None
                        pending[key].append(parsed)
                        if len(pending[key]) == self.batch_size:
                            if not _put(self._assemble(pending[key])):
                                return
                            pending[key] = []
                if not self.drop_remainder:
                    for group in pending.values():
                        if group and not _put(self._assemble(group)):
                            return
            except BaseException as e:  # surface in the consumer
                error.append(e)
            finally:
                _put(_END)

        t = threading.Thread(target=producer, daemon=True, name=PRODUCER_THREAD)
        t.start()
        try:
            while True:
                item = out.get()
                if item is _END:
                    break
                yield item
            t.join()
            if error:
                raise error[0]
        finally:
            # an abandoned epoch (break) ends its producer before the caller
            # goes on: a daemon thread still inside torch's C++ (pinning, a
            # device copy) at interpreter exit can abort the process
            stop.set()
            t.join()
