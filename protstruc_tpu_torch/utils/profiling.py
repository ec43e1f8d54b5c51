"""Profiling and tracing helpers (port of ``protstruc_tpu/utils/profiling.py``).

``trace`` names a span in ``torch.profiler`` traces and, on a CUDA host, in
NVTX; ``profile_to`` records a Chrome trace of a block; ``Timer`` is a wall
clock that waits for the card's work before it stops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

__all__ = ["trace", "profile_to", "Timer"]


@contextlib.contextmanager
def trace(name: str) -> Iterator[None]:
    """A named span: ``torch.profiler.record_function`` (seen by a running
    profiler) and an NVTX range where CUDA is present."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block (CPU activity, and CUDA activity on a CUDA
    host) and write its Chrome trace to ``log_dir/trace-<pid>-<ns>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif hasattr(tree, "__dataclass_fields__"):
        for f in tree.__dataclass_fields__:
            _cuda_devices(getattr(tree, f), out)
    return out


class Timer:
    """Wall-clock timer that waits for device work (for benchmarks and logs)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False

    def block(self, tree):
        """Synchronize every CUDA device that ``tree``'s tensors live on (in
        dicts, lists, tuples and dataclasses such as a StructureBatch), then
        stop the clock; returns ``tree``."""
        for dev in _cuda_devices(tree, set()):
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._t0
        return tree
