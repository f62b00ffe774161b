"""Tracing / profiling hooks (ggs_tpu/utils/profiling.py).

`trace` wraps a region with torch.profiler (CPU and, with a card, CUDA
activity) and writes a Chrome trace (chrome://tracing, Perfetto) into its
directory; `named_scope` labels a region in that trace; StepTimer gives the
candidates/s (or steps/s) throughput metric; `prewarm` keeps first-call
costs (the kernels' nvcc build, allocator growth) out of timings.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

named_scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace around a block into
    log_dir/trace_<pid>_<n>.json (a no-op when log_dir is empty or None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    """Wall-clock throughput: candidates (or steps) per second.

    Call start() after warmup, tick(n) after each synchronized block of n
    units, then rate().
    """

    def __init__(self) -> None:
        self._t0: Optional[float] = None
        self._units = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._units = 0

    def tick(self, n: int = 1) -> None:
        self._units += n

    def elapsed(self) -> float:
        assert self._t0 is not None, "StepTimer.start() not called"
        return time.perf_counter() - self._t0

    def rate(self) -> float:
        dt = self.elapsed()
        return self._units / dt if dt > 0 else float("inf")


def _on_card(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_on_card(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return any(_on_card(v) for v in x)
    return False


def prewarm(fn, *args, **kwargs):
    """Call fn once and wait for the card when its outputs lie there."""
    out = fn(*args, **kwargs)
    if _on_card(out):
        torch.cuda.synchronize()
    return out
