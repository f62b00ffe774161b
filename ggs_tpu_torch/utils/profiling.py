"""Tracing hooks (ggs_tpu/utils/profiling.py).

`trace` wraps a region with torch.profiler (CPU and, with a card, CUDA
activity) and writes a Chrome trace (chrome://tracing, Perfetto) into its
directory; `named_scope` labels a region in that trace (run_ga
--profile-dir's "{prefix} block a-b").

`span(name)` is the program's one way to open a span at a layer boundary,
its names the tuple SPANS. Under the profiler it is
torch.profiler.record_function, on the timeline and clock of the card's
records, so a device operation can be put down to the span that launched
it (by its launch's correlation). While utils/block_graph.py captures a
run block (`capturing`), each span's entry and exit also go to the
capture's `mark`, which records the capture's position there, so the
graph's nodes can be named by span although a replay runs no Python.
Otherwise a span costs one check and opens nothing.

`COUNTS` is the program's one registry of counts, and `count(name, n)` the
way to add to it: the kernel wrappers count their device launches there
("K1", "K2", "K3", "K3-canvas", "K4", "K1-bf16", "K5", "K6", "K7"; "<K>-init"
those that walk from an init canvas; "K5-band" and "K5-fallback" K5's band
stages and overflow fallbacks), render_cuda.bin_splats its calls by route
("bin.dense", "bin.k5"), and a measuring caller its own events. A replayed
run block runs no Python, so utils/block_graph.py adds its capture's counts
at each replay.
"""
from __future__ import annotations

import collections
import contextlib
import os
from typing import Callable, Hashable, Iterator, Optional

import torch

named_scope = torch.profiler.record_function

# Every span the package opens; a span's parent is the span open around it
SPANS = (
    "block.prepare",  # ga._sigma_tables' prepare: the sigma table's cover and counter fill
    "block.replay",  # BlockGraphs: the inputs' copies, the replay, the launch counts
    "block.capture",  # BlockGraphs' first call of a key: the eager body and the capture
    "ga.step",  # one generation
    "ga.draw",  # the generation's random numbers (draw_offspring)
    "ga.variation",  # selection, crossover, mutation (_offspring)
    "ga.elitism",  # the elites' sort, the new population, best and metrics
    "objective.evaluate",  # one scoring call, every chunk
    "render.screen",  # codec, preprocess, boxes, padded target and weights
    "render.bin",  # bin_splats: the dense binning or K5, one pass
    "render.feats",  # the walk's table (and K4's boxes)
    "render.walk",  # K1, K2, K3, K1-bf16 and the partials' sum
    "render.grad",  # K6, K7 and their sums
    "adam.step",  # one projected Adam step
    "adam.value_and_grad",  # the step's value and gradient
    "adam.update",  # the optimizer's update and the projection
)

COUNTS: collections.Counter = collections.Counter()


def count(name: Hashable, n: int = 1) -> None:
    """Adds n (none when 0) to COUNTS[name]."""
    if n:
        COUNTS[name] += n


_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
# mark(name) at a span's entry, mark(None) at its exit, while a run block is
# captured (capturing); None otherwise
_mark: Optional[Callable[[Optional[str]], None]] = None


class _Span:
    __slots__ = ("name", "mark", "scope")

    def __init__(self, name: str, mark) -> None:
        self.name, self.mark, self.scope = name, mark, None

    def __enter__(self):
        if self.mark is not None:
            self.mark(self.name)
        if _profiling():
            self.scope = torch.profiler.record_function(self.name)
            self.scope.__enter__()
        return self

    def __exit__(self, *exc):
        if self.scope is not None:
            self.scope.__exit__(*exc)
        if self.mark is not None:
            self.mark(None)
        return False


def span(name: str):
    """A context manager that opens the program span `name` (one of SPANS)
    under the profiler or a run block's capture, and nothing otherwise."""
    mark = _mark
    if mark is None and not _profiling():
        return _NULL
    return _Span(name, mark)


@contextlib.contextmanager
def capturing(mark: Callable[[Optional[str]], None]) -> Iterator[None]:
    """Sends every span's entry (mark(name)) and exit (mark(None)), on any
    thread, to `mark` while the block runs: a run block's capture, which
    records the capture's position at each (utils/block_graph.py)."""
    global _mark
    before, _mark = _mark, mark
    try:
        yield
    finally:
        _mark = before


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
