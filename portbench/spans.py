"""The traced run's device operations put down to the program's spans.

portbench/trace.py's read_session calls `attribute` on every traced
session, with the span table that the cell's driver gives profile (that
of the graph the session replayed; None for an eager block), and keeps
the reading as the session's "spans"; the span metrics' readers
(portbench/metrics/) read it through `ms_per_unit` and `has_spans`, and
portbench/run.py prints `result` of it as a traced result's "spans".

The program opens its spans (ggs_tpu_torch.utils.profiling.span, named in
its SPANS) as torch.profiler.record_function, so they lie in the Chrome
trace as host events on the thread that opened them, on the clock of the
device's records. Each device operation (kernel, copy, fill) is put down
to a span path ("ga.step/objective.evaluate/render.bin"):

* an eager operation by its `correlation` to the runtime or driver call
  that launched it, then the innermost program span on that call's thread
  around the call; where none is open on that thread (autograd's backward
  runs on a thread of its own), the innermost one open on any thread;
* a replayed graph's operations all correlate to its `cudaGraphLaunch`:
  they are grouped by it, ordered by start and named by the graph's span
  table (BlockGraphs' `_Graph.spans`, one path a kernel, copy and fill
  node in chain order), below the path of the launch. A group whose length
  is not the table's (a session that lost records, another graph) is
  counted under "unmapped", never guessed;
* an operation under no program span (the harness's own read-back) goes
  under "outside".

A span path's self time is the device time of the operations put down to
it, and not to a span inside it. Inside each replay the idle time between
its first and last operation is summed, and each gap is named by the path
and the name of the operation after it. A program without spans (no SPANS) reads all
its operations "outside", and the readers of the span metrics then return
None.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Optional, Sequence

from .trace import short_name

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CAT = "user_annotation"
OUTSIDE, UNMAPPED = "outside", "unmapped"
# the render path before the walks: codec, preprocess and boxes, binning, tables
RENDER_PREP = ("render.screen", "render.bin", "render.feats")


def program_spans() -> tuple:
    """The span names of the program under test (its profiling.SPANS), or
    () for a program that has none."""
    from ggs_tpu_torch.utils import profiling

    return tuple(getattr(profiling, "SPANS", ()))


def _ts(e) -> float:
    return float(e["ts"])


def _end(e) -> float:
    return float(e["ts"]) + float(e.get("dur", 0.0))


def _thread(e) -> tuple:
    return e.get("pid"), e.get("tid")


def _corr(e):
    return (e.get("args") or {}).get("correlation")


class _SpanIndex:
    """The program's spans of a trace, by thread, each with its path."""

    def __init__(self, events: list, names: Sequence[str]):
        names = set(names)
        spans = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == SPAN_CAT
                        and e.get("name") in names), key=lambda e: (_ts(e), -_end(e)))
        self.by_thread, self.starts = defaultdict(list), defaultdict(list)
        self.up = {}  # a span's parent on its own thread
        self.path = {}
        open_ = defaultdict(list)
        for e in spans:
            th = _thread(e)
            stack = open_[th]
            while stack and _end(stack[-1]) < _end(e):
                stack.pop()
            up = stack[-1] if stack else None
            parent = up if up is not None else self._around(_ts(e), skip=th)
            self.up[id(e)] = up
            head = "" if parent is None else self.path[id(parent)] + "/"
            self.path[id(e)] = head + e["name"]
            stack.append(e)
            self.by_thread[th].append(e)
            self.starts[th].append(_ts(e))

    def _on(self, th, t: float):
        """The innermost span of thread th around time t, or None."""
        spans = self.by_thread.get(th)
        if not spans:
            return None
        i = bisect.bisect_right(self.starts[th], t) - 1
        e = spans[i] if i >= 0 else None
        while e is not None and _end(e) < t:  # what encloses t encloses the last span begun
            e = self.up[id(e)]
        return e

    def _around(self, t: float, skip=None):
        """The innermost span around time t on any thread but `skip` (the
        latest begun of those open there), or None."""
        found = [self._on(th, t) for th in self.by_thread if th != skip]
        found = [e for e in found if e is not None]
        return max(found, key=_ts) if found else None

    def path_at(self, th, t: float) -> Optional[str]:
        """The path of the innermost span around a launch at time t on thread
        th (on another thread where th has none open), or None."""
        e = self._on(th, t) or self._around(t, skip=th)
        return None if e is None else self.path[id(e)]


def attribute(events: list, table: Optional[Sequence[str]] = None,
              names: Optional[Sequence[str]] = None) -> dict:
    """Chrome-trace events -> the device seconds and operations of each span
    path's self time ("outside" and "unmapped" among them), the replays'
    idle time by the span path of the operation after each gap, and their
    ten longest gaps. table: the span table of the
    graph the session replays (None for an eager block); names: the
    program's span names (default: program_spans())."""
    names = program_spans() if names is None else names
    index = _SpanIndex(events, names)
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS and _corr(e) is not None:
            launches[_corr(e)] = e
    self_s, ops = defaultdict(float), defaultdict(int)
    groups = defaultdict(list)

    def put(path, e):
        self_s[path] += float(e.get("dur", 0.0)) * 1e-6
        ops[path] += 1

    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get(_corr(e))
        if launch is None:
            put(OUTSIDE, e)
        elif "GraphLaunch" in launch["name"]:
            groups[_corr(e)].append(e)
        else:
            put(index.path_at(_thread(launch), _ts(launch)) or OUTSIDE, e)
    gap_s, gaps, unmapped = defaultdict(float), [], []
    for corr, group in groups.items():
        group.sort(key=_ts)
        launch = launches[corr]
        outer = index.path_at(_thread(launch), _ts(launch))
        if table is None or len(group) != len(table):
            unmapped.append(len(group))
            paths = [UNMAPPED] * len(group)
        else:
            paths = ["/".join(p for p in (outer, inner) if p) or OUTSIDE for inner in table]
        reach = _end(group[0])
        for e, path in zip(group, paths):
            put(path, e)
            if _ts(e) > reach:
                gaps.append((path, (_ts(e) - reach) * 1e-6, short_name(e["name"])))
                gap_s[path] += (_ts(e) - reach) * 1e-6
            reach = max(reach, _end(e))
    gaps.sort(key=lambda g: -g[1])
    return {
        "spans_seen": len(index.path), "self_s": dict(self_s), "ops": dict(ops),
        "device_s": sum(self_s.values()),
        "replays": len(groups), "unmapped_groups": sorted(unmapped),
        "replay_idle_s": sum(gap_s.values()), "replay_gap_s": dict(gap_s),
        "replay_gaps": [list(g) for g in gaps[:10]],
    }


def has_spans(reading: Optional[dict]) -> bool:
    """Whether a traced reading saw program spans: the program has them."""
    return bool((reading or {}).get("spans", {}).get("spans_seen"))


def ms_per_unit(rec, kind: str, under: Sequence[str],
                outside: Sequence[str] = ()) -> Optional[float]:
    """Device ms a unit (generation or step) of the self time of the span
    paths that pass through a span named in `under` and through none named
    in `outside`, in a `kind` cell's traced run; None elsewhere and where
    the program has no spans."""
    t = rec.trace
    if rec.kind != kind or not has_spans(t):
        return None
    total = 0.0
    for path, v in t["spans"]["self_s"].items():
        names = set(path.split("/"))
        if names & set(under) and not names & set(outside):
            total += v
    return 1e3 * total / t["units"]


def result(reading: dict) -> dict:
    """The traced result's `spans` key: device ms a unit of each span
    path's self time, the share of the device time outside every span or
    in replays that could not be mapped, the unmapped replays' lengths, and
    the replays' idle ms a unit by the span path after each gap, and the
    ten longest in-replay gaps in ms, each named by the path and the
    operation after it."""
    sp, units = reading["spans"], reading["units"]
    lost = sp["self_s"].get(OUTSIDE, 0.0) + sp["self_s"].get(UNMAPPED, 0.0)
    return {
        "ms_per_unit": {p: 1e3 * v / units
                        for p, v in sorted(sp["self_s"].items(), key=lambda kv: -kv[1])},
        "ops_per_unit": {p: n / units for p, n in sorted(sp["ops"].items())},
        "outside_pct": 100.0 * lost / sp["device_s"] if sp["device_s"] else 0.0,
        "unmapped_groups": sp["unmapped_groups"],
        "replay_gap_ms_per_unit": {p: 1e3 * v / units for p, v in sorted(
            sp["replay_gap_s"].items(), key=lambda kv: -kv[1])},
        "replay_gaps_ms": [[p, 1e3 * s, op] for p, s, op in sp["replay_gaps"]],
    }
