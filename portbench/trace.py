"""The traced run's reading of the device timeline.

A session profiles a few whole blocks with torch.profiler (CPU and CUDA
activity), exports the Chrome trace into the checkout's `portbench_out/`,
reads it and deletes it. From the device operations (kernels, copies and
fills) it takes the busy time (the union of their intervals), each
operation's time by the kernel table in kernels.json, the ten operations
that took most time, and the ten longest idle gaps, each named by the
innermost host event under its middle; and, by portbench/spans.py, each
device operation put down to the program's span that launched it (a
replayed graph's operations by the graph's span table). A session that
recorded fewer device operations than the block is known to launch (a
replayed graph's nodes) lost records: it is made again, up to ATTEMPTS
times. The operations of a replay that does not map onto its span table
count as lost too. Where the count is not known (an eager block),
sessions are made until two in a row record the same number of
operations, again up to ATTEMPTS. The reading kept is that of the
session that recorded the most.
"""
from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict
from typing import Callable, Optional, Sequence

from .inputs import ROOT

ATTEMPTS = 4
OUT_DIR = os.path.join(ROOT, "portbench_out")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
WINDOW = "portbench.window"


def load_table(path: Optional[str] = None) -> dict:
    with open(path or os.path.join(os.path.dirname(__file__), "kernels.json")) as fh:
        table = json.load(fh)
    table["compiled"] = [(re.compile(p), k) for p, k in table["kernels"]]
    return table


def kernel_of(name: str, table: dict) -> str:
    for pat, k in table["compiled"]:
        if pat.search(name):
            return k
    return "other"


def short_name(name: str) -> str:
    """'void ns::kernel<0>(args...)' -> 'ns::kernel<0>'."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    s = "".join(out)
    return s if len(s) <= 120 else s[:117] + "..."


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list, table: dict, window_s: float) -> dict:
    """Chrome-trace events -> the traced window's reading (seconds)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev]
    merged = _union(spans)
    by_kernel, by_name = defaultdict(float), defaultdict(float)
    for e in dev:
        dur = float(e.get("dur", 0.0)) * 1e-6
        by_kernel[kernel_of(e["name"], table)] += dur
        by_name[short_name(e["name"])] += dur
    win = [e for e in host if e["name"] == WINDOW]
    lo = float(win[0]["ts"]) if win else (merged[0][0] if merged else 0.0)
    hi = lo + float(win[0]["dur"]) if win else (merged[-1][1] if merged else 0.0)
    edges = [lo] + [x for m in merged for x in m] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])

    def doing(t):
        under = [e for e in host if e["name"] != WINDOW
                 and float(e["ts"]) <= t <= float(e["ts"]) + float(e.get("dur", 0.0))]
        return min(under, key=lambda e: float(e.get("dur", 0.0)))["name"] if under else "host"

    idle = defaultdict(float)
    for a, b in gaps[:10]:
        idle[doing(0.5 * (a + b))] += (b - a) * 1e-6
    return {
        "window_s": window_s,
        "busy_s": sum(b - a for a, b in merged) * 1e-6,
        "ops": len(dev),
        "by_kernel": dict(by_kernel),
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10],
    }


def read_session(events: list, table: dict, window_s: float,
                 span_table: Optional[Sequence[str]] = None,
                 names: Optional[Sequence[str]] = None) -> dict:
    """One session's Chrome-trace events -> summarize's reading with
    "spans", spans.attribute's reading of the same events (span_table: that
    of the graph the session replayed, None for an eager block; names: the
    program's span names, by default its own). The operations of replays
    that do not map onto span_table are taken off "ops": a session that
    lost a record in a replay counts short, so profile makes it again."""
    from . import spans  # spans imports this module

    out = summarize(events, table, window_s)
    out["spans"] = spans.attribute(events, span_table, names)
    out["ops"] -= sum(out["spans"]["unmapped_groups"])
    return out


def settled(counts: list, min_ops: Optional[int]) -> bool:
    """Whether the sessions' device operation counts so far can be kept: the
    last meets min_ops, or, with min_ops None, repeats the one before."""
    if min_ops is not None:
        return counts[-1] >= min_ops
    return len(counts) > 1 and counts[-1] == counts[-2]


def profile(session: Callable[[], None], min_ops: Optional[int], table: dict,
            measure: Optional[Callable[[], object]] = None,
            span_table: Optional[Callable[[], Optional[Sequence[str]]]] = None) -> dict:
    """Profile session() (whole blocks that end synchronised) until a session
    records at least min_ops device operations, or, with min_ops None, until
    two sessions in a row record the same number. -> read_session's reading
    of the session that recorded the most operations (the last of those),
    "spans" among it, with "measured", measure()'s values before and after
    that session (taken outside the profiler), "attempts", "settled"
    (whether the count was met or repeated) and every session's count.
    span_table() gives the span table of the graph the session replayed,
    read after each session (None, or no span_table, for an eager block)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "trace.json")
    counts, best = [], None
    for attempt in range(1, ATTEMPTS + 1):
        before = measure() if measure is not None else None
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                t0 = time.perf_counter()
                session()
                torch.cuda.synchronize()
                window_s = time.perf_counter() - t0
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        os.remove(path)
        out = read_session(events, table, window_s, span_table() if span_table else None)
        out["measured"] = (before, measure() if measure is not None else None)
        counts.append(out["ops"])
        if best is None or out["ops"] >= best["ops"]:
            best = out  # a session that lost records counts fewer
        if settled(counts, min_ops):
            break
    best.update(attempts=attempt, settled=settled(counts, min_ops), min_ops=min_ops,
                op_counts=counts)
    return best
