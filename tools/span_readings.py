#!/usr/bin/env python3
"""A benchmark cell's traced run with its device time put down to the
program's spans.

    python3 tools/span_readings.py --workload ga512-p32 --seed 7 [--seed 8 ...]

Runs the cell as `python3 -m portbench.run --workload W --seed S --trace 1`
does (its driver, its traced sessions, its checks), and reads each traced
session twice: by kernel name (portbench/trace.py, as the benchmark does)
and by program span (portbench/spans.py), with the span table of the graph
the session replays (BlockGraphs' `last.spans`); a session in which a
replay lost a record, and so maps onto nothing, is made again. Prints one
JSON line a seed: the cell's per-layer metrics, the span metrics of
portbench/metrics (ga_ops_ms_per_gen, render_prep_ms_per_gen,
render_prep_ms_per_step, adam_update_ms_per_step, replay_idle_pct), the
span breakdown (spans.result), the checks and the card's name and power
limit. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SPAN_METRICS = ("ga_ops_ms_per_gen", "render_prep_ms_per_gen", "render_prep_ms_per_step",
                "adam_update_ms_per_step", "replay_idle_pct")


def traced(workload: str, seed: int) -> dict:
    """One traced run of the cell, its sessions also read by span."""
    from ggs_tpu_torch.models import ga, gradient
    from portbench import cell as cell_mod
    from portbench import spans, trace
    from portbench.drivers import adam as adam_driver
    from portbench.drivers import ga as ga_driver

    t_start = time.perf_counter()
    cell = cell_mod.load(workload)
    made = []

    def keep(make):
        def wrapped(*a, **kw):
            made.append(make(*a, **kw))
            return made[-1]
        return wrapped

    def summarize(events, table, window_s):
        out = plain(events, table, window_s)
        run = made[-1]
        graph = run.graphs.last if run.use_graphs else None
        out["spans"] = spans.attribute(events, getattr(graph, "spans", None))
        # a replay that lost a record maps onto nothing: its session counts
        # short, so portbench.trace.profile makes it again
        out["ops"] -= sum(out["spans"]["unmapped_groups"]) if graph is not None else 0
        return out

    patched = [(ga, "make_run_block", keep(ga.make_run_block)),
               (gradient, "make_run_block", keep(gradient.make_run_block)),
               (trace, "summarize", summarize)]
    plain = trace.summarize
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, fn in patched:
        setattr(mod, name, fn)
    try:
        driver = {"ga": ga_driver, "adam": adam_driver}[cell.traffic["driver"]]
        rec, checks, dev_info, _ = driver.run(cell, seed, 10.0, True, "cuda", t_start=t_start)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    names = [m["name"] for m in cell.per_layer] + list(SPAN_METRICS)
    metrics = {n: cell_mod.reader(n)(rec) for n in names}
    return {"workload": workload, "seed": seed, "setup_s": rec.setup_s,
            "window_s": rec.trace["window_s"], "busy_s": rec.trace["busy_s"],
            "metrics": {k: v for k, v in metrics.items() if v is not None},
            "spans": spans.result(rec.trace), "replays": rec.trace["spans"]["replays"],
            "trace_sessions": {k: rec.trace[k] for k in ("attempts", "settled", "op_counts")},
            "device": dev_info, "checks": {c["name"]: c["value"] for c in checks}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for seed in args.seed:
        out = traced(args.workload, seed)
        out["card"] = card
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
