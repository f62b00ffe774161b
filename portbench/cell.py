"""A cell of BENCHMARK.json and what the harness finds for it by name:
its configuration file, portbench/traffic/<traffic>.json,
portbench/limits/<workload>.json, the metrics that it reports and their
readers, portbench/metrics/<metric>.py (a suffixed name falls back to the
reader of its base name)."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, NamedTuple, Optional

from .inputs import ROOT

HERE = os.path.dirname(os.path.abspath(__file__))


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries that this cell reports
    per_layer: list


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, workload: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load(workload: str, bench_path: Optional[str] = None) -> Cell:
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    return Cell(
        name=workload, chips=int(w["chips"]), config=_json(os.path.join(ROOT, conf["file"])),
        traffic=_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "limits", workload + ".json")),
        end_to_end=e2e, per_layer=[m for m in bench["per_layer"] if _reports(m, workload, names)],
    )


def reader(metric: str) -> Callable:
    """The read(record) function of portbench/metrics/<metric>.py, or, for a
    name with a suffix that has no file of its own (idle_pct.p512), of the
    name without it (idle_pct)."""
    name = metric
    while not os.path.exists(os.path.join(HERE, "metrics", name + ".py")) and "." in name:
        name = name.rsplit(".", 1)[0]
    path = os.path.join(HERE, "metrics", name + ".py")
    name = "portbench_metric_" + name.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
