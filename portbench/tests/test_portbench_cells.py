"""BENCHMARK.json against the harness: every cell, configuration, traffic,
limits file and metric reader is found by name, and every cell reports
setup_s, another end-to-end metric and a per-layer metric."""
import json
import os
import re

import pytest

from portbench import cell as cell_mod
from portbench.inputs import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
    BENCH = json.load(fh)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_is_found_by_name(workload):
    cell = cell_mod.load(workload)
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell_mod.reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in names  # the cell reports what its per-layer metrics move


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_a_per_layer_metric_names_its_cells_layer_and_reader(metric):
    cells = {w["name"] for w in BENCH["workloads"]}
    assert metric["workloads"] and set(metric["workloads"]) <= cells
    assert callable(cell_mod.reader(metric["name"]))
    assert metric["layer"] and "\n" not in metric["layer"] and len(metric["layer"]) <= 200
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in metric["workloads"]:  # each cell reports the metric it moves
        assert metric["moves"] in {m["name"] for m in cell_mod.load(w).end_to_end}


@pytest.mark.parametrize("P,chunk,strata", [
    (32, None, [(0, 32)]), (512, None, [(0, 512)]),
    (4096, 1024, [(8, 1032), (1032, 2056), (2056, 3080), (3080, 4096)]),
])
def test_the_check_draws_from_each_chunk(P, chunk, strata):
    from portbench.drivers.ga import _strata

    assert _strata(P, chunk, 8) == strata


def test_a_suffixed_metric_takes_its_base_reader():
    from types import SimpleNamespace

    rec = SimpleNamespace(trace={"busy_s": 0.75, "window_s": 1.0})
    for name in ("idle_pct", "idle_pct.adam", "idle_pct.p4096"):
        assert cell_mod.reader(name)(rec) == pytest.approx(25.0)


def test_names_units_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
