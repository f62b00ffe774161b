"""A driver and its faults are found by the traffic's driver name: a
driver module that only sits under portbench.drivers (here a stub put
into sys.modules) is run by run_cell, its record read by the readers, its
traced reading carries the program's spans, and portbench.control finds
its own FAULTS."""
import sys
import types

import pytest

from portbench import cell as cell_mod
from portbench import control, harness, run, trace
from portbench.faults import FAULTS

NAMES = ("ga.step", "render.walk", "block.replay")


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one replay of a two-node graph inside the window, 6 us busy of 10
EVENTS = [_x(trace.WINDOW, "user_annotation", 0.0, 10.0),
          _x("block.replay", "user_annotation", 0.5, 2.0),
          _x("cudaGraphLaunch", "cuda_runtime", 1.0, 1.0, corr=5),
          _x("void ggs::fitness_kernel<0>(ggs::WalkParams)", "kernel", 2.0, 4.0, corr=5),
          _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 7.0, 2.0, corr=5)]
TABLE = ("ga.step/render.walk", "ga.step")


def _stub_run(cell, seed, seconds, trace_, device, control_, t_start):
    rec = harness.record(kind="stub", setup_s=1.5 + control_)
    if trace_:
        rec.trace = trace.read_session(EVENTS, trace.load_table(), 1e-5, TABLE, NAMES)
        rec.trace.update(units=2, attempts=1, settled=True, op_counts=[rec.trace["ops"]])
    else:
        rec.window = {"units": 40, "seconds": 2.0, "blocks": 4}
    checks = [harness.check("gap", 0.5 * seed, 1.0)]
    return rec, checks, {"platform": "cpu", "count": 1}, 40


def _stub_fault(mp):
    mp.setattr(sys.modules[__name__], "EVENTS", [])


@pytest.fixture
def stub(monkeypatch):
    """portbench.drivers.stub, a module that exists only in sys.modules."""
    mod = types.ModuleType("portbench.drivers.stub")
    mod.run, mod.FAULTS = _stub_run, {"no-events": _stub_fault}
    monkeypatch.setitem(sys.modules, "portbench.drivers.stub", mod)
    return mod


def _cell(driver="stub"):
    e2e = [{"name": "setup_s", "unit": "s"}, {"name": "renders_per_s", "unit": "renders/s"}]
    per_layer = [{"name": "idle_pct.stub", "unit": "%"}, {"name": "replay_idle_pct", "unit": "%"},
                 {"name": "ga_ops_ms_per_gen", "unit": "ms"}]
    return cell_mod.Cell(name="stub-cell", chips=1, config={}, traffic={"driver": driver},
                         limits={}, end_to_end=e2e, per_layer=per_layer)


def test_a_driver_found_by_name_is_run_and_its_record_read(stub):
    out = run.run_cell(_cell(), 1, 1.0, False, "cpu")
    assert out["correct"] and out["attempted"] == 40 and list(out)[-1] == "checks"
    # renders_per_s reads only a "ga" record: left out of the line, not 0
    assert out["metrics"] == {"setup_s": {"value": 1.5, "unit": "s"}}
    assert out["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}
    assert not run.run_cell(_cell(), 3, 1.0, False, "cpu")["correct"]
    assert run.run_cell(_cell(), 1, 1.0, False, "cpu", control=True)["metrics"]["setup_s"][
        "value"] == 2.5  # control reaches the driver


def test_a_traced_result_carries_the_spans(stub):
    out = run.run_cell(_cell(), 1, 1.0, True, "cpu")
    assert list(out)[-1] == "checks"
    assert out["metrics"]["idle_pct.stub"]["value"] == pytest.approx(40.0)
    assert out["metrics"]["replay_idle_pct"]["value"] == pytest.approx(10.0)  # 1 us of 10
    assert "ga_ops_ms_per_gen" not in out["metrics"]
    sp = out["spans"]
    assert sp["ms_per_unit"] == {"block.replay/ga.step/render.walk": pytest.approx(2e-3),
                                 "block.replay/ga.step": pytest.approx(1e-3)}
    assert sp["outside_pct"] == 0.0 and sp["unmapped_groups"] == []
    assert out["device"]["busy_s"] == pytest.approx(6e-6)


@pytest.mark.parametrize("name,error,says", [
    ("no_such_driver", ModuleNotFoundError, "portbench/drivers/no_such_driver.py"),
    ("mem-etic", ValueError, "portbench/drivers/mem-etic.py"),
    ("../ga", ValueError, "not a Python identifier"),
])
def test_an_unknown_driver_names_the_file_it_looked_for(name, error, says):
    with pytest.raises(error, match=says.replace(".", r"\.")):
        run.run_cell(_cell(name), 1, 1.0, False, "cpu")


def test_the_drivers_in_the_repository_are_found():
    for name in ("ga", "adam"):
        assert callable(run.driver(name).run)


def test_faults_of_a_driver_in_faults_py_and_in_its_own_module(stub):
    assert control.faults_of("ga") is FAULTS["ga"]
    assert control.faults_of("adam") is FAULTS["adam"]
    assert control.faults_of("stub") is stub.FAULTS
    del stub.FAULTS
    assert control.faults_of("stub") == {}


def test_a_drivers_own_fault_breaks_its_run(stub, monkeypatch):
    control.faults_of("stub")["no-events"](monkeypatch)
    out = run.run_cell(_cell(), 1, 1.0, True, "cpu")
    assert "replay_idle_pct" not in out["metrics"]


@pytest.mark.parametrize("driver,known", [("ga", "answer-altered, half-batch, state-unchanged"),
                                          ("stub", "no-events")])
def test_an_unknown_fault_lists_the_known_ones(driver, known, stub, monkeypatch, capsys):
    monkeypatch.setattr(control.cell_mod, "load", lambda name: _cell(driver))
    with pytest.raises(SystemExit) as e:
        control.main(["--workload", "any", "--seeds", "1", "--fault", "nope"])
    assert e.value.code == 2
    assert f"it knows: {known}" in capsys.readouterr().err
