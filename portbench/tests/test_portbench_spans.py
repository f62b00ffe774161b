"""Device operations put down to the program's spans (portbench/spans.py) and
the span metrics' readers, on synthetic trace excerpts in the form
torch.profiler exports them."""
from types import SimpleNamespace

import pytest

from portbench import cell as cell_mod
from portbench import spans, trace

NAMES = ("ga.step", "objective.evaluate", "render.bin", "render.walk", "ga.elitism",
         "block.replay", "adam.step", "adam.value_and_grad", "render.grad", "adam.update")
MAIN, BWD = 1, 2  # the thread ids of the caller and of autograd's backward


def _x(name, cat, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur, tid=MAIN):
    return _x(name, "user_annotation", ts, dur, tid)


def _launch(ts, corr, tid=MAIN, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, 2.0, tid, corr)


def _op(ts, dur, corr, cat="kernel"):
    return _x(f"op{corr}", cat, ts, dur, corr=corr)


def test_eager_operations_by_correlation_nested_and_on_a_second_thread():
    events = [
        _span("adam.step", 0.0, 100.0), _span("adam.value_and_grad", 1.0, 60.0),
        _span("render.bin", 2.0, 10.0), _launch(3.0, 1), _launch(20.0, 2),
        # autograd's thread: one launch in its own span, one in none of its own
        _span("render.grad", 30.0, 10.0, tid=BWD), _launch(31.0, 3, tid=BWD),
        _launch(45.0, 4, tid=BWD),
        _span("adam.update", 70.0, 20.0), _launch(71.0, 5, name="cuLaunchKernel"),
        _launch(95.0, 6), _launch(120.0, 7),  # the step's own; after every span
        _op(10.0, 5.0, 1), _op(25.0, 4.0, 2, "gpu_memset"), _op(40.0, 8.0, 3),
        _op(50.0, 3.0, 4), _op(80.0, 2.0, 5, "gpu_memcpy"), _op(100.0, 1.0, 6),
        _op(130.0, 6.0, 7), _op(140.0, 9.0, 99),  # no launch recorded
        _x("portbench.window", "user_annotation", 0.0, 200.0),  # not a program span
    ]
    a = spans.attribute(events, names=NAMES)
    vg = "adam.step/adam.value_and_grad"
    assert a["ops"] == {vg + "/render.bin": 1, vg: 2, vg + "/render.grad": 1,
                        "adam.step/adam.update": 1, "adam.step": 1, "outside": 2}
    assert a["self_s"][vg] == pytest.approx(7e-6)
    assert a["self_s"]["outside"] == pytest.approx(15e-6)
    assert a["device_s"] == pytest.approx(38e-6)
    assert a["spans_seen"] == 5 and a["replays"] == 0 and a["replay_idle_s"] == 0.0


def _replay(corr, ts0, n, gap_at=None, gap=0.0):
    """n operations of one replay, 2 us each, back to back but for a gap
    before operation gap_at."""
    ops, t = [], ts0
    for i in range(n):
        t += gap if i == gap_at else 0.0
        ops.append(_op(t, 2.0, corr))
        t += 2.0
    return ops


TABLE = ("ga.step/ga.draw", "ga.step/objective.evaluate/render.bin",
         "ga.step/objective.evaluate/render.walk", "ga.step/ga.elitism", "")


def test_a_replay_mapped_by_order_onto_the_span_table():
    events = [_span("block.replay", 0.0, 10.0), _launch(1.0, 11, name="cudaGraphLaunch"),
              *_replay(11, 5.0, 5, gap_at=2, gap=3.0)]
    a = spans.attribute(events, table=TABLE, names=NAMES)
    assert a["ops"] == {"block.replay/" + p if p else "block.replay": 1 for p in TABLE}
    assert a["replays"] == 1 and a["unmapped_groups"] == []
    assert a["replay_idle_s"] == pytest.approx(3e-6)
    # the gap is named by the node after it
    assert a["replay_gaps"] == [["block.replay/ga.step/objective.evaluate/render.walk",
                                 pytest.approx(3e-6), "op11"]]


def test_a_replay_of_another_length_is_reported_not_guessed():
    events = [_span("block.replay", 0.0, 40.0),
              _launch(1.0, 11, name="cudaGraphLaunch"), *_replay(11, 5.0, 5, 4, 1.0),
              _launch(2.0, 12, name="cudaGraphLaunch"), *_replay(12, 30.0, 4)]
    a = spans.attribute(events, table=TABLE, names=NAMES)
    assert a["unmapped_groups"] == [4] and a["replays"] == 2
    assert a["ops"]["unmapped"] == 4 and a["self_s"]["unmapped"] == pytest.approx(8e-6)
    assert a["replay_idle_s"] == pytest.approx(1e-6)
    assert spans.attribute(events, table=None, names=NAMES)["unmapped_groups"] == [4, 5]


def test_gaps_named_by_the_next_node_longest_first():
    table = ("a", "b", "c", "d")
    events = [_launch(1.0, 11, name="cudaGraphLaunch"),
              _op(10.0, 2.0, 11), _op(13.0, 5.0, 11), _op(14.0, 2.0, 11), _op(30.0, 1.0, 11)]
    a = spans.attribute(events, table=table, names=("a", "b", "c", "d"))
    # c starts inside b: no gap; d after b's end at 18
    assert a["replay_gaps"] == [["d", pytest.approx(12e-6), "op11"],
                                ["b", pytest.approx(1e-6), "op11"]]
    assert a["replay_gap_s"] == {"d": pytest.approx(12e-6), "b": pytest.approx(1e-6)}
    assert a["ops"] == {"a": 1, "b": 1, "c": 1, "d": 1}


def _rec(kind, reading):
    return SimpleNamespace(kind=kind, trace=reading)


def _reading(self_s, replays=1, idle=0.0, seen=3):
    return {"units": 10, "window_s": 0.5, "spans": {
        "spans_seen": seen, "self_s": self_s, "replays": replays, "replay_idle_s": idle}}


GA = {"block.replay/ga.step/ga.draw": 0.002, "block.replay/ga.step/ga.elitism": 0.001,
      "block.replay/ga.step/objective.evaluate": 0.004,
      "block.replay/ga.step/objective.evaluate/render.screen": 0.003,
      "block.replay/ga.step/objective.evaluate/render.bin": 0.005,
      "block.replay/ga.step/objective.evaluate/render.walk": 0.050,
      "block.prepare": 0.0005, "outside": 0.0001}
ADAM = {"adam.step/adam.value_and_grad/render.feats": 0.006,
        "adam.step/adam.value_and_grad/render.grad": 0.060, "adam.step/adam.update": 0.002}


@pytest.mark.parametrize("name,kind,self_s,value", [
    ("ga_ops_ms_per_gen", "ga", GA, 0.3), ("ga_ops_ms_per_gen.p4096", "ga", GA, 0.3),
    ("render_prep_ms_per_gen", "ga", GA, 0.8), ("render_prep_ms_per_gen.p512", "ga", GA, 0.8),
    ("render_prep_ms_per_step", "adam", ADAM, 0.6), ("adam_update_ms_per_step", "adam", ADAM, 0.2),
])
def test_span_readers_in_their_cells_and_none_elsewhere(name, kind, self_s, value):
    read = cell_mod.reader(name)
    assert read(_rec(kind, _reading(self_s))) == pytest.approx(value)
    other = "adam" if kind == "ga" else "ga"
    assert read(_rec(other, _reading(self_s))) is None
    assert read(_rec(kind, None)) is None  # a timed run: no trace
    assert read(_rec(kind, {"units": 10, "window_s": 0.5})) is None  # no spans read
    assert read(_rec(kind, _reading({"outside": 0.01}, seen=0))) is None  # a program without


@pytest.mark.parametrize("name", ["replay_idle_pct", "replay_idle_pct.adam"])
def test_replay_idle_pct(name):
    read = cell_mod.reader(name)
    assert read(_rec("ga", _reading(GA, idle=0.01))) == pytest.approx(2.0)
    assert read(_rec("adam", _reading(ADAM, replays=0))) is None  # an eager block
    assert read(_rec("ga", _reading({"outside": 0.01}, seen=0))) is None


def test_summarize_reads_the_same_with_program_spans_in_the_trace():
    """Program spans are host events: the window's reading is unchanged,
    but for the name of an idle gap under one."""
    k1 = "void ggs::fitness_kernel<0>(ggs::WalkParams, float const*, float*, int*)"
    events = [
        _x(trace.WINDOW, "user_annotation", 1000.0, 100.0),
        _x("cudaGraphLaunch", "cuda_runtime", 1001.0, 4.0),
        _x(k1, "kernel", 1010.0, 30.0), _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy",
                                           1050.0, 5.0),
    ]
    table = trace.load_table()
    plain = trace.summarize(events, table, 1e-4)
    spanned = trace.summarize(events + [_span("block.replay", 1000.5, 5.0),
                                        _span("ga.step", 1060.0, 30.0)], table, 1e-4)
    gaps = dict(spanned.pop("idle_gaps"))
    plain_gaps = dict(plain.pop("idle_gaps"))
    assert spanned == plain
    # 1055-1100 lies under ga.step at its middle; 1000-1010 under the graph
    # launch, shorter than the span around it
    assert plain_gaps == {"cudaGraphLaunch": pytest.approx(10e-6), "host": pytest.approx(55e-6)}
    assert gaps == {"cudaGraphLaunch": pytest.approx(10e-6), "host": pytest.approx(10e-6),
                    "ga.step": pytest.approx(45e-6)}
