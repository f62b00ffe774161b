"""The port's program spans (utils/profiling.span) and the span tables of
captured run blocks (utils/block_graph.py).

On the CPU, at a small size: a GA block, Adam steps and a memetic block
under torch.profiler open the spans of profiling.SPANS nested as the
layers nest (the memetic refinement's Adam steps and accept under
ga.refine); the package
opens no span outside SPANS; with the profiler off and no capture a span
opens nothing; span_paths maps a captured chain's marks to span paths.
On a card (marked `cuda`, skipped here): the span table of a captured GA
block and Adam block covers each kernel, copy and fill node once, its count
per span equals the eager block's by correlation (portbench/spans.py), and
a replay equals the eager block in bits."""
import collections
import json
import os
import re

import pytest
import torch

from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig
from ggs_tpu_torch.models import ga, gradient
from ggs_tpu_torch.ops import objective
from ggs_tpu_torch.ops import render_cuda as rc
from ggs_tpu_torch.utils import block_graph, profiling
from torch_inputs import axes_genomes, image
from torch_inputs import one_torch_thread  # noqa: F401 (autouse fixture)

H, W, N = 24, 40, 6
PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ggs_tpu_torch")


def _paths(tmp_path, fn) -> collections.Counter:
    """fn() under torch.profiler (CPU) -> the count of each span path opened
    ("ga.step/objective.evaluate"), the spans nested by their intervals."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = str(tmp_path / "trace.json")
    prof.export_chrome_trace(out)
    with open(out) as fh:
        events = json.load(fh)["traceEvents"]
    spans = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] in profiling.SPANS),
                   key=lambda e: (e["ts"], -e["dur"]))
    stack, paths = [], collections.Counter()
    for e in spans:
        while stack and stack[-1][1] < e["ts"] + e["dur"]:
            stack.pop()
        path = (stack[-1][0] + "/" if stack else "") + e["name"]
        paths[path] += 1
        stack.append((path, e["ts"] + e["dur"]))
    return paths


def _ga(gens: int = 3):
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    gcfg = GAConfig(pop_size=4, elite_k=1, generations=20)
    gnm = GenomeConfig(n_splats=N)
    tgt = torch.from_numpy(image(1, H, W))
    state = ga.init(torch.Generator().manual_seed(2), obj, tgt, None, gcfg, gnm)
    return ga.make_run_block(obj, gcfg, gnm), state, tgt


def test_a_ga_block_opens_one_step_a_generation_nested_as_the_layers(tmp_path):
    run, state, tgt = _ga()
    paths = _paths(tmp_path, lambda: run(state, tgt, None, 3))
    ev = "ga.step/objective.evaluate"
    assert paths == {
        "block.prepare": 1, "ga.step": 3, "ga.step/ga.draw": 3, "ga.step/ga.variation": 3,
        ev: 3, ev + "/render.screen": 9,  # the codec, the boxes, the padded target
        ev + "/render.bin": 3, ev + "/render.feats": 3, ev + "/render.walk": 3,
        "ga.step/ga.elitism": 3,
    }


@pytest.mark.parametrize("route", ["fused", "chained"])
def test_an_adam_step_opens_value_and_grad_and_update(tmp_path, monkeypatch, route):
    """K7's fused step, and above the pass size (lowered to 4) the chained
    passes through autograd: K2' walks forward and K6 in the backward."""
    if route == "chained":
        monkeypatch.setattr(rc, "MAX_SPLATS", 4)
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    make_opt, step = gradient.make_fit_step(obj, GenomeConfig(n_splats=N), GradConfig(lr=1e-2))
    state = gradient.init_state(make_opt, torch.from_numpy(axes_genomes(3, 2, N, H, W)))
    tgt = torch.from_numpy(image(4, H, W))
    paths = _paths(tmp_path, lambda: step(state, tgt, None))
    vg = "adam.step/adam.value_and_grad"
    passes = 2 if route == "chained" else 1
    want = {"adam.step": 1, vg: 1, "adam.step/adam.update": 1, vg + "/render.grad": passes,
            vg + "/render.bin": passes}
    if route == "fused":  # the codec, the boxes, the padded target; K7's table
        want.update({vg + "/render.screen": 3, vg + "/render.feats": 1})
    else:  # the codec, the boxes; each pass's walk table and its raw table
        want.update({vg + "/render.screen": 2, vg + "/render.feats": 4,
                     vg + "/render.walk": 2})
    assert paths == want


def test_a_memetic_block_nests_its_refinement_under_ga_refine(tmp_path):
    """A memetic block of 2 generations that refines after the second: the
    refinement's Adam steps and its accept's evaluate nest under ga.refine,
    and the GA's own evaluate does not."""
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    gcfg = GAConfig(pop_size=4, elite_k=2, generations=20)
    gnm = GenomeConfig(n_splats=N)
    tgt = torch.from_numpy(image(1, H, W))
    state = ga.init(torch.Generator().manual_seed(2), obj, tgt, None, gcfg, gnm)
    run = ga.make_memetic_run_block(obj, gcfg, gnm, GradConfig(lr=1e-2), 2, 3)
    paths = _paths(tmp_path, lambda: run(state, tgt, None, 2))
    vg = "ga.refine/adam.step/adam.value_and_grad"
    assert paths["ga.step"] == 2 and paths["ga.refine"] == 1
    assert paths["ga.step/objective.evaluate"] == 2
    assert paths["ga.refine/adam.step"] == 3 and paths[vg] == 3
    assert paths[vg + "/render.grad"] == 3 and paths["ga.refine/adam.step/adam.update"] == 3
    assert paths["ga.refine/objective.evaluate"] == 1  # the accept
    assert paths["ga.refine/objective.evaluate/render.walk"] == 1
    assert not any(p.startswith("ga.refine") for p in paths if "ga.step" in p)
    assert sum(n for p, n in paths.items() if p.endswith("objective.evaluate")) == 3


def test_the_package_opens_only_published_spans():
    opened = collections.Counter()
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    opened.update(re.findall(r'profiling\.span\("([^"]+)"\)', fh.read()))
    assert set(opened) == set(profiling.SPANS)
    assert len(profiling.SPANS) == len(set(profiling.SPANS))


def test_without_profiler_or_capture_a_span_opens_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function called with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("ga.step") is profiling.span("adam.step")  # the one null context
    run, state, tgt = _ga()
    run(state, tgt, None, 2)


def test_a_capture_is_told_every_span_entry_and_exit():
    marks = []
    with profiling.capturing(marks.append):
        with profiling.span("adam.step"):
            with profiling.span("adam.update"):
                pass
    with profiling.span("ga.step"):  # after the capture: told nothing
        pass
    assert marks == ["adam.step", "adam.update", None, None]


A, B, C, D, E, F = (0xA0, 0xB0, 0xC0, 0xD0, 0xE0, 0xF0)  # node handles of a chain


@pytest.mark.parametrize("marks,paths", [
    # X around a..e; Y around c, d; Z opened and closed after d (empty); f outside
    ([("X", None), ("Y", B), (None, D), ("Z", D), (None, D), (None, E)],
     ["X", "X", "X/Y", "X/Y", "X", ""]),
    ([], [""] * 6),
    ([("X", F), (None, F)], [""] * 6),  # an empty span at the end
    ([("X", None), ("Y", None), (None, A), (None, F)], ["X/Y", "X", "X", "X", "X", "X"]),
])
def test_span_paths_of_a_chain(marks, paths):
    assert block_graph.span_paths([A, B, C, D, E, F], marks) == paths


@pytest.mark.parametrize("marks", [
    [("X", 0x99), (None, F)],  # a node outside the chain
    [("X", block_graph.UNKNOWN), (None, F)],  # a position that could not be read
    [("X", C), (None, B)],  # back along the chain
    [(None, B)],  # closes nothing
])
def test_span_paths_refuse_marks_that_do_not_fit(marks):
    with pytest.raises(ValueError):
        block_graph.span_paths([A, B, C, D, E, F], marks)


def _eager_ops(tmp_path, fn) -> collections.Counter:
    """fn() under torch.profiler on the card -> device operations by span
    path, put down by correlation (portbench/spans.py)."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import spans

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    path = str(tmp_path / "eager.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    return out, collections.Counter(spans.attribute(events)["ops"])


def _check_table(graph, tmp_path, eager) -> object:
    """The graph's span table against the eager block profiled (a session
    that lost records is made again, up to three): -> the eager output."""
    from portbench import spans

    table = graph.spans
    assert table is not None
    assert len(table) == sum(graph.nodes[k] for k in block_graph.DEVICE_KINDS)
    for _ in range(3):
        out, ops = eager()
        if sum(ops.values()) >= len(table):
            break
    # the eager block's operations under no span (its metrics' stack) are
    # the table's "" (under block.replay in a replay)
    assert ops == collections.Counter(p or spans.OUTSIDE for p in table)
    return out


@pytest.mark.cuda
def test_span_table_of_a_captured_ga_block(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a captured graph)")
    dev = torch.device("cuda")
    obj = objective.Objective(H=64, W=128, precision="exact-tight")
    gcfg = GAConfig(pop_size=8, elite_k=2, generations=100)
    gnm = GenomeConfig(n_splats=64)
    tgt = torch.from_numpy(image(5, 64, 128)).to(dev)
    state = ga.init(torch.Generator(device=dev).manual_seed(6), obj, tgt, None, gcfg, gnm)
    run = ga.make_run_block(obj, gcfg, gnm)
    state, _ = run(state, tgt, None, 4)  # eager, then captured
    graph = run.graphs.last

    def eager():
        rng = torch.Generator(device=dev)
        rng.set_state(state.rng.get_state())
        st = state._replace(pop=state.pop.clone(), fits=state.fits.clone(), rng=rng)
        run.prepare(st, 4)
        return _eager_ops(tmp_path, lambda: run.loop(st, tgt, None, 4))

    want, metrics = _check_table(graph, tmp_path, eager)
    got, got_metrics = run(state, tgt, None, 4)  # replayed
    assert run.graphs.replays == 1
    for a, b in zip(tuple(got[:5]) + (got_metrics,), tuple(want[:5]) + (metrics,)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "chained"])
def test_span_table_of_a_captured_adam_block(tmp_path, monkeypatch, route):
    """The chained route (the pass size lowered to 32) runs K6 in autograd's
    backward, on its own thread: its spans nest under the step's all the
    same, in the table and by correlation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a captured graph)")
    if route == "chained":
        monkeypatch.setattr(rc, "MAX_SPLATS", 32)
    dev = torch.device("cuda")
    obj = objective.Objective(H=64, W=128, precision="exact-tight")
    run = gradient.make_run_block(obj, GenomeConfig(n_splats=64), GradConfig(lr=1e-2))
    state = gradient.init_state(run.make_opt,
                                torch.from_numpy(axes_genomes(7, 2, 64, 64, 128)).to(dev))
    tgt = torch.from_numpy(image(8, 64, 128)).to(dev)
    state, _ = run(state, tgt, None, 1)  # eager: a fresh Adam makes its moments
    state, _ = run(state, tgt, None, 3)  # eager, then captured
    graph = run.graphs.last
    start = [t.clone() for t in gradient._adam_tensors(state).values()]

    def eager():
        for t, v in zip(gradient._adam_tensors(state).values(), start):
            t.copy_(v)
        out = _eager_ops(tmp_path, lambda: run.eager(state, tgt, None, 3)[1])
        return (out[0], [t.clone() for t in gradient._adam_tensors(state).values()]), out[1]

    (fits, after) = _check_table(graph, tmp_path, eager)
    for t, v in zip(gradient._adam_tensors(state).values(), start):
        t.copy_(v)
    state, got = run(state, tgt, None, 3)  # replayed
    assert run.graphs.replays == 1
    assert torch.equal(got, fits)
    for a, b in zip(gradient._adam_tensors(state).values(), after):
        assert torch.equal(a, b)
