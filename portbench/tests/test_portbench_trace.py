"""The kernel table and the trace reading, on an excerpt of a recorded
trace (names as torch.profiler recorded them on the H100)."""
import pytest

from portbench import trace

NAMES = {
    "void ggs::fitness_kernel<0>(ggs::WalkParams, float const*, float const*, float*, float*, int*)": "K1",
    "void ggs::render_kernel<0>(ggs::WalkParams, float*)": "K2",
    "void ggs_grad::grad_kernel<false>(ggs_grad::GradParams)": "K6",
    "ggs_grad::sub_sum_kernel(int const*, int const*, float const*, float const*, float*, float*, int, int, int)": "K6-K7-sums",
    "void ggs_scatter::tile_kernel<false>(ggs_scatter::Splats, ggs_scatter::Geometry, int4 const*, int const*, int*, int*, int*, bool)": "K5",
    "void at::native::radixSortKVInPlace<2, -1, 32, 32, int, long, unsigned int>(at::cuda::detail::TensorInfo<int, unsigned int>, unsigned int)": "sort.int",
    "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<at_cuda_detail::cub::DeviceRadixSortPolicy<int, long, int>::Policy900, true, false, int, long>": "sort.int",
    "at::native::(anonymous namespace)::fill_reverse_indices_kernel(long*, int, at::cuda::detail::IntDivider<unsigned int>)": "sort.int",
    "void at::native::radixSortKVInPlace<-2, -1, 32, 32, float, long, unsigned int>(at::cuda::detail::TensorInfo<float, unsigned int>)": "other",
    "Memcpy DtoD (Device -> Device)": "other",
}


@pytest.mark.parametrize("name,kernel", sorted(NAMES.items()))
def test_kernel_table(name, kernel):
    assert trace.kernel_of(name, trace.load_table()) == kernel


def _x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summary_of_an_excerpt():
    k1 = next(n for n, k in NAMES.items() if k == "K1")
    sort = next(n for n, k in NAMES.items() if k == "sort.int")
    events = [
        _x(trace.WINDOW, "user_annotation", 1000.0, 100.0),
        _x("cudaGraphLaunch", "cuda_runtime", 1001.0, 4.0),
        _x("aten::copy_", "cpu_op", 1060.0, 30.0),
        _x("cudaStreamSynchronize", "cuda_runtime", 1062.0, 20.0),
        _x(k1, "kernel", 1010.0, 30.0),
        _x(sort, "kernel", 1030.0, 15.0),  # overlaps K1 by 10
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1050.0, 5.0),
        _x("void at::native::vectorized_elementwise_kernel<4>()", "kernel", 1090.0, 4.0),
        _x("gpu annotation", "gpu_user_annotation", 1000.0, 100.0),
    ]
    s = trace.summarize(events, trace.load_table(), window_s=1e-4)
    assert s["ops"] == 4
    assert s["busy_s"] == pytest.approx((35 + 5 + 4) * 1e-6)
    assert s["by_kernel"]["K1"] == pytest.approx(30e-6)
    assert s["by_kernel"]["sort.int"] == pytest.approx(15e-6)
    assert s["by_kernel"]["other"] == pytest.approx(9e-6)
    assert s["device_ops"][0] == ["ggs::fitness_kernel<0>", pytest.approx(30e-6)]
    gaps = dict(s["idle_gaps"])
    # 1000-1010 under the graph launch, 1055-1090 under the copy's
    # synchronise (the innermost host event), 1045-1050 and 1094-1100 under none
    assert gaps["cudaStreamSynchronize"] == pytest.approx(35e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["host"] == pytest.approx((5 + 6) * 1e-6)


@pytest.mark.parametrize("counts,min_ops,ok", [
    ([1036], 1036, True), ([1035], 1036, False), ([1040], 1036, True),  # a graph's node count
    ([1036], None, False), ([980, 1036], None, False), ([1036, 1036], None, True),  # eager
    ([980, 1036, 1036], None, True),
])
def test_a_session_that_lost_records_is_made_again(counts, min_ops, ok):
    assert trace.settled(counts, min_ops) is ok


# a session of one replay of a three-node graph, in the form torch.profiler
# exports it; `lose` drops that many of its device records
SPAN_NAMES = ("block.replay", "ga.step", "render.walk")
GRAPH_TABLE = ("ga.step", "ga.step/render.walk", "ga.step")


def _session(lose=0):
    def ev(name, cat, ts, dur, corr=None):
        e = dict(_x(name, cat, ts, dur), pid=1, tid=1)
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    ops = [ev("Memset (Device)", "gpu_memset", 3.0, 1.0, 9),
           ev(next(n for n, k in NAMES.items() if k == "K1"), "kernel", 5.0, 10.0, 9),
           ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 16.0, 2.0, 9)]
    return [ev(trace.WINDOW, "user_annotation", 0.0, 20.0),
            ev("block.replay", "user_annotation", 1.0, 2.0),
            ev("cudaGraphLaunch", "cuda_runtime", 1.5, 1.0, 9)] + ops[lose:]


def test_a_session_reading_carries_the_spans():
    r = trace.read_session(_session(), trace.load_table(), 2e-5, GRAPH_TABLE, SPAN_NAMES)
    assert r["ops"] == 3 and r["spans"]["unmapped_groups"] == []
    assert r["spans"]["self_s"] == {"block.replay/ga.step": pytest.approx(3e-6),
                                    "block.replay/ga.step/render.walk": pytest.approx(10e-6)}
    assert r["spans"]["replay_idle_s"] == pytest.approx(2e-6)  # 4-5 and 15-16
    plain = trace.summarize(_session(), trace.load_table(), 2e-5)
    assert {k: v for k, v in r.items() if k != "spans"} == plain


def test_a_replay_that_does_not_map_counts_its_operations_lost():
    r = trace.read_session(_session(lose=1), trace.load_table(), 2e-5, GRAPH_TABLE, SPAN_NAMES)
    assert r["spans"]["unmapped_groups"] == [2]
    assert r["ops"] == 0  # 2 recorded, both in a replay that maps onto nothing
    eager = trace.read_session(_session(lose=1), trace.load_table(), 2e-5, None, SPAN_NAMES)
    assert eager["spans"]["unmapped_groups"] == [2]  # a replay with no table maps onto nothing


class _FakeProfiler:
    """torch.profiler.profile's stand-in: each session exports the next of
    `sessions`."""

    def __init__(self, sessions):
        self.sessions = iter(sessions)

    def __call__(self, **kw):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        import json

        with open(path, "w") as fh:
            json.dump({"traceEvents": next(self.sessions)}, fh)


@pytest.mark.parametrize("lost,attempts", [([0], 1), ([1, 0], 2), ([1, 1, 1, 1], 4)])
def test_profile_makes_again_a_session_whose_replay_did_not_map(lost, attempts, monkeypatch,
                                                                tmp_path):
    import torch

    from portbench import spans

    monkeypatch.setattr(torch.profiler, "profile",
                        _FakeProfiler([_session(n) for n in lost]))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(spans, "program_spans", lambda: SPAN_NAMES)
    monkeypatch.setattr(trace, "OUT_DIR", str(tmp_path))
    asked = []
    r = trace.profile(lambda: None, 3, trace.load_table(),
                      span_table=lambda: asked.append(1) or GRAPH_TABLE)
    assert r["attempts"] == attempts and len(asked) == attempts
    assert r["op_counts"] == [0 if n else 3 for n in lost]
    assert r["settled"] is (lost[-1] == 0)
    assert r["spans"]["unmapped_groups"] == ([2] if lost[-1] else [])
    assert list(tmp_path.iterdir()) == []  # each session's trace is deleted once read
