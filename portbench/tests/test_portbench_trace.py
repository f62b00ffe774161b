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
