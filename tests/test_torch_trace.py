"""The device-trace helpers of the port (`patchmatchnet_torch.utils.trace`)
on hand-made traces: no profiler and no card needed."""

import pytest

from patchmatchnet_torch.utils import trace


def test_busy_union_merges_overlaps_and_keeps_gaps():
    assert trace.busy_union_us([]) == 0.0
    assert trace.busy_union_us([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8)]) == 4.0


def _fake_traces(monkeypatch, traces):
    """Make trace_device_events return `traces` one after another, each a
    trace of 2 calls, with up to 3 traces per device time."""
    calls = []

    def fake(fn, n, path):
        calls.append(n)
        return traces[len(calls) - 1]

    monkeypatch.setattr(trace, "CALLS", 2)
    monkeypatch.setattr(trace, "TRIES", 3)
    monkeypatch.setattr(trace, "trace_device_events", fake)
    return calls


def test_device_ms_is_busy_time_over_calls(monkeypatch):
    # two calls, each a kernel and a copy that overlaps it
    events = [("kernel", "k", 0.0, 100.0), ("gpu_memcpy", "c", 50.0, 100.0),
              ("kernel", "k", 300.0, 100.0), ("gpu_memcpy", "c", 350.0, 100.0)]
    calls = _fake_traces(monkeypatch, [events])
    assert trace.device_ms(lambda: None) == pytest.approx(0.15)
    assert calls == [2]


def test_device_ms_drops_traces_that_lost_events(monkeypatch):
    lost = [("kernel", "k", 0.0, 10.0), ("kernel", "k", 20.0, 10.0), ("kernel", "j", 40.0, 10.0)]
    whole = lost + [("kernel", "j", 60.0, 10.0)]
    calls = _fake_traces(monkeypatch, [[], lost, whole])
    with pytest.warns(UserWarning, match="dropped"):
        assert trace.device_ms(lambda: None) == pytest.approx(0.02)
    assert calls == [2, 2, 2]
    _fake_traces(monkeypatch, [lost, lost, lost])
    with pytest.warns(UserWarning, match="not a multiple of 2"):
        assert trace.device_ms(lambda: None) is None


@pytest.mark.parametrize("ms,text", [(None, "not measured"), (0.25, "0.2500 ms")])
def test_fmt_ms(ms, text):
    assert trace.fmt_ms(ms) == text


@pytest.mark.parametrize("name,kind", [
    ("void pmn::group_corr_tile_kernel<__nv_bfloat16, 64, 8, (pmn::Samples)1>(...)",
     "hand kernels (K1-K7)"),
    ("sm80_xmma_fprop_implicit_gemm_bf16bf16", "convolutions and channel-map GEMMs"),
    ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>", "element-wise"),
    ("void at::native::reduce_kernel<512, 1>", "reductions"),
    ("grid_sampler_2d_kernel", "grid_sample"),
    ("Memcpy HtoD (Pageable -> Device)", "other"),
])
def test_kernel_kind(name, kind):
    assert trace.kernel_kind(name) == kind


@pytest.mark.parametrize("name,kid", [
    ("void pmn::group_corr_tile_kernel<__nv_bfloat16, 64, 8, (pmn::Samples)0>(const T1 *)", "K1"),
    ("void pmn::group_corr_tile_kernel<float, 32, 8, (pmn::Samples)1>(const T1 *)", "K6"),
    ("void pmn::group_corr_tile_kernel<__nv_bfloat16, 16, 4, (pmn::Samples)1, true>(const T1 *)",
     "K6"),
    ("void pmn::group_corr_tile_kernel<__nv_bfloat16, 16, 4, (pmn::Samples)2>(const T1 *)", "K3"),
    ("void pmn::group_corr_tile_kernel<__nv_bfloat16, 64, 8, (pmn::Samples)3>(const T1 *)", "K7"),
    ("void pmn::group_corr_tile_kernel<float, 16, 4, (pmn::Samples)3>(const T1 *)", "K7"),
    ("void pmn::eval_grid_score_kernel<__nv_bfloat16, 8>(const float *)", "K2"),
    ("void pmn::warp_corr_bwd_merge_kernel<__nv_bfloat16, 64, 8>(const T1 *)", "K4"),
    ("void pmn::neighbor_corr_bwd_tile_kernel<float, 16, 4>(const T1 *)", "K5"),
    ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>", None),
])
def test_hand_kernel_id(name, kid):
    assert trace.hand_kernel_id(name) == kid


@pytest.mark.parametrize("name,group", [
    ("void pmn::group_corr_tile_kernel<__nv_bfloat16, 64, 8, (pmn::Samples)1>(...)", "K6"),
    ("void pmn::warp_corr_bwd_merge_kernel<__nv_bfloat16, 64, 8>(const T1 *)", "K4"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32", "convolutions"),
    ("nvjet_hsh_64x32_64x16_1x2_h_bz_TNT", "convolutions"),
    ("void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>", "glue"),
    ("Memcpy HtoD (Pageable -> Device)", "glue"),
])
def test_trace_group(name, group):
    assert trace.trace_group(name) == group


def test_device_ms_by_group_sums_each_group_per_call(monkeypatch):
    conv, k2 = "sm90_xmma_fprop_implicit_gemm", "void pmn::eval_grid_score_kernel<float, 8>()"
    fill = "void at::native::vectorized_elementwise_kernel<4, FillFunctor<float>>"
    events = [("kernel", conv, 0.0, 100.0), ("kernel", k2, 100.0, 40.0),
              ("kernel", fill, 200.0, 20.0), ("kernel", conv, 300.0, 100.0),
              ("kernel", k2, 400.0, 40.0), ("kernel", fill, 500.0, 20.0)]
    calls = _fake_traces(monkeypatch, [events])
    busy, groups = trace.device_ms_by_group(lambda: None, calls=2)
    assert calls == [2]
    assert busy == pytest.approx(0.16)
    assert groups == pytest.approx({"convolutions": 0.1, "K2": 0.04, "glue": 0.02})
    lost = events[:-1]
    _fake_traces(monkeypatch, [lost, lost, lost])
    with pytest.warns(UserWarning, match="not a multiple of 2"):
        assert trace.device_ms_by_group(lambda: None, calls=2) is None
