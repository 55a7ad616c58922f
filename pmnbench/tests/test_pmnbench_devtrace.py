"""The reduction of a traced window (`devtrace.summarize`) on a made-up
chrome trace: busy time is the union of the device events inside the
window, each event takes its group from `kernel_groups/`, and each idle gap
is named by the innermost host event open when it began."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE))]

from pmnbench import devtrace  # noqa: E402


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


TRACE = [
    _event("user_annotation", devtrace.WINDOW, 1000.0, 100.0),
    _event("cpu_op", "aten::conv2d", 1000.0, 30.0),
    _event("cuda_runtime", "cudaLaunchKernel", 1010.0, 5.0),
    _event("cpu_op", "aten::copy_", 1060.0, 30.0),
    # device: a convolution, a hand kernel overlapping it, a copy, NCCL, and
    # one event that starts before the window (clipped)
    _event("kernel", "sm80_xmma_fprop_implicit_gemm_bf16", 1005.0, 20.0),
    _event("kernel", "void pmn::group_corr_tile_kernel<__nv_bfloat16, 64, 8, "
           "(pmn::Samples)1>(...)", 1020.0, 10.0),
    _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1070.0, 10.0),
    _event("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 1085.0, 5.0),
    _event("kernel", "void at::native::elementwise_kernel<128, 2>", 990.0, 20.0),
]


def test_summarize():
    s = devtrace.summarize(TRACE, units=2)
    assert s.window_s == pytest.approx(100e-6)
    # busy: [1000, 1030] (clipped elementwise, conv, K6) + [1070, 1080] + [1085, 1090]
    assert s.busy_s == pytest.approx(45e-6)
    assert s.launches == 4
    assert s.group_s["convolutions"] == pytest.approx(20e-6)
    assert s.group_s["K6"] == pytest.approx(10e-6)
    assert s.group_s["copy"] == pytest.approx(10e-6)
    assert s.group_s["nccl"] == pytest.approx(5e-6)
    assert s.group_s["glue"] == pytest.approx(10e-6)
    assert sum(v for k, v in s.copy_s.items() if "HtoD" in k) == pytest.approx(10e-6)
    gaps = dict(s.idle_gaps)
    # no host event is open when [1030, 1070] and [1090, 1100] begin;
    # aten::copy_ is when [1080, 1085] begins
    assert gaps["no_host_event"] == pytest.approx(40e-6 + 10e-6)
    assert gaps["aten::copy_"] == pytest.approx(5e-6)


def test_groups_follow_the_files_in_order():
    rules = devtrace.kernel_groups()
    assert devtrace.group_of("void pmn::warp_corr_bwd_merge_kernel<float>", rules) == "K4"
    assert devtrace.group_of("cutlass__5x_cudnn::Kernel", rules) == "convolutions"
    assert devtrace.group_of("void at::native::reduce_kernel", rules) == "glue"


def test_every_reader_reads_a_window():
    """Each metric file of `metrics/` reads a made-up window: a number, or
    None where the window has nothing for it, and no share above 100."""
    import glob

    from pmnbench import harness

    trace = devtrace.summarize(TRACE, units=2)
    cell = harness.Cell({}, {}, {"kind": "train"}, {}, [], [])
    window = harness.Window(cell, setup_s=12.0, window_s=30.0, count=120, samples=960,
                            request_s=[0.2] * 150, peak_bytes=2 ** 33, ranks=1, trace=trace,
                            bound={"bound_ms": 18.0, "groups": {"convolutions": 0.001,
                                                                "K6": 0.0005}})
    names = [os.path.basename(p)[:-3] for p in
             glob.glob(os.path.join(os.path.dirname(HERE), "metrics", "*.py"))]
    values = {name: harness.read_metric(name, window) for name in names}
    assert values["h2d_ms.infer"] == pytest.approx(5e-3)  # 10 us over 2 maps
    assert values["nccl_ms_per_step.dp"] == pytest.approx(2.5e-3)
    assert values["conv_roofline.infer"] == pytest.approx(100 * 0.001 * 2 / 20e-3)
    assert values["device_idle_share.train"] == pytest.approx(55.0)
    assert values["request_p90_ms.infer"] == pytest.approx(200.0)
    assert values["train_samples_per_s"] == pytest.approx(32.0)
    assert values["peak_device_gib"] == pytest.approx(8.0)
    for name, value in values.items():
        assert value is None or value >= 0, name
        if "roofline" in name or "mfu" in name:
            assert value is None or value <= 100, name
