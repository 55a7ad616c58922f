"""The span metrics (`spans.py`, readers in `metrics/`) in tiny traced runs
on the CPU: each cell reports its host-clock span metrics, none of them 0,
and leaves out the device intervals (the CPU has no CUDA events); a
program without spans leaves all of them out and the run still ends with
its line."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [HERE]

import tiny  # noqa: E402

MANIFEST = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
SPAN_METRICS = {
    "eth3d-maps": (["copy_in_ms.infer", "copy_in_gb_per_s.infer", "host_wait_ms.infer",
                    "forward_host_ms.infer"],
                   ["forward_device_ms.infer", "cascade_device_ms.infer"]),
    "dtu-train": (["step_host_ms.train"],
                  ["forward_device_ms.train", "backward_device_ms.train",
                   "optimizer_device_ms.train"]),
}
NO_SPANS = """
import patchmatchnet_torch.utils.profiling as profiling
del profiling.span_summary
"""


@pytest.fixture(scope="module")
def copy_f32(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("pmnbench_spans")), precision="f32")


def test_span_metrics_are_in_the_manifest():
    listed = {m["name"]: m["workloads"] for m in MANIFEST["per_layer"]}
    for cell, (host, device) in SPAN_METRICS.items():
        for name in host + device:
            assert listed[name] == [cell]


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_run_reports_the_host_span_metrics(copy_f32, workload):
    line = tiny.result(tiny.run(copy_f32, workload, trace=1))
    assert line["correct"] is True
    host, device = SPAN_METRICS[workload]
    for name in host:
        assert line["metrics"][name]["value"] > 0, name
    assert not set(device) & set(line["metrics"])


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_a_program_without_spans_leaves_them_out(copy_f32, workload):
    line = tiny.result(tiny.run(copy_f32, workload, trace=1, plant=NO_SPANS))
    host, device = SPAN_METRICS[workload]
    assert not set(host + device) & set(line["metrics"])
    assert line["correct"] is True and line["metrics"]
