"""The program's spans (`utils.profiling.span`) on the CPU: off by default,
on under a torch profiler or `trace_spans(True)`; the request, forward and
train-step spans with their parents and root; the Chrome trace's
annotations; self time; a span that raises; the export graph; PhaseTimer's
phases; the bounded log."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from patchmatchnet_torch.compat.export import export_inference, kernel_nodes, load_exported
from patchmatchnet_torch.data import plane_batch
from patchmatchnet_torch.infer import DepthEstimator
from patchmatchnet_torch.models import PatchmatchNet
from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step
from patchmatchnet_torch.utils import profiling
from patchmatchnet_torch.utils.profiling import (
    PhaseTimer,
    reset_spans,
    span,
    span_records,
    span_summary,
    trace_spans,
)

H, W, N = 32, 48, 3
REQUEST_CHILDREN = ["pmn.request.prepare", "pmn.request.copy_in", "pmn.request.forward",
                    "pmn.request.resize", "pmn.request.wait", "pmn.request.copy_out"]
FORWARD_CHILDREN = ["pmn.features", "pmn.stage3", "pmn.stage2", "pmn.stage1", "pmn.refine",
                    "pmn.confidence"]
STEP_CHILDREN = ["pmn.step.forward", "pmn.step.loss", "pmn.step.backward",
                 "pmn.step.optimizer", "pmn.step.metrics"]


@pytest.fixture(autouse=True)
def clean_log():
    previous = trace_spans(False)
    reset_spans()
    yield
    trace_spans(previous)
    reset_spans()


@pytest.fixture(scope="module")
def estimator():
    torch.manual_seed(0)
    return DepthEstimator(PatchmatchNet(), device="cpu")


@pytest.fixture(scope="module")
def batch():
    return {k: np.asarray(v) for k, v in plane_batch(1, N, H, W).items() if k != "noise"}


def children(records, parent):
    return [r for r in sorted(records, key=lambda r: r.start_ns) if r.parent == parent.id]


def test_spans_are_off_by_default(estimator, batch):
    estimator(batch, torch.Generator().manual_seed(0))
    assert span_records() == [] and span_summary() == {}


def test_request_spans_under_the_profiler(estimator, batch):
    estimator = DepthEstimator(estimator.model, device="cpu")  # its first request
    with profile(activities=[ProfilerActivity.CPU]):
        depth, confidence = estimator(batch, torch.Generator().manual_seed(0))
    records = span_records()
    (request,) = [r for r in records if r.name == "pmn.request"]
    assert request.parent is None and request.root == request.id
    assert {r.root for r in records} == {request.id}
    assert [r.name for r in children(records, request)] == REQUEST_CHILDREN
    (forward,) = [r for r in records if r.name == "pmn.request.forward"]
    assert [r.name for r in children(records, forward)] == FORWARD_CHILDREN
    copied = sum(np.asarray(batch[k], np.float32 if k == "images" else None).nbytes
                 for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max"))
    summary = span_summary()
    # an f32 model's images go as f32; nothing is pinned on the CPU; the
    # estimator's first request allocates its staging buffers
    assert summary["pmn.request.copy_in"].numbers == {"bytes": copied, "staged_bytes": 0,
                                                      "staging_allocs": 1}
    assert summary["pmn.request.copy_out"].numbers == {"bytes": depth.nbytes
                                                       + confidence.nbytes,
                                                       "staged_bytes": 0}
    assert all(s.device_ms is None for s in summary.values())  # no CUDA here
    covered = sum(r.host_ms for r in children(records, request))
    assert request.self_ms == pytest.approx(request.host_ms - covered, abs=1e-6)


def test_spans_are_annotations_in_the_chrome_trace(estimator, batch, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        estimator(batch, torch.Generator().manual_seed(0))
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    interval = {}
    for e in events:
        if e["name"].startswith("pmn."):
            assert e["name"] not in interval  # one request: each name once
            interval[e["name"]] = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
    records = span_records()
    assert set(interval) == {r.name for r in records}
    by_id = {r.id: r for r in records}
    for r in records:
        if r.parent is not None:
            (s, e), (ps, pe) = interval[r.name], interval[by_id[r.parent].name]
            assert ps <= s and e <= pe, (r.name, by_id[r.parent].name)


def test_span_summary_self_time():
    trace_spans(True)
    for _ in range(2):
        with span("outer"):
            time.sleep(0.002)
            with span("inner", bytes=10):
                time.sleep(0.003)
            with span("inner", bytes=5):
                with span("innermost"):
                    time.sleep(0.001)
    records = span_records()
    summary = span_summary()
    outer, inner = summary["outer"], summary["inner"]
    assert (outer.count, inner.count, summary["innermost"].count) == (2, 4, 2)
    assert outer.self_ms == pytest.approx(outer.host_ms - inner.host_ms, abs=1e-6)
    assert inner.self_ms == pytest.approx(inner.host_ms - summary["innermost"].host_ms,
                                          abs=1e-6)
    assert outer.self_ms >= 2 * 2.0 and inner.numbers == {"bytes": 30.0}
    assert outer.host_ms == pytest.approx(sum(r.host_ms for r in records
                                              if r.name == "outer"), abs=1e-9)
    # the two outer spans are two roots, each shared by its descendants
    roots = [r.id for r in records if r.name == "outer"]
    assert len(set(roots)) == 2
    assert {r.root for r in records} == set(roots)


def test_a_span_that_raises_closes_and_reraises():
    trace_spans(True)
    with pytest.raises(ValueError, match="inside"):
        with span("failing"):
            with span("child"):
                raise ValueError("inside")
    with span("after"):
        pass
    failing, child, after = (span_records(n)[0] for n in ("failing", "child", "after"))
    assert child.parent == failing.id and failing.end_ns >= child.end_ns > 0
    assert after.parent is None and after.root == after.id  # the stack was unwound


def test_train_step_spans_nest_the_model_under_forward():
    torch.manual_seed(0)
    model = PatchmatchNet()
    data = plane_batch(2, N, H, W)
    trace_spans(True)
    train_step(model, make_optimizer(model.parameters(), 1e-3),
               batch_to_device(data, torch.device("cpu")), 1e-3,
               torch.from_numpy(data["noise"]))
    records = span_records()
    (step,) = [r for r in records if r.name == "pmn.step"]
    assert step.parent is None and {r.root for r in records} == {step.id}
    assert [r.name for r in children(records, step)] == STEP_CHILDREN
    (forward,) = [r for r in records if r.name == "pmn.step.forward"]
    # training has no confidence: the forward returns zeros for it
    assert [r.name for r in children(records, forward)] == FORWARD_CHILDREN[:-1]
    assert sum(r.host_ms for r in children(records, step)) <= step.host_ms


def test_export_with_spans_on_is_unchanged():
    torch.manual_seed(0)
    state = PatchmatchNet().state_dict()
    off = load_exported(export_inference(state, 1, N, H, W, device="cpu")).program
    trace_spans(True)
    with profile(activities=[ProfilerActivity.CPU]):
        on = load_exported(export_inference(state, 1, N, H, W, device="cpu")).program
    assert span_records() == []  # nothing recorded while export traced
    assert kernel_nodes(on) == kernel_nodes(off) and kernel_nodes(on)
    assert not [n for n in on.graph.nodes if "profiler" in str(n.target)]
    assert len(on.graph.nodes) == len(off.graph.nodes)


def test_phase_timer_phases_are_spans():
    timer = PhaseTimer("cpu")
    with timer("data"):  # spans off: timed, not recorded
        pass
    assert span_records() == []
    trace_spans(True)
    with timer("data"):
        time.sleep(0.001)
    with timer("step"):
        with span("pmn.step"):
            time.sleep(0.001)
    data, step = span_records("pmn.phase.data")[0], span_records("pmn.phase.step")[0]
    (inner,) = span_records("pmn.step")
    assert inner.parent == step.id and data.parent is None
    assert timer.count == {"data": 2, "step": 1}
    assert step.host_ms <= timer.last["step"] * 1e3


def test_the_log_is_bounded_and_the_totals_whole(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 8)
    trace_spans(True)
    for i in range(20):
        with span("unit", bytes=i):
            pass
    assert len(span_records()) == 8
    assert [r.numbers["bytes"] for r in span_records()] == list(range(12, 20))
    total = span_summary()["unit"]
    assert total.count == 20 and total.numbers == {"bytes": float(sum(range(20)))}
    reset_spans()
    assert span_summary() == {}


def test_trace_spans_returns_the_previous_setting():
    assert trace_spans(True) is False
    assert profiling.span("x") is not profiling._OFF
    assert trace_spans(False) is True
    assert profiling.span("x") is profiling._OFF
