"""`utils.profiling` on the CPU: `PhaseTimer` (the JAX package's API) and
`torch_trace`."""

import json
import os
import time

import pytest
import torch

from patchmatchnet_torch.utils.profiling import PhaseTimer, torch_trace


def test_phase_timer_accumulates_per_phase():
    timer = PhaseTimer("cpu")
    assert timer.device is None  # nothing to synchronise on the CPU
    for _ in range(3):
        with timer("data"):
            time.sleep(0.002)
    with timer("step"):
        time.sleep(0.004)
    assert timer.count == {"data": 3, "step": 1}
    assert timer.mean("data") >= 0.002 and timer.total["step"] >= 0.004
    assert timer.mean("missing") == 0.0
    summary = timer.summary()
    assert summary.startswith("data: ") and "avg over 3" in summary and "step: " in summary


def test_phase_timer_keeps_each_phase_last_time():
    timer = PhaseTimer("cpu")
    with timer("step"):
        time.sleep(0.004)
    with timer("step", sync=False):  # no device wait asked; the CPU has none anyway
        time.sleep(0.001)
    assert timer.count["step"] == 2
    assert 0.001 <= timer.last["step"] < timer.total["step"] - 0.004 + 1e-9


def test_phase_timer_counts_a_phase_that_raises():
    timer = PhaseTimer()
    with pytest.raises(ValueError):
        with timer("step"):
            raise ValueError("step failed")
    assert timer.count["step"] == 1


def test_phase_timer_keeps_a_cuda_device():
    # a CUDA device is only recorded here; the synchronisation needs a card
    assert PhaseTimer(torch.device("cuda", 0)).device == torch.device("cuda", 0)


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with torch_trace(None):  # no-op
        torch.ones(4).sum()
    with torch_trace(str(tmp_path / "trace")):
        torch.randn(64, 64).matmul(torch.randn(64, 64))
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
