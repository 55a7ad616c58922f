"""Profiling: a torch.profiler trace of a code region, and per-phase wall
timers (reference: `patchmatchnet_tpu/utils/profiling.py`, `jax_trace`
and `PhaseTimer`).

`torch_trace(log_dir)` records the host and, where CUDA is available, the
device into `log_dir/trace.json` (Chrome trace format, viewable in
chrome://tracing or Perfetto). `PhaseTimer` keeps the reference's API;
given a CUDA device it synchronises the device at the end of a phase
(unless the phase is entered with `sync=False`), so that phase's time
includes the device work it launched.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Union

import torch


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Trace the region into `log_dir/trace.json` (no-op when log_dir is
    falsy)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class PhaseTimer:
    """Accumulates wall time per named phase.

    Usage::

        timer = PhaseTimer(device)
        with timer("data"):
            batch = next(it)
        with timer("step"):
            metrics = train_step(model, optimizer, batch, lr, noise)
        print(timer.summary())

    With a CUDA `device`, a phase ends with a synchronisation of that
    device unless it is entered with `sync=False`; otherwise it times the
    host alone. `last[phase]` holds the seconds of the phase's latest run.
    """

    def __init__(self, device: Union[str, torch.device, None] = None) -> None:
        device = torch.device(device) if device is not None else None
        self.device = device if device is not None and device.type == "cuda" else None
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.last: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str, sync: bool = True) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.device is not None:
                torch.cuda.synchronize(self.device)
            self.last[phase] = time.perf_counter() - start
            self.total[phase] += self.last[phase]
            self.count[phase] += 1

    def mean(self, phase: str) -> float:
        return self.total.get(phase, 0.0) / max(self.count.get(phase, 0), 1)

    def summary(self) -> str:
        return "; ".join(f"{phase}: {self.total[phase]:.2f}s total, "
                         f"{self.mean(phase) * 1e3:.1f}ms avg over {self.count[phase]}"
                         for phase in sorted(self.total))

    def as_dict(self) -> Dict[str, float]:
        return {f"time-{k}-mean-ms": self.mean(k) * 1e3 for k in self.total}
