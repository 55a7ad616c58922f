"""Profiling: a torch.profiler trace of a code region, per-phase wall
timers (reference: `patchmatchnet_tpu/utils/profiling.py`, `jax_trace`
and `PhaseTimer`), and the program's spans.

`torch_trace(log_dir)` records the host and, where CUDA is available, the
device into `log_dir/trace.json` (Chrome trace format, viewable in
chrome://tracing or Perfetto). `PhaseTimer` keeps the reference's API;
given a CUDA device it synchronises the device at the end of a phase
(unless the phase is entered with `sync=False`), so that phase's time
includes the device work it launched.

Spans: `with span("pmn.request.copy_in") as s: ...; s.add(bytes=n)`
records a named interval of the program (host start and end in
`time.perf_counter_ns()`, its parent on this thread, the root span they
share, optional numbers), and once CUDA is initialised a pair of timing
events on the current stream, whose interval is the span's device time
(resolved only when read). Spans are on while a torch profiler records,
and then each also opens `torch.profiler.record_function(name)`, so it
shows in the trace on the profiler's clock beside the kernels it
launched; `trace_spans(True)` turns them on without a profiler.
Otherwise a span costs one check. Nothing is recorded while
`torch.compile` or `torch.export` traces. `span_summary()` totals the
records by name, `span_records()` lists them, `reset_spans()` clears
them; the log keeps the latest `MAX_SPANS` records and folds older ones
into the totals.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional, Tuple, Union

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
            with span(f"pmn.phase.{phase}"):
                try:
                    yield
                finally:
                    if sync and self.device is not None:
                        torch.cuda.synchronize(self.device)
        finally:
            self.last[phase] = time.perf_counter() - start
            self.total[phase] += self.last[phase]
            self.count[phase] += 1

    def mean(self, phase: str) -> float:
        return self.total.get(phase, 0.0) / max(self.count.get(phase, 0), 1)

    def summary(self) -> str:
        return "; ".join(f"{phase}: {self.total[phase]:.2f}s total, "
                         f"{self.mean(phase) * 1e3:.1f}ms avg over {self.count[phase]}"
                         for phase in sorted(self.total))


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

MAX_SPANS = 1 << 17  # records kept; older ones are folded into the totals
_profiling = torch._C._autograd._profiler_enabled
_forced = False
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_records: Deque["SpanRecord"] = deque()
_folded: Dict[str, "SpanTotals"] = {}


@dataclass
class SpanRecord:
    """One closed span. `parent` and `root` are span ids (`root` is the
    span's own id when it has no parent); times are host nanoseconds;
    `child_ns` is the time its direct children covered."""

    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int = 0
    end_ns: int = 0
    child_ns: int = 0
    numbers: Dict[str, float] = field(default_factory=dict)
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def self_ms(self) -> float:
        return (self.end_ns - self.start_ns - self.child_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """From the stream reaching the span's start to reaching its end
        (waits for the end); None without CUDA events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


@dataclass
class SpanTotals:
    """The records of one name: count, host ms, self host ms, device ms
    (None when none has device events) and the sums of their numbers."""

    count: int = 0
    host_ms: float = 0.0
    self_ms: float = 0.0
    device_ms: Optional[float] = None
    numbers: Dict[str, float] = field(default_factory=dict)

    def add(self, record: SpanRecord) -> None:
        self.count += 1
        self.host_ms += record.host_ms
        self.self_ms += record.self_ms
        device = record.device_ms
        if device is not None:
            self.device_ms = (self.device_ms or 0.0) + device
        for k, v in record.numbers.items():
            self.numbers[k] = self.numbers.get(k, 0.0) + v


class _Span:
    __slots__ = ("record", "annotation")

    def __init__(self, name: str, numbers: Dict[str, float]) -> None:
        self.record = SpanRecord(name, 0, None, 0, numbers=numbers)
        self.annotation = None

    def add(self, **numbers: float) -> None:
        """Add to the span's numbers (e.g. `bytes`)."""
        for k, v in numbers.items():
            self.record.numbers[k] = self.record.numbers.get(k, 0.0) + v

    def __enter__(self) -> "_Span":
        rec = self.record
        stack = _stack()
        rec.id = next(_ids)
        rec.parent = stack[-1].id if stack else None
        rec.root = stack[-1].root if stack else rec.id
        if _profiling():
            self.annotation = torch.profiler.record_function(rec.name)
            self.annotation.__enter__()
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        stack.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].child_ns += rec.end_ns - rec.start_ns
        if rec.events is not None:
            rec.events[1].record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        with _lock:
            _records.append(rec)
            if len(_records) > MAX_SPANS:
                old = _records.popleft()
                _folded.setdefault(old.name, SpanTotals()).add(old)
        return False


class _Off:
    """What `span` returns when spans are off."""

    __slots__ = ()

    def add(self, **numbers: float) -> None:
        pass

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _stack() -> List[SpanRecord]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **numbers: float) -> Union[_Span, _Off]:
    """A context manager recording the span `name` with `numbers` while
    spans are on (see the module's docstring); a no-op otherwise. The
    object it enters as has `add(**numbers)`."""
    if not (_forced or _profiling()) or torch.compiler.is_compiling():
        return _OFF
    return _Span(name, numbers)


def trace_spans(on: bool) -> bool:
    """Record spans without a profiler (`on`), or only while one records;
    returns the previous setting."""
    global _forced
    previous, _forced = _forced, bool(on)
    return previous


def span_records(name: Optional[str] = None) -> List[SpanRecord]:
    """The kept records (all, or those named `name`), in closing order."""
    with _lock:
        return [r for r in _records if name is None or r.name == name]


def span_summary() -> Dict[str, SpanTotals]:
    """Totals by span name since the last `reset_spans()`."""
    with _lock:
        records = list(_records)
        out = {k: SpanTotals(v.count, v.host_ms, v.self_ms, v.device_ms, dict(v.numbers))
               for k, v in _folded.items()}
    for r in records:
        out.setdefault(r.name, SpanTotals()).add(r)
    return out


def reset_spans() -> None:
    """Forget every record and total."""
    with _lock:
        _records.clear()
        _folded.clear()
