"""A traced window: `torch.profiler` over a fixed amount of work, reduced
to what the per-layer metrics read.

The profiler runs one unit of work as its warm-up step (its events are
dropped: the tracer loses the first device events after it starts) and
then the window's units inside a `pmnbench_window` annotation that ends in
a synchronize. The window is that annotation's span on the host clock; the
device was busy in the union of the kernel, copy and set events inside it.
Each device event gets its group from `kernel_groups/*.json`. The device's
idle gaps are named by what the host was doing when each began: the
innermost host event (operator, runtime call or annotation) open then.
"""

from __future__ import annotations

import bisect
import collections
import glob
import json
import os
import re
import tempfile
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
WINDOW = "pmnbench_window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
                   "python_function")


def kernel_groups() -> List[Tuple[re.Pattern, str]]:
    """(pattern, group) of every file of `kernel_groups/`, in file-name
    order."""
    rules = []
    for path in sorted(glob.glob(os.path.join(HERE, "kernel_groups", "*.json"))):
        with open(path) as f:
            for entry in json.load(f)["groups"]:
                rules.append((re.compile(entry["match"], re.IGNORECASE), entry["group"]))
    return rules


def group_of(name: str, rules: List[Tuple[re.Pattern, str]]) -> str:
    for pattern, group in rules:
        if pattern.search(name):
            return group
    return "glue"


def short_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_:.\-]", "_", name)[:64]


@dataclass
class TraceSummary:
    """One rank's traced window."""

    units: int  # maps or steps inside the window
    window_s: float
    busy_s: float
    launches: int  # kernel events
    group_s: Dict[str, float]  # device seconds by group
    copy_s: Dict[str, float]  # device seconds of copies and sets by kind
    device_ops: List[Tuple[str, float]]  # the kernels and copies that took most time
    idle_gaps: List[Tuple[str, float]]  # idle device time by what the host did


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(trace_events: List[dict], units: int) -> TraceSummary:
    """Reduce a chrome trace's events to the window's `TraceSummary`."""
    windows = [e for e in trace_events if e.get("ph") == "X" and e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("the trace has no pmnbench_window annotation")
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    device, host = [], []
    for e in trace_events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e["dur"])
        if cat in DEVICE_CATEGORIES:
            s, t = max(ts, w0), min(ts + dur, w1)
            if t > s:
                device.append((cat, e["name"], s, t - s))
        elif cat in HOST_CATEGORIES and e["name"] != WINDOW and ts < w1 and ts + dur > w0:
            host.append((ts, ts + dur, e["name"]))
    rules = kernel_groups()
    group_us: Dict[str, float] = collections.defaultdict(float)
    copy_us: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    launches = 0
    for cat, name, _, dur in device:
        group_us[group_of(name, rules)] += dur
        by_name[short_name(name)] += dur
        if cat == "kernel":
            launches += 1
        else:
            copy_us[short_name(name)] += dur
    busy = _union([(s, s + d) for _, _, s, d in device])
    busy_us = sum(e - s for s, e in busy)
    # idle gaps, named by the innermost host event open when each began
    host.sort()
    starts = [h[0] for h in host]
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        at = gs + 1e-3
        name = "no_host_event"
        i = bisect.bisect_right(starts, at) - 1
        for j in range(i, max(i - 4000, -1), -1):
            if host[j][1] >= at:
                name = short_name(host[j][2])
                break
        gaps[name] += ge - gs
    top = lambda d: sorted(((k, v / 1e6) for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        units=units, window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, launches=launches,
        group_s={k: v / 1e6 for k, v in group_us.items()},
        copy_s={k: v / 1e6 for k, v in copy_us.items()},
        device_ops=top(by_name), idle_gaps=top(gaps))


def traced(unit: Callable[[], object], units: int, sync: Callable[[], None]) -> TraceSummary:
    """Trace `units` calls of unit() after one untraced warm-up call, with
    sync() (a device synchronize, and for ranks a barrier) before the
    window and at its end."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with tempfile.TemporaryDirectory(prefix="pmnbench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            unit()
            sync()
            prof.step()
            with record_function(WINDOW):
                for _ in range(units):
                    unit()
                sync()
            prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return summarize(events, units)


def merge_ranks(summaries: List[TraceSummary]) -> Optional[TraceSummary]:
    """The ranks' traced windows as one: times averaged over the ranks,
    launches and units per rank (rank 0's)."""
    if not summaries:
        return None
    n = len(summaries)

    def mean_dict(dicts: List[Dict[str, float]]) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for d in dicts:
            for k, v in d.items():
                out[k] += v / n
        return dict(out)

    def mean_top(lists: List[List[Tuple[str, float]]]) -> List[Tuple[str, float]]:
        return sorted(mean_dict([dict(x) for x in lists]).items(), key=lambda kv: -kv[1])[:10]

    first = summaries[0]
    return TraceSummary(
        units=first.units, window_s=sum(s.window_s for s in summaries) / n,
        busy_s=sum(s.busy_s for s in summaries) / n, launches=first.launches,
        group_s=mean_dict([s.group_s for s in summaries]),
        copy_s=mean_dict([s.copy_s for s in summaries]),
        device_ops=mean_top([s.device_ops for s in summaries]),
        idle_gaps=mean_top([s.idle_gaps for s in summaries]))
