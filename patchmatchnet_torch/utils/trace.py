"""Device traces of repeated calls: the kernel, memcpy and memset events of a
`torch.profiler` trace, the time the device was busy, the device time of
one call (in all, and by the groups `dev.roofline` bounds) and its printed
form, and a coarse kind for each kernel name.
`chip_smoke.py`, `tools/dev/profile_torch_main.py` and `dev/bench_gather.py`
read their traces through these helpers; `hand_kernel_id` names the hand
kernel (K1-K7, D) a device kernel name belongs to."""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Tuple

# (category, kernel or copy name, start us, duration us)
DeviceEvent = Tuple[str, str, float, float]
CALLS = 10  # calls in each trace of `device_ms`
TRIES = 5  # traces `device_ms` takes before it gives up


def trace_device_events(fn: Callable[[], object], calls: int, path: str) -> List[DeviceEvent]:
    """Profile `calls` back-to-back calls of fn() on the CPU and CUDA
    activities, write the chrome trace to `path` and return its device
    events. One more call runs first, as the profiler's warm-up step: the
    first device events after the tracer starts are the ones it loses, and
    the warm-up step's events are not kept."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return [(e["cat"], e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_union_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def whole_trace(fn: Callable[[], object], calls: int) -> Optional[List[DeviceEvent]]:
    """The device events of a torch.profiler trace of `calls` calls of
    fn(). The profiler at times drops device events, so a trace counts
    only if every kernel, copy and set in it occurs a whole multiple of
    `calls` times; after TRIES traces without one, None."""
    for _ in range(TRIES):
        with tempfile.TemporaryDirectory() as tmp:
            events = trace_device_events(fn, calls, os.path.join(tmp, "trace.json"))
        counts = collections.Counter(name for _, name, _, _ in events)
        if counts and all(n % calls == 0 for n in counts.values()):
            return events
        odd = {name[:80]: n for name, n in counts.items() if n % calls}
        warnings.warn(f"whole_trace: trace of {calls} calls dropped ({len(events)} device "
                      f"events; counts not a multiple of {calls}: {odd})")
    return None


def device_ms(fn: Callable[[], object]) -> Optional[float]:
    """Device time of one call of fn() on the card: the time the device was
    busy in a whole trace (`whole_trace`) of CALLS calls, over CALLS; None
    when no trace was whole. Unlike a CUDA-event time it leaves out the time
    the card waits for the host."""
    events = whole_trace(fn, CALLS)
    if events is None:
        return None
    return busy_union_us((s, s + d) for _, _, s, d in events) / CALLS / 1e3


def device_ms_by_group(fn: Callable[[], object], calls: Optional[int] = None
                       ) -> Optional[Tuple[float, Dict[str, float]]]:
    """(device-busy ms, {`trace_group`: device ms}) per call of fn() in a
    whole trace of `calls` calls (CALLS by default); None when no trace
    was whole."""
    calls = calls or CALLS
    events = whole_trace(fn, calls)
    if events is None:
        return None
    groups: Dict[str, float] = collections.defaultdict(float)
    for _, name, _, dur in events:
        groups[trace_group(name)] += dur / calls / 1e3
    return busy_union_us((s, s + d) for _, _, s, d in events) / calls / 1e3, dict(groups)


def fmt_ms(ms: Optional[float]) -> str:
    """A time in ms as printed beside `device_ms`'s: None is "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def kernel_kind(name: str) -> str:
    """Coarse kind of a device kernel, by its name."""
    low = name.lower()
    if "pmn::" in name:
        return "hand kernels (K1-K7)"
    if any(k in low for k in ("conv", "cudnn", "xmma", "cutlass", "wgrad", "dgrad", "nvjet",
                              "gemm")):
        return "convolutions and channel-map GEMMs"
    if "grid_sampler" in low:
        return "grid_sample"
    if "reduce" in low:
        return "reductions"
    if "elementwise" in low:
        return "element-wise"
    return "other"


# Hand kernels by their device function (csrc/) and, for the tiled kernel,
# its `Samples` mode, the fourth template argument: 0 K1, 1 K6, 2 K3, 3 K7.
_HAND_KERNELS = {
    "eval_grid_score_kernel": "K2",
    "warp_corr_bwd_merge_kernel": "K4",
    "neighbor_corr_bwd_tile_kernel": "K5",
    "gather_lanes_kernel": "D1-D3",
    "gather_sublanes_kernel": "D4",
    "gather_rows_kernel": "D5",
}
_TILE_MODES = {"0": "K1", "1": "K6", "2": "K3", "3": "K7"}


def trace_group(name: str) -> str:
    """The group of a device event that `dev.roofline` bounds: the hand
    kernel's id (K1-K7, D1-D5), "convolutions" (`kernel_kind`'s
    convolutions and channel-map GEMMs) or "glue" (every other kernel,
    copy and set)."""
    kernel = hand_kernel_id(name)
    if kernel is not None:
        return kernel
    return "convolutions" if kernel_kind(name).startswith("convolutions") else "glue"


def hand_kernel_id(name: str) -> Optional[str]:
    """The id (K1-K7, D1-D5) of the hand kernel a device kernel name
    belongs to, None for any other kernel."""
    found = re.search(r"pmn::(\w+)<", name)
    if found is None:
        return None
    if found.group(1) == "group_corr_tile_kernel":
        mode = re.search(r"\(pmn::Samples\)(\d)", name)
        return _TILE_MODES.get(mode.group(1)) if mode else None
    return _HAND_KERNELS.get(found.group(1))
