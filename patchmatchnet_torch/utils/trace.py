"""Device traces of repeated calls: the kernel, memcpy and memset events of a
`torch.profiler` trace, the time the device was busy, and a coarse kind for
each kernel name. `chip_smoke.py` and `tools/dev/profile_torch_main.py`
read their traces through these helpers."""

from __future__ import annotations

import json
from typing import Callable, Iterable, List, Tuple

# (category, kernel or copy name, start us, duration us)
DeviceEvent = Tuple[str, str, float, float]


def trace_device_events(fn: Callable[[], object], calls: int, path: str) -> List[DeviceEvent]:
    """Profile `calls` back-to-back calls of fn() on the CPU and CUDA
    activities, write the chrome trace to `path` and return its device
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
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
