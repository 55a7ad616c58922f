"""What the metric files of `metrics/` share: reading a `harness.Window`.

A reader returns None when the run has nothing for it to read (no traced
window, too few requests, no device time in a group); never 0 for a share
of a roofline or of a peak.
"""

from __future__ import annotations

import math
from typing import Optional

HAND_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")


def tail_ms(window, share: float, beyond: int = 10) -> Optional[float]:
    """The `share` percentile of the window's request times (nearest
    rank), when at least `beyond` requests lie beyond it."""
    times = sorted(window.request_s)
    if len(times) * (1 - share) < beyond:
        return None
    return times[math.ceil(share * len(times)) - 1] * 1e3


def per_unit(window, seconds: Optional[float]) -> Optional[float]:
    """Traced seconds as ms a map or step."""
    t = window.trace
    if t is None or seconds is None or not t.units:
        return None
    return seconds * 1e3 / t.units


def launches(window) -> Optional[float]:
    t = window.trace
    if t is None or not t.units or not t.launches:
        return None
    return t.launches / t.units


def group_s(window, groups) -> Optional[float]:
    t = window.trace
    if t is None:
        return None
    total = sum(t.group_s.get(g, 0.0) for g in groups)
    return total or None


def roofline(window, bound_groups, trace_groups) -> Optional[float]:
    """100 x the bound of `bound_groups` for the traced units over the
    device time of `trace_groups`."""
    device = group_s(window, trace_groups)
    if device is None:
        return None
    bound_ms = sum(window.bound["groups"].get(g, 0.0) for g in bound_groups)
    if not bound_ms:
        return None
    return 100.0 * bound_ms * window.trace.units / (device * 1e3)


def mfu(window) -> Optional[float]:
    """100 x the whole bound of the window's maps or steps (per card) over
    the window's time."""
    if not window.count or not window.window_s or not window.bound:
        return None
    return 100.0 * window.bound["bound_ms"] * window.count / (window.window_s * 1e3)


def idle_share(window) -> Optional[float]:
    t = window.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
