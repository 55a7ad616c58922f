"""What the span metrics of `metrics/` share: the program's own spans
(`patchmatchnet_torch.utils.profiling`), which it records while the traced
window's profiler runs, totalled by name and read per root span (a map's
`pmn.request`, a step's `pmn.step`).

A reader returns None when the program has no spans, when the run recorded
no root span, when a span has no device interval (no CUDA events: the
CPU), and for a reading of 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def summary() -> Dict[str, object]:
    """The program's span totals by name; {} for a program without spans."""
    try:
        from patchmatchnet_torch.utils import profiling
    except ImportError:
        return {}
    read = getattr(profiling, "span_summary", None)
    return read() if read is not None else {}


def per_root(root: str, names: Sequence[str], field: str = "host_ms") -> Optional[float]:
    """The sum over `names` of each span's `field` (host_ms, self_ms or
    device_ms), per `root` span."""
    spans = summary()
    if root not in spans or not spans[root].count:
        return None
    values = [getattr(spans[n], field) if n in spans else None for n in names]
    if any(v is None for v in values):
        return None
    value = sum(values) / spans[root].count
    return value if value > 0 else None


def rate_gb_per_s(name: str, number: str = "bytes") -> Optional[float]:
    """The span's `number` over its host time, in GB/s."""
    totals = summary().get(name)
    if totals is None or not totals.host_ms or not totals.numbers.get(number):
        return None
    return totals.numbers[number] / (totals.host_ms * 1e-3) / 1e9
