"""Device ms a map of the three CostRegNets (`pmn.cas.stage{1,2,3}.regularize`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.request", [f"pmn.cas.stage{s}.regularize" for s in (1, 2, 3)],
                          "device_ms")
