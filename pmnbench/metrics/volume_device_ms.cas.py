"""Device ms a map of the three variance cost volumes (`pmn.cas.stage{1,2,3}.volume`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.request", [f"pmn.cas.stage{s}.volume" for s in (1, 2, 3)],
                          "device_ms")
