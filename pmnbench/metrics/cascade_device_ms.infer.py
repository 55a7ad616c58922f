"""Device ms a map of the three PatchMatch stages (`pmn.stage3`, `pmn.stage2`, `pmn.stage1`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.request", ["pmn.stage3", "pmn.stage2", "pmn.stage1"], "device_ms")
