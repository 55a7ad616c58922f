"""Device ms a map of the forward: its span's stream interval (`pmn.request.forward`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.request", ["pmn.request.forward"], "device_ms")
