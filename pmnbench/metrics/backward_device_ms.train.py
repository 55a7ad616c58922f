"""Device ms a step of the backward (`pmn.step.backward`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.step", ["pmn.step.backward"], "device_ms")
