"""Device ms a step of the training forward (`pmn.step.forward`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.step", ["pmn.step.forward"], "device_ms")
