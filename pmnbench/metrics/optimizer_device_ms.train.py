"""Device ms a step of Adam's update (`pmn.step.optimizer`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.step", ["pmn.step.optimizer"], "device_ms")
