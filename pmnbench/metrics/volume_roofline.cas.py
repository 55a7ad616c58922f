"""Share (%) of K8's bound (the variance cost volumes) in its traced device time."""
from pmnbench import readers


def read(window):
    return readers.roofline(window, ("K8",), ("K8",))
