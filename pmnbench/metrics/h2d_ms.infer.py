"""Host-to-device copy ms a map, from the traced window's copy events."""
from pmnbench import readers


def read(window):
    t = window.trace
    if t is None:
        return None
    return readers.per_unit(window, sum(v for k, v in t.copy_s.items() if "HtoD" in k) or None)
