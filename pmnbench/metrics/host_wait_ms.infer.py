"""Host ms a map waiting for the device before the copy out (`pmn.request.wait`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.request", ["pmn.request.wait"])
