"""Host ms a map launching the forward (`pmn.request.forward`)."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.request", ["pmn.request.forward"])
