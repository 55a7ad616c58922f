"""Host ms a map in the request's copy in (`pmn.request.copy_in`), traced window."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.request", ["pmn.request.copy_in"])
