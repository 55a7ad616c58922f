"""GB/s of the request's copy in: its bytes over its host time (`pmn.request.copy_in`)."""
from pmnbench import spans


def read(window):
    return spans.rate_gb_per_s("pmn.request.copy_in")
