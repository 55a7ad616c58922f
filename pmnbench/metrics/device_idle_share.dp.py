"""Share (%) of the traced window in which no kernel or copy ran (mean over cards)."""
from pmnbench import readers


def read(window):
    return readers.idle_share(window)
