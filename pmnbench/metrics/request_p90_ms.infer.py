"""The 90th percentile of the window's request times (needs 100 maps)."""
from pmnbench import readers


def read(window):
    return readers.tail_ms(window, 0.90)
