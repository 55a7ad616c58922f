"""Share (%) of the chip's peak: the whole forward's or step's bound times
the maps or steps of the window (per card), over the window's time."""
from pmnbench import readers


def read(window):
    return readers.mfu(window)
