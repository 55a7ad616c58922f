"""Share (%) of the peak: the stub's bound times the window's units over
its time."""
from pmnbench import readers


def read(window):
    return readers.mfu(window)
