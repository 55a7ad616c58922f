"""Share (%) of the convolutions' bound in their traced device time."""
from pmnbench import readers


def read(window):
    return readers.roofline(window, ("convolutions",), ("convolutions",))
