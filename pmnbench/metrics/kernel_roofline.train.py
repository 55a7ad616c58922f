"""Share (%) of the hand kernels' (K1-K6) bound in their traced device time."""
from pmnbench import readers


def read(window):
    return readers.roofline(window, readers.HAND_KERNELS, readers.HAND_KERNELS)
