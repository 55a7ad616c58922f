"""Kernel launches a map or step (per card), from the traced window."""
from pmnbench import readers


def read(window):
    return readers.launches(window)
