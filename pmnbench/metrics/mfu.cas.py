"""Share (%) of the chip's peak: CasMVSNet's whole-forward bound times the
maps of the window, over the window's time."""
from pmnbench import readers


def read(window):
    return readers.mfu(window)
