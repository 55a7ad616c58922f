"""Share (%) of the convolutions' bound (FeatureNet's 2D and the
CostRegNets' 3D) in their traced device time."""
from pmnbench import readers


def read(window):
    return readers.roofline(window, ("convolutions",), ("convolutions",))
