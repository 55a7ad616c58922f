"""Host ms a step in `train_step` (`pmn.step`), traced window."""
from pmnbench import spans


def read(window):
    return spans.per_root("pmn.step", ["pmn.step"])
