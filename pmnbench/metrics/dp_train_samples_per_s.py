"""Samples of all ranks trained per second over the window between barriers."""


def read(window):
    return window.samples / window.window_s if window.window_s else None
