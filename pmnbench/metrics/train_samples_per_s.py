"""Samples trained per second over the window (it ends in a synchronize)."""


def read(window):
    return window.samples / window.window_s if window.window_s else None
