"""Samples trained per second in the stub's cell."""


def read(window):
    return window.samples / window.window_s if window.window_s else None
