"""Host ms per depth map of the stub's cell."""


def read(window):
    return window.window_s * 1e3 / window.count if window.count else None
