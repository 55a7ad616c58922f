"""Host ms per depth map: the window over the maps completed in it."""


def read(window):
    return window.window_s * 1e3 / window.count if window.count else None
