"""The allocator's peak over the window on the fullest card, in GiB."""


def read(window):
    return window.peak_bytes / 2 ** 30 if window.peak_bytes else None
