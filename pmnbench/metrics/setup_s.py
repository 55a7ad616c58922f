"""Seconds from the process's start to the window's."""


def read(window):
    return window.setup_s
