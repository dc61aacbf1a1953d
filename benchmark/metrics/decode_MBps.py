"""Decoded megabytes (10^6 B) of every file decoded in the window, over
the window's wall."""


def read(run):
    return run.window.mb_per_s
