"""95th percentile (nearest rank) of the times of all files completed in
the window, each from its call to its output on the host."""


def read(run):
    return run.window.p95_ms
