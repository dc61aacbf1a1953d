"""Share of the traced slice's wall in which no operation ran on the
card: 100 x (1 - union of the device operations' intervals / wall)."""


def read(run):
    s = run.slice
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.busy_s else None
