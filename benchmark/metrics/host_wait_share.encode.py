"""Share of the traced slice's wall that the encoder's calling thread
spent waiting for its worker's device stage: the program's own
StageTimer total 'device wait+fetch' (``parallel.pipeline``)."""

STAGE = 'device wait+fetch'


def read(run):
    t = run.slice.stage_totals.get(STAGE)
    return None if not t else 100.0 * t / run.slice.window_s
