"""Share of the BWTC-P encode's coder jobs (one a dispatch: the fused
Fenwick model and range coder and its read-backs, on the encoder's worker
thread) that had ended when the calling thread came to collect them:
100 x (1 - the program's counter 'coder_waits' over 'coder_dispatches')
(``parallel.pipeline.bwtcp_compress_device``)."""

from benchmark.program_stages import counters


def read(run):
    c = counters()
    dispatched = c.get('coder_dispatches', 0) if c else 0
    return (100.0 * (1 - c.get('coder_waits', 0) / dispatched) if dispatched
            else None)
