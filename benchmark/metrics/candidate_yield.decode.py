"""Share of the bzip2 decode's candidate blocks launched on the card
(retries to a wider bound included) whose read-back passes its checks:
100 x the program's counters 'candidates_accepted' over
'candidates_launched' (``parallel.decode._decode_window``)."""

from benchmark.program_stages import counters


def read(run):
    c = counters()
    launched = c.get('candidates_launched', 0) if c else 0
    return (100.0 * c.get('candidates_accepted', 0) / launched if launched
            else None)
