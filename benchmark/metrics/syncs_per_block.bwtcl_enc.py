"""Points a block where the host waits on the card: the program's counter
'host_syncs' (``convert``, ``parallel`` and ``ops``), which counts each
read-back of a device value, each upload from pageable memory, each host
scalar written to the card and each ``bincount`` (which reads back its
input's extent): every synchronising operation that torch's sync debug
mode reports on the path."""

from benchmark.program_stages import count_per_block

COUNTERS = ('host_syncs',)


def read(run):
    return count_per_block(run, COUNTERS)
