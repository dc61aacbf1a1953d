"""Prefix-doubling rounds of the rotation sort, per block: the program's
counter 'sort_rounds' (``ops.block_kernels``)."""

from benchmark.program_stages import count_per_block

COUNTERS = ('sort_rounds',)


def read(run):
    return count_per_block(run, COUNTERS)
