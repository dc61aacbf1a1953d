"""Host ms, per block, of the encode's bit writes of each block and the
stream's join: the program's stage 'encode.write'
(``parallel.pipeline.DeviceBzip2Encoder._assemble``)."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('encode.write',)


def read(run):
    return stage_ms_per_block(run, STAGES)
