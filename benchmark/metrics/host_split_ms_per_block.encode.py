"""Host ms, per block, of the encode's whole-file RLE1 pass and block
CRCs before any block reaches the worker: the program's stage
'encode.split' (``parallel.pipeline.DeviceBzip2Encoder.compress``)."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('encode.split',)


def read(run):
    return stage_ms_per_block(run, STAGES)
