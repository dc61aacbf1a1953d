"""Host ms, per block, of the bzip2 decode's scan of the whole stream for
block and end magics at every bit alignment: the program's stage
'decode.scan' (``parallel.decode.decompress_file_device``)."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('decode.scan',)


def read(run):
    return stage_ms_per_block(run, STAGES)
