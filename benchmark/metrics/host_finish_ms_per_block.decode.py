"""Host ms, per block, of the bzip2 decode's finish: the block and stream
CRCs and the join of the blocks' bytes, the program's stages
'decode.crc' and 'decode.join' (``parallel.decode``)."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('decode.crc', 'decode.join')


def read(run):
    return stage_ms_per_block(run, STAGES)
