"""Host ms, per block on the card, of the blocks the BWTC-L decode routes
to the host decoder (the short tail, a block past the lane cap): the
program's stage 'bwtcl.host_block'
(``parallel.pipeline.bwtcl_decompress_device``)."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('bwtcl.host_block',)


def read(run):
    return stage_ms_per_block(run, STAGES)
