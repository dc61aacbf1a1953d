"""Host ms, per block on the card, of the BWTC-L encode's block head: the
used bytes and symbol remap (``block_meta``), the block's and the remap's
uploads: the program's stage 'bwtcl_enc.head'
(``parallel.pipeline.bwtcl_compress_device``)."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('bwtcl_enc.head',)


def read(run):
    return stage_ms_per_block(run, STAGES)
