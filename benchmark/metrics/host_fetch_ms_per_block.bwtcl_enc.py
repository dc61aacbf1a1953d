"""Host ms, per block on the card, of the BWTC-L encode's read-backs: the
symbol count, the stream's length, the largest token count, the lanes'
lengths, and on the card's route pidx and the block's bytes, with its
header written: the program's stage 'bwtcl_enc.fetch'
(``parallel.pipeline.bwtcl_compress_device``), where the host waits on
the card, block by block."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('bwtcl_enc.fetch',)


def read(run):
    return stage_ms_per_block(run, STAGES)
