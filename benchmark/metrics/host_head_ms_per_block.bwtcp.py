"""Host ms, per block on the card, of the BWTC-P encode's block head: the
used bytes and symbol remap, the remap's upload, the pidx read back, the
header coded on the block's fresh range coder and its state exported:
the program's stage 'bwtcp.head'
(``parallel.pipeline._bwtcp_group``)."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('bwtcp.head',)


def read(run):
    return stage_ms_per_block(run, STAGES)
