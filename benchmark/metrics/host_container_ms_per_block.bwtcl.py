"""Host ms, per block, of the BWTC-L decode's host side before each
launch: the container, the block headers, and the lane payloads and
symbol map staged and uploaded, the program's stages 'bwtcl.container',
'bwtcl.header' and 'bwtcl.stage'
(``parallel.pipeline.bwtcl_decompress_device``)."""

from benchmark.program_stages import stage_ms_per_block

STAGES = ('bwtcl.container', 'bwtcl.header', 'bwtcl.stage')


def read(run):
    return stage_ms_per_block(run, STAGES)
