"""Share of the bzip2 encode's blocks that were queued on the worker
while the block before them still ran there, so that their RLE1 pass,
CRC and meta hid behind the worker's device stage: 100 x the program's
counter 'encode_submits_busy' over 'encode_submits'
(``parallel.pipeline.DeviceBzip2Encoder.compress``)."""

from benchmark.program_stages import counters


def read(run):
    c = counters()
    submits = c.get('encode_submits', 0) if c else 0
    return (100.0 * c.get('encode_submits_busy', 0) / submits if submits
            else None)
