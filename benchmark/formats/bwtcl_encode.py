"""BWTC-L (compressjs's BWTC in the JAX package's 128-lane layout) on the
port's card encode.

encode: ``bwtcl_compress_device(data, level=L)``, its lanes at the port's
default (``host.bwtcl.LANES``, 128).  In set-up the same entry encodes a
fixed piece of the corpus, and the stream is held to the golden stream the
JAX package's codec made of it (`golden_differs`).  After the window the
plain decoder ``reference/bwtc.py`` (``decode_bwtcl``) decodes each
distinct stream of the pool whole, its blocks in worker processes
(`format_errors`, `files_differing`).  Every call of the entry, the
warm-up's included, adds the full blocks that its ``last_stats`` does not
count as coded on the card (`offcard_blocks`): a full block moved to the
host codec is another path, not a faster one.

The decode of the same configuration's streams is ``formats/bwtcl.py``:
a configuration has one format, so the encode has its own.
"""

from __future__ import annotations

import os

from benchmark import traffic as tr
from benchmark.formats import as_u8, same_bytes
from benchmark.reference import bwtc as ref

BLOCK_SPAN = {'encode': 'compressjs_tpu_torch.ops.device_lane.'
                        'encode_block_lanes'}

LIMITS = {'encode': {'format_errors': 0, 'files_differing': 0,
                     'golden_differs': 0, 'offcard_blocks': 0}}

# the plain decoder's worker processes, after the window
JUDGE_WORKERS = min(8, os.cpu_count() or 1)

# full blocks the entry's calls left off the card, until a judge reads them
_offcard = [0]


def _encoder(config, device):
    """The entry on `device`: input -> stream, counting its full blocks
    that did not take the card."""
    import compressjs_tpu_torch as cz
    from compressjs_tpu_torch.parallel import pipeline
    level = config['level']
    bs = level * 100000

    def call(x):
        out = cz.bwtcl_compress_device(x, level=level, device=device)
        stats = pipeline.bwtcl_compress_device.last_stats
        _offcard[0] += len(x) // bs - stats.get('device_blocks', 0)
        return out
    return call


def prepare(config, op, files):
    if op != 'encode':
        raise ValueError('bwtcl_encode: only encode is built')
    return [f['data'] for f in files]


def check_setup(config, op, corpus):
    """The card's encode of the golden piece against the JAX codec's
    stream (the CPU's where the harness runs without a card)."""
    import torch
    g = config['golden']
    with open(os.path.join(tr.ROOT, g['file']), 'rb') as f:
        golden = f.read()
    device = 'cuda' if torch.cuda.is_available() else 'cpu'
    made = _encoder(dict(config, level=g['level']), device)(
        corpus[:g['piece_bytes']])
    _offcard[0] = 0
    return {'golden_differs': int(not same_bytes(made, golden))}


def entry(config, op, device):
    return _encoder(config, device)


def judge(config, op, file, out):
    """The numbers of one distinct output; the first judge also takes the
    off-card blocks of every call."""
    offcard, _offcard[0] = _offcard[0], 0
    try:
        d = ref.decode_bwtcl(as_u8(out).tobytes(), workers=JUDGE_WORKERS)
    except ref.FormatError:
        return {'format_errors': 1, 'files_differing': 1,
                'golden_differs': 0, 'offcard_blocks': offcard}
    return {'format_errors': int(d.level != config['level']),
            'files_differing': int(d.data != file['data']),
            'golden_differs': 0, 'offcard_blocks': offcard}
