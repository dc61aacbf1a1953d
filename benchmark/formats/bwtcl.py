"""BWTC-L (compressjs's BWTC in the JAX package's 128-lane layout) on the
port's card decode.

decode: ``bwtcl_decompress_device(stream)``.  Set-up makes each stream
with the port's host codec, ``BWTCL.compress_file(data, None, L)``.  That
codec is held, in set-up, to a golden stream the JAX package's codec made
of a fixed piece of the corpus (``golden_differs``), so the input is a
function of the data and the format, not of code a later change may
alter.  Each output is held to the file's original bytes after the
window.  There is no encode here: a plain reference of BWTC-L's bytes is
not written yet.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark import traffic as tr
from benchmark.formats import same_bytes

BLOCK_SPAN = {'decode': 'compressjs_tpu_torch.ops.device_lane.'
                        'decode_block_lanes'}

LIMITS = {'decode': {'golden_differs': 0, 'files_differing': 0}}


def _compress(data, level):
    from compressjs_tpu_torch import BWTCL
    return BWTCL.compress_file(np.frombuffer(data, dtype=np.uint8), None,
                               level)


def prepare(config, op, files):
    if op != 'decode':
        raise ValueError('bwtcl: only decode has a reference')
    return [_compress(f['data'], config['level']) for f in files]


def check_setup(config, op, corpus):
    """The port's host codec against the JAX codec's golden stream."""
    g = config['golden']
    with open(os.path.join(tr.ROOT, g['file']), 'rb') as f:
        golden = f.read()
    made = _compress(corpus[:g['piece_bytes']], g['level'])
    return {'golden_differs': int(not same_bytes(made, golden))}


def entry(config, op, device):
    import compressjs_tpu_torch as cz
    return lambda x: cz.bwtcl_decompress_device(x, device=device)


def judge(config, op, file, out):
    return {'golden_differs': 0,
            'files_differing': int(not same_bytes(out, file['data']))}
