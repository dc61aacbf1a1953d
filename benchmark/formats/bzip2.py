"""The bzip2 format on the port's card entries.

encode: ``compress_file_device(data, level=L)``; after the window the
plain decoder ``reference/bzip2.py`` decodes each distinct stream of the
pool whole, its blocks in worker processes.
decode: ``decompress_file_device(stream)`` of streams that stdlib ``bz2``
made in set-up, the bytes a C bzip2 user holds; after the window every
output is held to the file's original bytes.
"""

from __future__ import annotations

import bz2
import os
from concurrent.futures import ThreadPoolExecutor

from benchmark.formats import same_bytes
from benchmark.reference import bzip2 as ref

# a function called once a block: its calls count the blocks of a traced
# slice
BLOCK_SPAN = {
    'encode': 'compressjs_tpu_torch.ops.block_kernels.bwt_block',
    'decode': 'compressjs_tpu_torch.parallel.decode._walk_inputs',
}

# every number compared is exact: an output is right or it is not
LIMITS = {
    'encode': {'format_errors': 0, 'files_differing': 0,
               'crc_mismatches': 0},
    'decode': {'files_differing': 0},
}

# the plain decoder's worker processes, after the window
JUDGE_WORKERS = min(8, os.cpu_count() or 1)


def prepare(config, op, files):
    """The entry's input for each pool file."""
    if op == 'encode':
        return [f['data'] for f in files]
    level = config['level']
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda f: bz2.compress(f['data'], level),
                             files))


def entry(config, op, device):
    """The timed call: input -> output bytes on the host."""
    import compressjs_tpu_torch as cz
    level = config['level']
    if op == 'encode':
        return lambda x: cz.compress_file_device(x, level=level,
                                                 device=device)
    return lambda x: cz.decompress_file_device(x, device=device)


def judge(config, op, file, out):
    """The numbers of one distinct output."""
    if op == 'decode':
        return {'files_differing': int(not same_bytes(out, file['data']))}
    try:
        d = ref.decode(out, workers=JUDGE_WORKERS)
    except ref.FormatError:
        return {'format_errors': 1, 'files_differing': 1,
                'crc_mismatches': 0}
    return {'format_errors': int(d.level != config['level']),
            'files_differing': int(d.data != file['data']),
            'crc_mismatches': d.crc_mismatches}
