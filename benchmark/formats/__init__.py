"""One module a format, found by the ``format`` of a configuration.

Each defines ``BLOCK_SPAN`` ({op: the program function called once a
block}), ``LIMITS`` ({op: {number compared: limit}}), ``prepare(config,
op, files)`` (the entry's input for each pool
file), ``entry(config, op, device)`` (the timed call) and ``judge(config,
op, file, out)`` (the numbers of one distinct output, after the window).
It may define ``check_setup(config, op, corpus)``: numbers compared that
set-up reads once.
"""

import numpy as np


def as_u8(x):
    """A bytes-like object or array as a flat uint8 array, not copied."""
    if isinstance(x, (bytes, bytearray, memoryview)):
        return np.frombuffer(x, dtype=np.uint8)
    return np.asarray(x, dtype=np.uint8).reshape(-1)


def same_bytes(a, b):
    a, b = as_u8(a), as_u8(b)
    return a.shape == b.shape and bool(np.array_equal(a, b))
