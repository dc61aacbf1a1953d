"""Breaks of the timed path, for the controls and for the tests that show
a broken path reads `correct` false.  The benchmark's own runs use none:
only ``run.py --fault NAME`` installs one.

* ``crc_skipped`` (the encode control): the encoder's CRC pass left out,
  the step that would tempt a later change (every CRC written as 0).
* ``byte_altered`` (the decode control): one byte of each output changed
  where it is produced.
* ``half_blocks``: half of each file's blocks left out (encode: the first
  half of the input only; decode: the first half of the output).
* ``unchanged``: the entry hands its input back unchanged.
"""

from __future__ import annotations

import numpy as np


def _as_bytes(out):
    return out if isinstance(out, bytes) else bytes(
        np.asarray(out, dtype=np.uint8))


def _altered(out):
    b = bytearray(_as_bytes(out))
    if b:
        b[len(b) // 2] ^= 0x01
    return bytes(b)


def _first_half(out):
    out = _as_bytes(out)
    return out[:len(out) // 2]


def install(name, op, call):
    """(the entry `call` with the fault `name` in its path, what
    ``tracing.restore`` puts back)."""
    if name == 'crc_skipped':
        if op != 'encode':
            raise ValueError('crc_skipped breaks an encoder')
        from compressjs_tpu_torch.host.crc32 import crc32_bzip2
        from benchmark.tracing import replace
        return call, replace(crc32_bzip2, lambda data: 0)
    if name == 'byte_altered':
        return (lambda x: _altered(call(x))), []
    if name == 'half_blocks':
        if op == 'encode':
            return (lambda x: call(x[:len(x) // 2])), []
        return (lambda x: _first_half(call(x))), []
    if name == 'unchanged':
        return _as_bytes, []
    raise ValueError('no fault %r' % name)
