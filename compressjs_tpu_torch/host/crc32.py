"""bzip2-flavoured CRC-32 (poly 0x04C11DB7, MSB-first, init/xorout
0xFFFFFFFF, no reflection), the two functions the stream writer needs.

CRC-32/BZIP2 is the bit-reflected image of zlib's CRC-32, so the bulk
path bit-reverses each input byte, runs ``zlib.crc32`` and bit-reverses
the 32-bit result.
"""

from __future__ import annotations

import zlib

import numpy as np

_REV8 = np.array([int('{:08b}'.format(i)[::-1], 2) for i in range(256)],
                 dtype=np.uint8)


def _rev32(x):
    return int('{:032b}'.format(int(x) & 0xFFFFFFFF)[::-1], 2)


def crc32_bzip2(data, crc=0xFFFFFFFF):
    """Finalised (complemented) bzip2 CRC of a bytes-like or uint8 array."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data, dtype=np.uint8)
    else:
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
    z = zlib.crc32(_REV8[buf].tobytes(), _rev32(crc) ^ 0xFFFFFFFF)
    return _rev32(z)


def stream_crc_combine(stream_crc, block_crc):
    """bzip2 rolling stream CRC: rotate left by one, then xor the block
    CRC."""
    s = int(stream_crc) & 0xFFFFFFFF
    return (((s << 1) | (s >> 31)) ^ int(block_crc)) & 0xFFFFFFFF
