"""Bit-level output of the bzip2 container: the block and stream
magics, a bit-array accumulator for block headers, and an MSB-first
writer that packs the whole stream into bytes."""

from __future__ import annotations

import numpy as np

WHOLEPI = 0x314159265359
SQRTPI = 0x177245385090


def _bits_of(n, value):
    """The low n bits of value, most significant first, as uint8 0/1."""
    return np.array([(value >> i) & 1 for i in range(n - 1, -1, -1)],
                    dtype=np.uint8)


class BitArrayWriter:
    """Accumulate bits as uint8 0/1 chunks; cheap bulk appends."""

    def __init__(self):
        self._parts = []

    def write_bit(self, b):
        self._parts.append(np.array([1 if b else 0], dtype=np.uint8))

    def write_bits(self, n, value):
        self._parts.append(_bits_of(n, value))

    def append(self, bits):
        self._parts.append(np.asarray(bits, dtype=np.uint8))

    def bits(self):
        if not self._parts:
            return np.zeros(0, dtype=np.uint8)
        return np.concatenate(self._parts)


class BitWriter:
    """MSB-first bit writer into a growing byte buffer: whole bytes are
    packed as soon as they complete, fewer than 8 bits stay pending."""

    def __init__(self):
        self._buf = bytearray()
        self._pending = np.zeros(0, dtype=np.uint8)

    def write_bits(self, n, value):
        self.write_bit_array(_bits_of(n, value))

    def write_bit_array(self, bits):
        bits = np.concatenate([self._pending,
                               np.asarray(bits, dtype=np.uint8)])
        whole = bits.shape[0] & ~7
        self._buf += np.packbits(bits[:whole]).tobytes()
        self._pending = bits[whole:]

    def getvalue(self):
        """The stream so far, its last byte zero-padded."""
        return bytes(self._buf) + np.packbits(self._pending).tobytes()
