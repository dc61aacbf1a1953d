"""bzip2-flavoured CRC-32 (poly 0x04C11DB7, MSB-first, init/xorout
0xFFFFFFFF, no reflection; the semantics of ``compressjs_tpu.utils.crc32``).

* `crc32_bzip2` and `crc32_raw`: the bulk path, eight bytes a step in
  the native runtime (``native.crc32_bzip2``), which drops the GIL, so
  the card encoders' split runs beside their worker thread.
* `CRC32`: the reference's incremental interface, byte by byte from a
  table, in bulk through `crc32_raw`, and a run of one byte in
  O(log count) (`update_crc_run`): the step for a fixed byte is an
  affine map over GF(2), composed with itself by doubling.
* `stream_crc_combine`: the rolling stream CRC of the bzip2 stream.
"""

from __future__ import annotations

import numpy as np

from .. import native


def _make_table():
    """The byte-at-a-time table of `CRC32.update_crc`."""
    tab = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7) if (c & 0x80000000) else (c << 1)
            c &= 0xFFFFFFFF
        tab[i] = c
    return tab


_TABLE = _make_table()


def crc32_bzip2(data, crc=0xFFFFFFFF):
    """Finalised (complemented) bzip2 CRC of a bytes-like or uint8 array."""
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data, dtype=np.uint8)
    else:
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
    return native.crc32_bzip2(buf, int(crc) & 0xFFFFFFFF)


def crc32_raw(data, crc=0xFFFFFFFF):
    """`crc32_bzip2` without the final complement: the register."""
    return crc32_bzip2(data, crc) ^ 0xFFFFFFFF


class CRC32:
    """Incremental bzip2 CRC with the reference's interface."""

    def __init__(self):
        self.crc = 0xFFFFFFFF

    def get_crc(self):
        return (~self.crc) & 0xFFFFFFFF

    def update_crc(self, value):
        c = self.crc
        self.crc = ((c << 8) ^ int(_TABLE[((c >> 24) ^ value) & 0xFF])) \
            & 0xFFFFFFFF

    def update(self, data):
        """Bulk update with a bytes-like or uint8 array."""
        if len(data) == 0:
            return
        self.crc = crc32_raw(data, self.crc)

    def update_crc_run(self, value, count):
        """Update with `count` copies of `value` in O(log count).

        The step for a fixed byte b is the affine map x -> M x ^ c_b over
        GF(2), M being shift-by-8-and-reduce; its count-th power is
        built by square-and-multiply on (matrix, constant) pairs."""
        if count <= 0:
            return
        if count < 64:
            for _ in range(count):
                self.update_crc(value)
            return
        acc_m, acc_c = _identity_matrix(), 0
        base_m, base_c = _shift8_matrix(), _byte_const(value)
        k = count
        while k:
            if k & 1:          # acc = base o acc
                acc_c = _mat_vec(base_m, acc_c) ^ base_c
                acc_m = _mat_mul(base_m, acc_m)
            base_c = _mat_vec(base_m, base_c) ^ base_c
            base_m = _mat_mul(base_m, base_m)
            k >>= 1
        self.crc = _mat_vec(acc_m, self.crc) ^ acc_c


# GF(2) 32x32 matrices as 32 uint32 columns (column i: the image of bit
# 31 - i)

def _identity_matrix():
    return [1 << (31 - i) for i in range(32)]


def _shift8_matrix():
    """The matrix of crc -> (crc << 8) ^ table[crc >> 24]."""
    cols = []
    for i in range(32):
        v = 1 << (31 - i)
        cols.append(((v << 8) ^ int(_TABLE[(v >> 24) & 0xFF])) & 0xFFFFFFFF)
    return cols


def _byte_const(value):
    """The constant term of xoring `value` into the top byte."""
    return int(_TABLE[value & 0xFF])


def _mat_vec(M, v):
    r = 0
    for i in range(32):
        if (v >> (31 - i)) & 1:
            r ^= M[i]
    return r


def _mat_mul(A, B):
    return [_mat_vec(A, B[i]) for i in range(32)]


def stream_crc_combine(stream_crc, block_crc):
    """bzip2 rolling stream CRC: rotate left by one, then xor the block
    CRC."""
    s = int(stream_crc) & 0xFFFFFFFF
    return (((s << 1) | (s >> 31)) ^ int(block_crc)) & 0xFFFFFFFF
