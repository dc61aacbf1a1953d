"""Host side of the bzip2 decode (numpy, no torch): the bit reader, the
stream and block header parse, the canonical-Huffman decode tables and
the bit-aligned block-magic scan that yields every candidate block start.

Copies of ``compressjs_tpu.codecs.bzip2`` (`Bzip2Error`, `Err`,
`_throw`, `_BitReader`, `_parse_block_header`, `_decode_tables`,
`_start`) and ``compressjs_tpu.parallel.decode`` (`_scan_magic`,
`_parse_candidates`, `_pow2_at_least`).  Every format error raises
`Bzip2Error` (a ValueError) with the JAX codec's error code and message
at the same site.
"""

from __future__ import annotations

import numpy as np

MAX_HUFCODE_BITS = 20
MAX_SYMBOLS = 258

MAGIC_BYTES = np.array([0x31, 0x41, 0x59, 0x26, 0x53, 0x59], dtype=np.uint8)
END_MAGIC_BYTES = np.array([0x17, 0x72, 0x45, 0x38, 0x50, 0x90],
                           dtype=np.uint8)


class Bzip2Error(ValueError):
    def __init__(self, msg, code=None):
        super().__init__(msg)
        self.error_code = code


# error codes of the reference's Err table
class Err:
    OK = 0
    LAST_BLOCK = -1
    NOT_BZIP_DATA = -2
    UNEXPECTED_INPUT_EOF = -3
    UNEXPECTED_OUTPUT_EOF = -4
    DATA_ERROR = -5
    OUT_OF_MEMORY = -6
    OBSOLETE_INPUT = -7
    END_OF_BLOCK = -8


_MESSAGES = {
    Err.LAST_BLOCK: 'Bad file checksum',
    Err.NOT_BZIP_DATA: 'Not bzip data',
    Err.UNEXPECTED_INPUT_EOF: 'Unexpected input EOF',
    Err.UNEXPECTED_OUTPUT_EOF: 'Unexpected output EOF',
    Err.DATA_ERROR: 'Data error',
    Err.OUT_OF_MEMORY: 'Out of memory',
    Err.OBSOLETE_INPUT: 'Obsolete (pre 0.9.5) bzip format not supported.',
}


def _throw(code, detail=None):
    msg = _MESSAGES.get(code, 'unknown error')
    if detail:
        msg += ': ' + detail
    raise Bzip2Error(msg, code)


class _BitReader:
    """MSB-first bit reader over a uint8 array with absolute bit
    addressing; bits past the end read as zero."""

    __slots__ = ('data', 'pos')

    def __init__(self, data):
        if not isinstance(data, np.ndarray):
            data = np.frombuffer(bytes(data), dtype=np.uint8)
        self.data = data
        self.pos = 0

    def read_bits(self, n):
        pos = self.pos
        self.pos = pos + n
        end_byte = (pos + n + 7) >> 3
        start_byte = pos >> 3
        chunk = bytes(self.data[start_byte:end_byte])
        if len(chunk) < end_byte - start_byte:
            chunk = chunk + b'\0' * (end_byte - start_byte - len(chunk))
        val = int.from_bytes(chunk, 'big')
        total_bits = (end_byte - start_byte) * 8
        val >>= total_bits - ((pos & 7) + n)
        return val & ((1 << n) - 1)

    def seek_bit(self, pos):
        self.pos = pos

    def tell_bit(self):
        return self.pos

    def eof(self):
        return self.pos >= int(self.data.shape[0]) * 8

    def align_byte(self):
        self.pos = (self.pos + 7) & ~7


def _start(r):
    """Parse the 'BZh#' stream header; returns the block buffer size."""
    b = [r.read_bits(8) for _ in range(4)]
    if bytes(b[:3]) != b'BZh':
        _throw(Err.NOT_BZIP_DATA, 'bad magic')
    level = b[3] - 0x30
    if level < 1 or level > 9:
        _throw(Err.NOT_BZIP_DATA, 'level out of range')
    return 100000 * level


def _parse_block_header(r, dbuf_size):
    """Parse one block header (after magic and CRC) up to the first
    symbol bit: randomised flag, origPtr, symbol map, selectors, Huffman
    tables.  Returns (orig_pointer, sym_to_byte, selectors, groups) with
    r.pos at the first symbol bit; groups are `_decode_tables` tuples."""
    if r.read_bits(1):
        _throw(Err.OBSOLETE_INPUT)
    orig_pointer = r.read_bits(24)
    if orig_pointer > dbuf_size:
        _throw(Err.DATA_ERROR, 'initial position out of bounds')

    t = r.read_bits(16)
    sym_to_byte = []
    for i in range(16):
        if t & (1 << (0xF - i)):
            k = r.read_bits(16)
            for j in range(16):
                if k & (1 << (0xF - j)):
                    sym_to_byte.append((i << 4) | j)
    sym_total = len(sym_to_byte)

    group_count = r.read_bits(3)
    if group_count < 2 or group_count > 6:
        _throw(Err.DATA_ERROR)
    n_selectors = r.read_bits(15)
    if n_selectors == 0:
        _throw(Err.DATA_ERROR)

    # unary selector codes, decoded at once from a window of at most
    # group_count + 1 bits each
    max_bits = n_selectors * (group_count + 1)
    start = r.pos
    nbytes = max(0, min(r.data.shape[0] - (start >> 3),
                        (max_bits + (start & 7) + 7) >> 3))
    off = min(start >> 3, r.data.shape[0])
    bits = np.unpackbits(r.data[off:off + nbytes])[start & 7:]
    if bits.shape[0] < max_bits:
        bits = np.concatenate(
            [bits, np.zeros(max_bits - bits.shape[0], dtype=np.uint8)])
    zeros = np.nonzero(bits == 0)[0][:n_selectors]
    if zeros.shape[0] < n_selectors:
        _throw(Err.DATA_ERROR)
    j_arr = np.diff(zeros, prepend=-1) - 1
    if (j_arr >= group_count).any():
        _throw(Err.DATA_ERROR)
    r.pos = start + int(zeros[-1]) + 1
    mtf_lst = list(range(group_count))
    selectors = []
    for j in j_arr.tolist():
        s = mtf_lst.pop(j)
        mtf_lst.insert(0, s)
        selectors.append(s)

    sym_count = sym_total + 2
    groups = []
    for _ in range(group_count):
        t = r.read_bits(5)
        lengths = np.empty(sym_count, dtype=np.int32)
        for i in range(sym_count):
            while True:
                if t < 1 or t > MAX_HUFCODE_BITS:
                    _throw(Err.DATA_ERROR)
                if not r.read_bits(1):
                    break
                if not r.read_bits(1):
                    t += 1
                else:
                    t -= 1
            lengths[i] = t
        groups.append(_decode_tables(lengths, sym_count))
    return orig_pointer, sym_to_byte, selectors, groups


def _decode_tables(lengths, sym_count):
    """(min_len, max_len, limit, base, permute) from code lengths."""
    min_len = int(lengths.min())
    max_len = int(lengths.max())
    permute = np.zeros(MAX_SYMBOLS, dtype=np.int32)
    pp = 0
    temp = np.zeros(MAX_HUFCODE_BITS + 1, dtype=np.int64)
    limit = np.zeros(MAX_HUFCODE_BITS + 2, dtype=np.int64)
    base = np.zeros(MAX_HUFCODE_BITS + 1, dtype=np.int64)
    for i in range(min_len, max_len + 1):
        sel = np.nonzero(lengths == i)[0]
        permute[pp:pp + len(sel)] = sel
        pp += len(sel)
    for i in range(sym_count):
        temp[lengths[i]] += 1
    pp = t = 0
    for i in range(min_len, max_len):
        pp += temp[i]
        limit[i] = pp - 1
        pp <<= 1
        t += temp[i]
        base[i + 1] = pp - t
    limit[max_len + 1] = np.iinfo(np.int64).max
    limit[max_len] = pp + temp[max_len] - 1
    base[min_len] = 0
    return (min_len, max_len, limit.tolist(), base.tolist(),
            permute.tolist())


def _scan_magic(data, pattern):
    """Every bit position where the 48-bit `pattern` occurs: one byte
    compare per bit alignment on the first fully covered byte, then the
    remaining bytes checked on those hits only."""
    n = int(data.shape[0])
    if n < 7:
        return np.zeros(0, dtype=np.int64)
    P = 0
    for b in pattern:
        P = (P << 8) | int(b)
    hits = []
    for s in range(8):
        if s == 0:
            cand = np.nonzero(data[:n - 5] == pattern[0])[0]
            for k in range(1, 6):
                if cand.size == 0:
                    break
                cand = cand[data[cand + k] == pattern[k]]
            hits.append(cand.astype(np.int64) * 8)
            continue
        # bytes i+1..i+5 are fully covered at in-byte offset s; bytes i
        # and i+6 hold the low (8-s) / high s edge bits
        cand = np.nonzero(
            data[1:n - 5] == (P >> (32 + s)) & 0xFF)[0]
        for k in range(2, 6):
            if cand.size == 0:
                break
            cand = cand[data[cand + k] == (P >> (40 - 8 * k + s)) & 0xFF]
        if cand.size:
            cand = cand[(data[cand] & ((1 << (8 - s)) - 1))
                        == P >> (40 + s)]
        if cand.size:
            cand = cand[(data[cand + 6] >> (8 - s)) == (P & ((1 << s) - 1))]
        hits.append(cand.astype(np.int64) * 8 + s)
    out = np.concatenate(hits)
    out.sort()
    return out


def _parse_candidates(data):
    """(dbuf_size, first_block_pos, candidate block bit positions, end
    hits), or None when the stream has no block at its first block
    position or no end-of-stream magic after it.  The end hits are every
    bit position of the end-of-stream magic after the first block, in
    order: a payload may hold the pattern, so any of them may be false.
    The candidates are the block magics from the first block up to the
    last end hit."""
    r = _BitReader(data)
    dbuf_size = _start(r)
    first_block_pos = r.tell_bit()
    end_hits = [int(p) for p in _scan_magic(data, END_MAGIC_BYTES)
                if p > first_block_pos]
    if not end_hits:
        return None
    candidates = [int(p) for p in _scan_magic(data, MAGIC_BYTES)
                  if first_block_pos <= p < end_hits[-1]]
    if not candidates or candidates[0] != first_block_pos:
        return None
    return dbuf_size, first_block_pos, candidates, end_hits


def _pow2_at_least(x, lo):
    v = lo
    while v < x:
        v *= 2
    return v
