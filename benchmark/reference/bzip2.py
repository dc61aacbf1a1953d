"""Plain bzip2 stream decoder in NumPy and Python: the benchmark's
reference for the bzip2 configurations.

It follows the format as the bzip2 manual and libbz2 define it, and
imports nothing of the program under test.  Besides the bytes, it
reports the guarantees a stream of a stated level has to keep, so that
the harness can judge an encoder's output:

* every block's CRC and the stream CRC match the decoded bytes;
* no block's BWT column is longer than level x 100,000 bytes;
* the Huffman tables are prefix codes (none over-subscribed), every
  selector names a table that exists, and the stream ends at its last
  byte.

`decode(stream, workers)` returns a `Decoded`; a stream that breaks the
format raises `FormatError`.  Its blocks are decoded apart, in worker
processes where it is given more than one.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

BLOCK_MAGIC = 0x314159265359
END_MAGIC = 0x177245385090
GROUP_SIZE = 50
MAX_CODE_LEN = 20

# bit-reversal of every byte, for the CRC (below)
_REV8 = np.array([int('{:08b}'.format(i)[::-1], 2) for i in range(256)],
                 dtype=np.uint8)


class FormatError(ValueError):
    """The stream breaks the bzip2 format."""


@dataclass
class Decoded:
    data: bytes
    level: int
    block_lengths: list = field(default_factory=list)   # BWT column lengths
    crc_mismatches: int = 0          # blocks, and the stream CRC, that differ


def crc32_bzip2(data):
    """CRC-32/BZIP2 (MSB first, poly 0x04C11DB7) of `data`: the reflected
    CRC-32 of zlib over the bit-reversed bytes, reversed back."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    c = zlib.crc32(_REV8[buf].tobytes())
    return int('{:032b}'.format(c)[::-1], 2)


class _Bits:
    """MSB-first bit reader over a byte string."""

    def __init__(self, data):
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
        self.nbits = 8 * buf.shape[0]
        pad = np.concatenate([buf, np.zeros(8, dtype=np.uint8)]).astype(
            np.uint32)
        # the 32 bits from each byte on, so that any read of up to 25 bits
        # at bit p is one shift of words[p >> 3]
        self.words = ((pad[:-3] << 24) | (pad[1:-2] << 16) | (pad[2:-1] << 8)
                      | pad[3:]).tolist()
        self.pos = 0

    def read(self, n):
        if n > 24:
            hi = self.read(n - 24)
            return (hi << 24) | self.read(24)
        p = self.pos
        if p + n > self.nbits:
            raise FormatError('stream ends inside a block')
        self.pos = p + n
        return (self.words[p >> 3] >> (32 - n - (p & 7))) & ((1 << n) - 1)


def _table(lengths):
    """A lookup table of a canonical prefix code: (symbol by index,
    length by index, shift), where index = the next MAX_CODE_LEN bits
    >> shift.  Codes are assigned in order of length, then symbol, as
    bzip2 assigns them."""
    lengths = np.asarray(lengths, dtype=np.int64)
    top = int(lengths.max())
    order = np.lexsort((np.arange(len(lengths)), lengths))
    code, prev, spans = 0, int(lengths[order[0]]), []
    for s in order.tolist():
        ln = int(lengths[s])
        code <<= ln - prev
        prev = ln
        spans.append(1 << (top - ln))
        code += 1
    if code > (1 << top):
        raise FormatError('Huffman table is over-subscribed')
    sym = np.full(1 << top, -1, dtype=np.int64)
    ln = np.zeros(1 << top, dtype=np.int64)
    filled = int(sum(spans))
    sym[:filled] = np.repeat(order, spans)
    ln[:filled] = np.repeat(lengths[order], spans)
    return sym.tolist(), ln.tolist(), MAX_CODE_LEN - top


def _block_symbols(r, n_groups, selectors, tables, eob):
    """Huffman-decode a block's symbols up to its end-of-block symbol."""
    words = r.words
    p = r.pos
    out = []
    append = out.append
    for g in selectors:
        sym, ln, shift = tables[g]
        for _ in range(GROUP_SIZE):
            v = (words[p >> 3] >> (12 - (p & 7))) & 0xFFFFF
            i = v >> shift
            s = sym[i]
            if s < 0:
                raise FormatError('bits match no Huffman code')
            p += ln[i]
            if s == eob:
                if p > r.nbits:
                    raise FormatError('stream ends inside a block')
                r.pos = p
                return out
            append(s)
    raise FormatError('block has no end-of-block symbol')


def _undo_rle2_mtf(syms, alphabet):
    """RUNA/RUNB run lengths and move-to-front undone: the BWT column."""
    s = np.asarray(syms, dtype=np.int64)
    if s.shape[0] == 0:
        raise FormatError('empty block')
    is_run = s <= 1
    # each maximal stretch of RUNA/RUNB symbols is one run of MTF index 0:
    # its j-th symbol adds (symbol + 1) << j
    starts = is_run & np.concatenate([[True], ~is_run[:-1]])
    run_id = np.cumsum(starts) - 1
    first = np.concatenate([np.flatnonzero(starts), [0]])
    pos_in_run = np.arange(s.shape[0]) - first[np.maximum(run_id, 0)]
    if is_run.any() and int(pos_in_run[is_run].max()) > 40:
        raise FormatError('run length out of range')
    run_len = np.zeros(len(first) - 1, dtype=np.int64)
    np.add.at(run_len, run_id[is_run], (s[is_run] + 1) << pos_in_run[is_run])
    # events in stream order: a run (index 0, its length) at each run's
    # first symbol, a literal (index s - 1, length 1) at each other symbol
    keep = starts | ~is_run
    idx = np.where(is_run, 0, s - 1)[keep]
    counts = np.where(is_run, 0, 1)[keep]
    counts[starts[keep]] = run_len
    if int(idx.max(initial=0)) >= len(alphabet):
        raise FormatError('MTF index past the alphabet')
    lst = list(alphabet)
    vals = []
    append = vals.append
    for i in idx.tolist():
        if i:
            b = lst.pop(i)
            lst.insert(0, b)
            append(b)
        else:
            append(lst[0])
    return np.repeat(np.asarray(vals, dtype=np.uint8), counts)


def _inverse_bwt(L, orig_ptr):
    """The block before the BWT, from its last column L and origPtr."""
    # output k is L[p_k], p_0 = T[origPtr], p_k+1 = T[p_k], T the stable
    # sort's permutation: the cycle of T through origPtr, which ends there,
    # walked round as often as n takes (more than once where the block is
    # periodic).  Each node's distance to origPtr comes from pointer
    # doubling; nodes of other cycles never reach it and end at >= n.
    n = L.shape[0]
    nxt = np.argsort(L, kind='stable')
    nxt[orig_ptr] = orig_ptr
    dist = np.ones(n, dtype=np.int64)
    dist[orig_ptr] = 0
    for _ in range(max(1, (n - 1).bit_length())):
        dist += dist[nxt]
        nxt = nxt[nxt]
    on_cycle = np.flatnonzero(dist < n)
    c = on_cycle.shape[0]
    cycle = np.zeros(c, dtype=np.int64)
    cycle[c - 1 - dist[on_cycle]] = on_cycle
    return L[np.resize(cycle, n)]


def _undo_rle1(b):
    """Runs of 4 equal bytes are followed by a count of 0-255 more."""
    n = b.shape[0]
    eq4 = np.flatnonzero((b[:-3] == b[1:-2]) & (b[:-3] == b[2:-1])
                         & (b[:-3] == b[3:])) if n >= 4 else np.zeros(0, int)
    pieces = []
    i = 0
    k = 0
    cand = eq4.tolist()
    while True:
        while k < len(cand) and cand[k] < i:
            k += 1
        if k == len(cand):
            pieces.append(b[i:].tobytes())
            break
        j = cand[k]
        if j + 4 >= n:
            raise FormatError('run of 4 bytes without its count')
        pieces.append(b[i:j + 4].tobytes())
        pieces.append(bytes([int(b[j])]) * int(b[j + 4]))
        i = j + 5
    return b''.join(pieces)


def _decode_block(r, level):
    """One block after its magic: (bytes, stored CRC, BWT column
    length)."""
    stored_crc = r.read(32)
    if r.read(1):
        raise FormatError('randomised blocks are not written by bzip2 '
                          'since 0.9.5')
    orig_ptr = r.read(24)
    used_groups = r.read(16)
    alphabet = []
    for g in range(16):
        if used_groups & (0x8000 >> g):
            bits = r.read(16)
            alphabet += [16 * g + j for j in range(16)
                         if bits & (0x8000 >> j)]
    if not alphabet:
        raise FormatError('block uses no byte')
    n_groups = r.read(3)
    n_sel = r.read(15)
    if not 2 <= n_groups <= 6 or n_sel == 0:
        raise FormatError('bad table or selector count')
    mtf = list(range(n_groups))
    selectors = []
    for _ in range(n_sel):
        j = 0
        while r.read(1):
            j += 1
            if j >= n_groups:
                raise FormatError('selector past the table count')
        g = mtf.pop(j)
        mtf.insert(0, g)
        selectors.append(g)
    alpha_size = len(alphabet) + 2
    tables = []
    for _ in range(n_groups):
        ln = r.read(5)
        lengths = []
        for _ in range(alpha_size):
            while True:
                if not 1 <= ln <= MAX_CODE_LEN:
                    raise FormatError('code length out of range')
                if not r.read(1):
                    break
                ln += -1 if r.read(1) else 1
            lengths.append(ln)
        tables.append(_table(lengths))
    syms = _block_symbols(r, n_groups, selectors, tables, alpha_size - 1)
    L = _undo_rle2_mtf(syms, alphabet)
    n = L.shape[0]
    if n > level * 100000:
        raise FormatError('block of %d bytes passes level %d' % (n, level))
    if orig_ptr >= n:
        raise FormatError('origPtr past the block')
    return _undo_rle1(_inverse_bwt(L, orig_ptr)), stored_crc, n


def _magics(buf):
    """(block magics, end magics): the bit positions at which each 48-bit
    magic appears in `buf`, ascending.  The stream is read in pieces, each
    as 56-bit big-endian windows, one a byte, so that every bit offset of
    a magic is one shift of one window."""
    x = np.frombuffer(buf, dtype=np.uint8)
    pad = np.concatenate([x, np.zeros(7, dtype=np.uint8)]).astype(np.uint64)
    mask = np.uint64((1 << 48) - 1)
    found = {BLOCK_MAGIC: [], END_MAGIC: []}
    step = 1 << 22
    for a in range(0, x.shape[0], step):
        b = min(x.shape[0], a + step)
        v = np.zeros(b - a, dtype=np.uint64)
        for k in range(7):
            v = (v << np.uint64(8)) | pad[a + k:b + k]
        for s in range(8):
            w = (v >> np.uint64(8 - s)) & mask
            for magic, out in found.items():
                out += (8 * (a + np.flatnonzero(w == np.uint64(magic)))
                        + s).tolist()
    return sorted(found[BLOCK_MAGIC]), sorted(found[END_MAGIC])


def _block_at(buf, bit, level):
    """Decode the block whose magic starts at bit `bit` of `buf`: (bytes,
    stored CRC, BWT column length, the bit after the block)."""
    r = _Bits(buf)
    r.pos = bit + 48
    data, stored_crc, n = _decode_block(r, level)
    return data, stored_crc, n, r.pos


def _max_block_bytes(level):
    """The most bytes a block of this level can take: each of its symbols
    (at most one a byte of the column, and the end) at 20 bits, with its
    selectors, tables and header."""
    return (20 * (level * 100000 + 1)) // 8 + 70000


def _decode_blocks(stream, starts, ends, level, workers):
    """{bit position: `_block_at` result or the FormatError} for each
    block magic, each decoded from the bytes up to the next magic (and,
    where that cuts its block short, up to the most a block takes), in
    `workers` processes."""
    stops = sorted(starts + ends) + [8 * len(stream)]
    jobs = {}
    for p in starts:
        q = stops[stops.index(p) + 1]
        jobs[p] = (p // 8, min(len(stream), q // 8 + 8))
    most = _max_block_bytes(level)

    def run(mapper):
        keys = list(jobs)
        res = mapper(_block_job, [(stream[a:b], p - 8 * a, level)
                                  for p, (a, b) in
                                  ((p, jobs[p]) for p in keys)])
        return dict(zip(keys, res))

    if workers > 1 and len(starts) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                min(workers, len(starts)),
                mp_context=multiprocessing.get_context('spawn')) as ex:
            out = run(lambda f, args: list(ex.map(f, args, chunksize=2)))
    else:
        out = run(lambda f, args: [f(a) for a in args])
    for p, res in out.items():
        a, b = jobs[p]
        if isinstance(res, FormatError) and b < min(len(stream), a + most):
            # a false magic inside this block's payload cut it short
            out[p] = _block_job((stream[a:min(len(stream), a + most)],
                                 p - 8 * a, level))
    return {p: (r if isinstance(r, FormatError)
                else r[:3] + (r[3] + 8 * jobs[p][0],))
            for p, r in out.items()}


def _block_job(args):
    buf, bit, level = args
    try:
        return _block_at(buf, bit, level)
    except FormatError as e:
        return e


def decode(stream, workers=1):
    """Decode one bzip2 stream.  Raises FormatError where it breaks the
    format; CRC mismatches are counted, not raised, so that the caller
    can report them.

    The blocks are found by their magics and decoded apart, in `workers`
    processes where there are more than one; then they are chained from
    the stream header on, each block starting at the bit where the one
    before it ended, up to the end magic.  A magic that lies inside a
    block's payload is never on the chain."""
    stream = bytes(stream)
    r = _Bits(stream[:8])
    if len(stream) < 4 or r.read(24) != 0x425A68:       # 'BZh'
        raise FormatError('no bzip2 stream header')
    level = r.read(8) - 0x30
    if not 1 <= level <= 9:
        raise FormatError('bad block size in the header')
    starts, ends = _magics(stream)
    starts = [p for p in starts if p >= 32]
    blocks = _decode_blocks(stream, starts, ends, level, workers)
    out = Decoded(b'', level)
    pieces = []
    combined = 0
    pos = 32
    while pos not in ends:
        res = blocks.get(pos)
        if res is None:
            raise FormatError('bad block magic')
        if isinstance(res, FormatError):
            raise res
        data, stored_crc, n, pos = res
        out.block_lengths.append(n)
        crc = crc32_bzip2(data)
        out.crc_mismatches += crc != stored_crc
        combined = (((combined << 1) | (combined >> 31)) & 0xFFFFFFFF) ^ crc
        pieces.append(data)
    tail = _Bits(stream[pos // 8:])
    tail.pos = pos % 8 + 48
    out.crc_mismatches += tail.read(32) != combined
    if (pos + 48 + 32 + 7) // 8 != len(stream):
        raise FormatError('bytes after the end of the stream')
    out.data = b''.join(pieces)
    return out
