"""Plain decoder of compressjs's BWTC block body in NumPy and Python, in
the two block-parallel containers of the BWTC family: the benchmark's
reference for the BWTC configurations.

It follows the formats as they are defined, and imports nothing of the
program under test.

**BWTC-P** (`decode`): 'bwtP', the file size + 1 as a varint, the level
byte, a varint block count, each block's varint size, then the blocks.
Each block is one range coder's stream, started fresh and finished at
the block's end:

* the block's length and pidx, each through a log-distance model over
  bits (5 bits of bit length, then the bits below the top one);
* the block's used bytes as a 512-node usage tree (a node's three states
  coded 3-way, a leaf's as a bit; the children of a full or empty node
  skipped);
* the body: RUNA/RUNB digits (0, 1) of each run of MTF index 0 and
  literal c + 1 for index c, through an adaptive order-0 Fenwick model of
  asize + 1 symbols (levels above 5; levels <= 5 code it through another
  model, which no cell makes and this decoder refuses), until the digits
  and literals expand to the block's length;
* MTF over the used bytes undone, then the inverse of the BWT of the
  block terminated by a virtual end byte below every byte (pidx: where
  that end sits in the full column).

**BWTC-L** (`decode_bwtcl`): 'bwtL' and the same container.  Each block
is: varint length, pidx, symbol count S and lane count L, the 32-byte
used-byte bitmap, L varint lane sizes, then the lanes' streams.  The S
body symbols (no length, no usage tree, no end) are dealt round robin
over the lanes, each lane coded by its own fresh coder and Fenwick model.

The coder is Schindler's carry-counting range coder (32-bit, renormalised
a byte at a time below 2^23); a stream finishes with 5 bytes whose last 3
hold the coder's byte count.  The Fenwick model packs a symbol count (high
16 bits) and an escape count (low 16 bits) into each node of a heap-layout
tree; an unseen symbol is coded as the escape symbol, then itself in the
escape plane; the counts halve when the total reaches 0xFF00.

A stream that breaks the format raises `FormatError`: a bad magic, a block
count or size that disagrees with the bytes, a block over level x 100,000
bytes, a block that does not expand to its length, a coder that reads past
its stream or whose byte count is not its stream's length, or bytes after
the last block.  The blocks are decoded apart, in worker processes where
`workers` is more than one.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAGIC_P = b'bwtP'
MAGIC_L = b'bwtL'
MAX_PROB = 0xFF00
INCREMENT = 0x0100
BOTTOM = 1 << 23
M32 = 0xFFFFFFFF
ESC = 0xFFFF                   # the escape plane of a tree node
# adding a symbol: the symbol plane gains INCREMENT; in the escape plane
# the symbol also stops escaping (its escape count drops by 1)
SYM_UPDATE = INCREMENT << 16
ESC_UPDATE = SYM_UPDATE - 1


class FormatError(ValueError):
    """The stream breaks the format."""


@dataclass
class Decoded:
    data: bytes
    level: int
    block_lengths: list = field(default_factory=list)


# -- the range decoder ---------------------------------------------------------

class _Coder:
    """The range decoder over one coder's stream `data` (bytes), after
    its start: the first byte (the encoder's free byte, 0, or 1 where a
    carry reached it) skipped, the second read.  Tree nodes never pass 32 bits in a valid stream (the
    symbol plane stays below 2^16), so the model's arithmetic is plain."""

    def __init__(self, data):
        if len(data) < 5 or data[0] > 1:
            raise FormatError('a coder stream of %d bytes, first byte %d'
                              % (len(data), data[0] if data else -1))
        self.data, self.pos = data, 2
        self.buf = data[1]
        self.low = self.buf >> 1
        self.range = 1 << 7
        self.help = 0

    def _normalize(self):
        data = self.data
        while self.range <= BOTTOM:
            if self.pos >= len(data):
                raise FormatError('a coder reads past its stream')
            self.low = ((self.low << 8) | ((self.buf << 7) & 0xFF)) & M32
            self.buf = data[self.pos]
            self.pos += 1
            self.low |= self.buf >> 1
            self.range = (self.range << 8) & M32

    def cul_freq(self, tot):
        self._normalize()
        self.help = self.range // tot
        return min(self.low // self.help, tot - 1)

    def cul_shift(self, shift):
        self._normalize()
        self.help = self.range >> shift
        return min(self.low // self.help, (1 << shift) - 1)

    def update(self, sy, lt, tot):
        tmp = self.help * lt
        self.low -= tmp
        if lt + sy < tot:
            self.range = self.help * sy
        else:
            self.range -= tmp

    def bit(self):
        b = self.cul_shift(1)
        self.update(1, b, 2)
        return b

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def finish(self):
        """The coder's end: renormalised as the encoder's finish was, the
        code still inside the last interval, and every byte read (the
        decoder runs 3 bytes behind the encoder), the last 3 the
        encoder's byte count: the stream's length."""
        self._normalize()
        d = self.data
        count = (d[-3] << 16) | (d[-2] << 8) | d[-1]
        if self.low >= self.range or self.pos != len(d) \
                or count != len(d) & 0xFFFFFF:
            raise FormatError('a coder stream of %d bytes ends at byte %d '
                              'and records %d' % (len(d), self.pos, count))


# -- the Fenwick model ---------------------------------------------------------

def _new_tree(N):
    """The model of N - 1 symbols and the escape (N = asize + 2): leaves
    at [N, 2N); every symbol unseen (escape count 1), the escape symbol
    INCREMENT in the symbol plane."""
    tree = [0] * (2 * N)
    for k in range(N, 2 * N - 1):
        tree[k] = 1
    tree[2 * N - 1] = SYM_UPDATE
    _sum_tree(tree, N)
    return tree


def _sum_tree(tree, N):
    for k in range(N - 1, 0, -1):
        tree[k] = tree[2 * k] + tree[2 * k + 1]


def _rescale(tree, N):
    """Halve the symbol counts of the symbols that do not escape; one
    that halves to 0 escapes again; the escape symbol halves too, and
    drops to 0 once no symbol escapes."""
    no_escape = True
    for k in range(N, 2 * N - 1):
        p = tree[k]
        if p & ESC:
            no_escape = False
            continue
        p = (p >> 17) << 16
        if not p:
            p = 1
            no_escape = False
        tree[k] = p
    p = (tree[2 * N - 1] >> 17) << 16
    tree[2 * N - 1] = 0 if no_escape else (p or 1 << 16)
    _sum_tree(tree, N)


def _escape_symbol(c, tree, N):
    """A symbol coded in the escape plane, after the escape symbol."""
    tot = tree[1] & ESC
    prob = c.cul_freq(tot)
    i, lt = 1, 0
    while i < N:
        tree[i] += ESC_UPDATE
        i += i
        left = tree[i] & ESC
        if prob - lt >= left:
            lt += left
            i += 1
    sy = tree[i] & ESC
    tree[i] += ESC_UPDATE
    c.update(sy, lt, tot)
    _after_symbol(tree, N, i)
    return i - N


def _after_symbol(tree, N, i):
    """The model's steps after leaf i was coded: the escape symbol leaves
    the model with the last symbol that escapes, and the counts halve
    once their total reaches MAX_PROB."""
    if i == 2 * N - 1 and tree[1] & ESC == 1:
        drop = tree[i]
        while i:
            tree[i] -= drop
            i >>= 1
    if tree[1] >> 16 >= MAX_PROB:
        _rescale(tree, N)


def _symbols(c, asize, count=None, length=None):
    """The body's symbols (0, 1: RUNA, RUNB; c + 1: MTF index c) from the
    coder `c` through a fresh model of asize + 1 symbols: `count` of
    them, or as many as expand to `length` MTF indices."""
    N = asize + 2
    tree = _new_tree(N)
    esc_leaf = 2 * N - 1
    out = []
    append = out.append
    expanded, digit = 0, 0
    # the coder's state in locals: this loop is the reference's cost
    data, pos, end = c.data, c.pos, len(c.data)
    low, rng, buf = c.low, c.range, c.buf
    while (len(out) < count) if length is None else (expanded < length):
        while rng <= BOTTOM:
            if pos >= end:
                raise FormatError('a coder reads past its stream')
            low = ((low << 8) | ((buf << 7) & 0xFF)) & M32
            buf = data[pos]
            pos += 1
            low |= buf >> 1
            rng = (rng << 8) & M32
        tot = tree[1] >> 16
        help_ = rng // tot
        prob = low // help_
        if prob >= tot:
            prob = tot - 1
        i, lt = 1, 0
        while i < N:
            tree[i] += SYM_UPDATE
            i += i
            left = tree[i] >> 16
            if prob - lt >= left:
                lt += left
                i += 1
        sy = tree[i] >> 16
        tree[i] += SYM_UPDATE
        tmp = help_ * lt
        low -= tmp
        if lt + sy < tot:
            rng = help_ * sy
        else:
            rng -= tmp
        if i == esc_leaf or tree[1] >> 16 >= MAX_PROB:
            _after_symbol(tree, N, i)
        if i == esc_leaf:
            c.pos, c.low, c.range, c.buf = pos, low, rng, buf
            s = _escape_symbol(c, tree, N)
            pos, low, rng, buf = c.pos, c.low, c.range, c.buf
        else:
            s = i - N
        append(s)
        if length is not None:
            if s < 2:
                expanded += (s + 1) << digit
                digit += 1
            else:
                expanded += 1
                digit = 0
    c.pos, c.low, c.range, c.buf = pos, low, rng, buf
    if length is not None and expanded != length:
        raise FormatError('a block body expands past its length')
    return out


# -- the block's transforms ----------------------------------------------------

def _mtf_indices(syms, length):
    """RUNA/RUNB digits and literals -> (MTF index, repeat) events: each
    maximal stretch of digits is one run of index 0 (its j-th digit d adds
    (d + 1) << j), each literal s one index s - 1."""
    s = np.asarray(syms, dtype=np.int64)
    if s.shape[0] == 0:
        raise FormatError('an empty block body')
    is_run = s <= 1
    starts = is_run & np.concatenate([[True], ~is_run[:-1]])
    run_id = np.cumsum(starts) - 1
    first = np.flatnonzero(starts)
    pos_in_run = np.arange(s.shape[0]) - first[np.maximum(run_id, 0)] \
        if first.shape[0] else np.zeros(s.shape[0], dtype=np.int64)
    if is_run.any() and int(pos_in_run[is_run].max()) > 40:
        raise FormatError('a zero run past 2^40')
    run_len = np.zeros(first.shape[0], dtype=np.int64)
    np.add.at(run_len, run_id[is_run], (s[is_run] + 1) << pos_in_run[is_run])
    keep = starts | ~is_run
    idx = np.where(is_run, 0, s - 1)[keep]
    counts = np.where(is_run, 0, 1)[keep]
    counts[starts[keep]] = run_len
    if int(counts.sum()) != length:
        raise FormatError('a block expands to %d bytes, not %d'
                          % (int(counts.sum()), length))
    return idx, counts


def _undo_mtf(idx, counts, alphabet):
    """The BWT column from MTF events over the sorted used bytes."""
    if int(idx.max(initial=0)) >= len(alphabet):
        raise FormatError('an MTF index past the alphabet')
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


def _inverse_eof_bwt(U, P):
    """The block from its BWT column without the end byte, U, and P, the
    end byte's row in the full column of n + 1 rows (row 0, the rotation
    that starts with the end byte, ends with the block's last byte).

    The block comes out back to front: row 0's last byte, then the last
    byte of the row the rotation one to the right sits in (LF: one past
    the end byte, plus the bytes below it, plus its earlier copies in the
    column), and so on, until that row is P.  The rows are walked by
    doubling: the visit order of k steps from the order of k / 2."""
    n = U.shape[0]
    if not 1 <= P <= n:
        raise FormatError('pidx %d outside 1..%d' % (P, n))
    lf = np.empty(n, dtype=np.int64)
    lf[np.argsort(U, kind='stable')] = np.arange(1, n + 1)
    # row -> the index of its byte in U (the row after P is one lower);
    # the step into row P ends the walk and is clamped
    nxt = np.minimum(lf - (lf > P), n - 1)
    walk = np.zeros(1, dtype=np.int64)
    step = nxt
    while walk.shape[0] < n:
        walk = np.concatenate([walk, step[walk[:n - walk.shape[0]]]])
        step = step[step]
    return U[walk[::-1]]


def _alphabet_from_tree(c):
    """The used bytes from the usage tree."""
    tree = [0] * 512
    tree[0] = 1
    for i in range(1, 512):
        parent = tree[i >> 1]
        full = 1 << (9 - i.bit_length())
        if parent == 0 or parent == 2 * full:
            tree[i] = parent >> 1
        elif i >= 256:
            tree[i] = c.bit()
        else:
            v = c.cul_freq(3)
            c.update(1, v, 3)
            tree[i] = full if v == 2 else v
    return [b for b in range(256) if tree[256 + b]]


def _log_distance(c, size):
    """A value through the log-distance model of `size`: its bit length
    in fls(fls(size - 1)) bits, then the bits below its top bit."""
    lg = c.bits((size - 1).bit_length().bit_length())
    if lg < 2:
        return lg
    return (1 << (lg - 1)) + c.bits(lg - 1)


def _block_p(payload, level):
    """One BWTC-P block stream: its bytes."""
    c = _Coder(payload)
    length = _log_distance(c, level * 100000)
    pidx = _log_distance(c, level * 100000)
    if not 1 <= length <= level * 100000:
        raise FormatError('a block of %d bytes at level %d'
                          % (length, level))
    alphabet = _alphabet_from_tree(c)
    if not alphabet:
        raise FormatError('a block uses no byte')
    syms = _symbols(c, len(alphabet), length=length)
    c.finish()
    idx, counts = _mtf_indices(syms, length)
    return _inverse_eof_bwt(_undo_mtf(idx, counts, alphabet),
                            pidx).tobytes()


def _block_l(payload, level):
    """One BWTC-L block: its bytes."""
    r = _Reader(payload)
    length, pidx, S, lanes = (r.varint() for _ in range(4))
    if not 1 <= length <= level * 100000:
        raise FormatError('a block of %d bytes at level %d'
                          % (length, level))
    if not 1 <= lanes <= max(S, 1):
        raise FormatError('%d lanes for %d symbols' % (lanes, S))
    used = np.unpackbits(np.frombuffer(r.take(32), dtype=np.uint8))
    alphabet = np.flatnonzero(used).tolist()
    if not alphabet:
        raise FormatError('a block uses no byte')
    sizes = [r.varint() for _ in range(lanes)]
    syms = np.zeros(S, dtype=np.int64)
    for lane, size in enumerate(sizes):
        c = _Coder(r.take(size))
        syms[lane::lanes] = _symbols(c, len(alphabet),
                                     count=len(range(lane, S, lanes)))
        c.finish()
    r.end()
    idx, counts = _mtf_indices(syms, length)
    return _inverse_eof_bwt(_undo_mtf(idx, counts, alphabet),
                            pidx).tobytes()


# -- the container -------------------------------------------------------------

class _Reader:
    """Bytes and varints (7 bits a byte, most significant first, the last
    byte's top bit set) from a byte string."""

    def __init__(self, data):
        self.data, self.pos = data, 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise FormatError('the stream ends inside its container')
        self.pos += n
        return self.data[self.pos - n:self.pos]

    def byte(self):
        return self.take(1)[0]

    def varint(self):
        n = 0
        while True:
            b = self.byte()
            if b & 0x80:
                return n + (b & 0x7F)
            n = (n + b) << 7

    def end(self):
        if self.pos != len(self.data):
            raise FormatError('%d bytes after the last block'
                              % (len(self.data) - self.pos))


def _job(args):
    block, payload, level = args
    try:
        return block(payload, level)
    except FormatError as e:
        return e
    except (ZeroDivisionError, IndexError, ValueError) as e:
        # counts a broken stream can drive to 0, or a tree walk off its
        # leaves
        return FormatError('a block does not decode: %r' % (e,))


def _decode(stream, magic, block, workers):
    stream = bytes(stream)
    r = _Reader(stream)
    if r.take(4) != magic:
        raise FormatError('no %s magic' % magic.decode())
    size = r.varint() - 1
    level = r.byte()
    if not 1 <= level <= 9:
        raise FormatError('level %d' % level)
    if block is _block_p and level <= 5:
        raise FormatError('level %d: DefSum blocks are not decoded here'
                          % level)
    n = r.varint()
    if n > len(stream):
        raise FormatError('%d blocks in %d bytes' % (n, len(stream)))
    sizes = [r.varint() for _ in range(n)]
    payloads = [r.take(s) for s in sizes]
    r.end()
    jobs = [(block, p, level) for p in payloads]
    if workers > 1 and n > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                min(workers, n),
                mp_context=multiprocessing.get_context('spawn')) as ex:
            outs = list(ex.map(_job, jobs))
    else:
        outs = [_job(j) for j in jobs]
    for o in outs:
        if isinstance(o, FormatError):
            raise o
    data = b''.join(outs)
    if size >= 0 and len(data) != size:
        raise FormatError('%d bytes decoded of a %d-byte file'
                          % (len(data), size))
    return Decoded(data, level, [len(o) for o in outs])


def decode(stream, workers=1):
    """Decode one BWTC-P stream; raises FormatError where it breaks the
    format."""
    return _decode(stream, MAGIC_P, _block_p, workers)


def decode_bwtcl(stream, workers=1):
    """Decode one BWTC-L stream; raises FormatError where it breaks the
    format."""
    return _decode(stream, MAGIC_L, _block_l, workers)
