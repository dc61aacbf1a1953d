"""LZP3-style codec: context-hash match prediction with a 1 MiB ring
window, range-coded match lengths (16 log-distance models selected by
match-history bits, extra state -1 = same length as previous match at
that position) and order-1 literals.

Format-compatible with the reference (lib/Lzp3.js):
'lzp3' magic, first output byte 0x80 flags the (unused by default)
adaptive-Huffman mode, order-4/3/2 context tables with confirmation and
the previous match length embedded in table values above the position
bits.

A copy of ``compressjs_tpu.codecs.lzp3``. The body is coded by the
native runtime (``native.lzp3_encode`` / ``lzp3_decode``) where the
input is an `ArrayInputStream` of known size (and, to encode, the output
takes whole arrays, ``write_array``); ``native_body=False``, a keyword
of ``compress_file`` and ``decompress_file``, takes the Python twin,
which any other stream takes too."""

from __future__ import annotations

import numpy as np

from .. import native
from .huffman import Huffman
from .range_coder import RangeCoder
from .context1_model import Context1Model
from .defsum_model import DefSumModel
from .fenwick_model import FenwickModel
from .log_distance_model import LogDistanceModel
from .no_model import NoModel
from . import util
from .stream import ArrayInputStream, BitStream, EOF

MAGIC = 'lzp3'

USE_HUFFMAN_CODE = False
USE_DEFSUM = False
LENGTH_MODEL_CUTOFF = 256
MODEL_MAX_PROB = 0xFF00
MODEL_INCREMENT = 0x100

CTXT4_TABLE_SIZE = 1 << 16
CTXT3_TABLE_SIZE = 1 << 12
CTXT2_TABLE_SIZE = 1 << 16
LOG_WINDOW_SIZE = 20
WINDOW_SIZE = 1 << LOG_WINDOW_SIZE
MAX_MATCH_LEN = WINDOW_SIZE - 1
MATCH_LEN_CONTEXTS = 16
MAX24 = 0x00FFFFFF
MAX16 = 0x0000FFFF


class _Window:
    """Ring buffer + order-4/3/2 context hash tables with confirmation
    (reference Lzp3.js:36-102)."""

    def __init__(self, max_size):
        self.buffer = bytearray(min(max_size + 4, WINDOW_SIZE))
        # the ring arithmetic uses WINDOW_SIZE regardless of actual alloc;
        # grow lazily if a small hint was wrong
        self.pos = 0
        self.ctxt4 = np.zeros(CTXT4_TABLE_SIZE, dtype=np.int64)
        self.ctxt3 = np.zeros(CTXT3_TABLE_SIZE, dtype=np.int64)
        self.ctxt2 = np.zeros(CTXT2_TABLE_SIZE, dtype=np.int64)
        for b in (0x63, 0x53, 0x61, 0x20):  # initial context
            self.put(b)

    def _ensure(self, idx):
        if idx >= len(self.buffer):
            need = min(max(idx + 1, len(self.buffer) * 2), WINDOW_SIZE)
            self.buffer.extend(b'\0' * (need - len(self.buffer)))

    def put(self, byte):
        self._ensure(self.pos)
        self.buffer[self.pos] = byte
        self.pos += 1
        if self.pos >= WINDOW_SIZE:
            self.pos = 0
        return byte

    def get(self, pos):
        i = pos & (WINDOW_SIZE - 1)
        return self.buffer[i] if i < len(self.buffer) else 0

    def context(self, pos, n):
        c = 0
        pos = (pos - n) & (WINDOW_SIZE - 1)
        for _ in range(n):
            c = ((c << 8) | self.get(pos)) & 0xFFFFFFFF
            pos += 1
            if pos >= WINDOW_SIZE:
                pos = 0
        return c

    def get_index(self, s, match_len):
        """If match_len != 0: update tables.  Else: probe order-4/3/2 with
        context confirmation; returns stored (pos | prevLen<<20)+1 or 0."""
        c = self.context(s, 4)
        h4 = ((c >> 15) ^ c) & (CTXT4_TABLE_SIZE - 1)
        h3 = ((c >> 11) ^ c) & (CTXT3_TABLE_SIZE - 1)
        h2 = c & MAX16
        p = 0
        if match_len == 0:
            p = int(self.ctxt4[h4])
            if p != 0 and c != self.context(p - 1, 4):
                p = 0
            if p == 0:
                p = int(self.ctxt3[h3])
                if p != 0 and (c & MAX24) != self.context(p - 1, 3):
                    p = 0
                if p == 0:
                    p = int(self.ctxt2[h2])
                    # NOTE: the reference confirms with (c && MAX16) — the
                    # JS `&&` operator, so confirmation compares against
                    # MAX16 (or 0) rather than the low 16 context bits.
                    # Reproduced for format compatibility (Lzp3.js:90).
                    confirm = MAX16 if c else c
                    if p != 0 and confirm != self.context(p - 1, 2):
                        p = 0
        if match_len:
            match_len -= 1
        val = (s | (match_len << LOG_WINDOW_SIZE)) + 1
        self.ctxt4[h4] = val
        self.ctxt3[h3] = val
        self.ctxt2[h2] = val
        return p


def _make_coders(file_size, range_coder):
    coder_factory = FenwickModel.factory(range_coder, MODEL_MAX_PROB,
                                         MODEL_INCREMENT)
    if USE_DEFSUM:
        coder_factory = DefSumModel.factory(range_coder, False)
    no_factory = NoModel.factory(range_coder)

    def sparse_factory(size):
        if size > LENGTH_MODEL_CUTOFF:
            return no_factory(size)
        return coder_factory(size)

    literal = Context1Model(coder_factory, 256,
                            257 if file_size < 0 else 256)
    lens = [LogDistanceModel(MAX_MATCH_LEN + 1, 1,
                             coder_factory, sparse_factory)
            for _ in range(MATCH_LEN_CONTEXTS)]
    return literal, lens


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    window = _Window(file_size if file_size >= 0 else WINDOW_SIZE)

    if USE_HUFFMAN_CODE:
        out_stream.write_byte(0x80)
        bitstream = BitStream(out_stream)
        coder_factory = Huffman.factory(bitstream, MAX16)
        no_factory = NoModel.factory(bitstream)

        def sparse_factory(size):
            return no_factory(size)
        literal = Context1Model(coder_factory, 256,
                                257 if file_size < 0 else 256)
        lens = [LogDistanceModel(MAX_MATCH_LEN + 1, 1,
                                 coder_factory, sparse_factory)
                for _ in range(MATCH_LEN_CONTEXTS)]

        def flush():
            bitstream.flush()
    else:
        rc = RangeCoder(out_stream)
        rc.encode_start(0x00, 0)  # 0x00 flags range-coded
        if (native_body and file_size >= 0
                and not USE_DEFSUM
                and isinstance(in_stream, ArrayInputStream)
                and hasattr(out_stream, 'write_array')):
            data = in_stream.read_array(file_size)
            st = rc.export_enc_state()
            payload = native.lzp3_encode(data, st)
            out_stream.write_array(payload)
            rc.import_enc_state(st)
            rc.encode_finish()
            return
        literal, lens = _make_coders(file_size, rc)

        def flush():
            rc.encode_finish()

    in_size = 0
    match_context = 0
    while in_size != file_size:
        ch = in_stream.read_byte()
        s = window.pos
        p = window.get_index(s, 0)
        if p != 0:
            p -= 1  # p=0 means 'not here'; p=1 really means WINDOW_SIZE
            prev_match_len = (p >> LOG_WINDOW_SIZE) + 1
            match_len = 0
            while (window.get(p + match_len) == ch
                   and match_len < MAX_MATCH_LEN):
                match_len += 1
                window.put(ch)
                ch = in_stream.read_byte()
            ctx = lens[match_context & (MATCH_LEN_CONTEXTS - 1)]
            if prev_match_len == match_len:
                ctx.encode(-1)  # "same length as previous match here"
            else:
                ctx.encode(match_len)
            window.get_index(s, match_len)
            in_size += match_len
            match_context = (match_context << 1) & 0xFFFFFFFF
            if match_len > 0:
                match_context |= 1
        # a literal always follows a match (or failed probe)
        context1 = window.get(window.pos - 1)
        if ch == EOF:
            if file_size < 0:
                literal.encode(256, context1)
            break
        literal.encode(ch, context1)
        window.put(ch)
        in_size += 1
    flush()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    flags = in_stream.read_byte()
    use_huffman = bool(flags & 0x80)
    window = _Window(file_size if file_size >= 0 else WINDOW_SIZE)

    if use_huffman:
        bitstream = BitStream(in_stream)
        coder_factory = Huffman.factory(bitstream, MAX16)
        no_factory = NoModel.factory(bitstream)

        def sparse_factory(size):
            return no_factory(size)
        literal = Context1Model(coder_factory, 256,
                                257 if file_size < 0 else 256)
        lens = [LogDistanceModel(MAX_MATCH_LEN + 1, 1,
                                 coder_factory, sparse_factory)
                for _ in range(MATCH_LEN_CONTEXTS)]

        def finish():
            pass
    else:
        rc = RangeCoder(in_stream)
        rc.decode_start(True)
        if (native_body and file_size >= 0
                and not USE_DEFSUM
                and isinstance(in_stream, ArrayInputStream)):
            st = rc.export_dec_state(in_stream.pos)
            out = native.lzp3_decode(in_stream.data, st, file_size)
            in_stream.pos = rc.import_dec_state(st)
            out_stream.write(out, 0, file_size)
            rc.decode_finish()
            return
        literal, lens = _make_coders(file_size, rc)

        def finish():
            rc.decode_finish()

    out_size = 0
    match_context = 0
    while out_size != file_size:
        s = window.pos
        p = window.get_index(s, 0)
        if p != 0:
            p -= 1
            prev_match_len = (p >> LOG_WINDOW_SIZE) + 1
            match_len = lens[match_context & (MATCH_LEN_CONTEXTS - 1)].decode()
            if match_len < 0:
                match_len = prev_match_len
            for i in range(match_len):
                ch = window.get(p + i)
                out_stream.write_byte(window.put(ch))
            window.get_index(s, match_len)
            out_size += match_len
            match_context = (match_context << 1) & 0xFFFFFFFF
            if match_len > 0:
                match_context |= 1
        if out_size == file_size:
            break  # EOF
        context1 = window.get(window.pos - 1)
        ch = literal.decode(context1)
        if ch == 256:
            break  # EOF
        out_stream.write_byte(window.put(ch))
        out_size += 1
    finish()


compress_file = util.compress_file_helper(MAGIC, _compress_guts)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)


class Lzp3:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
