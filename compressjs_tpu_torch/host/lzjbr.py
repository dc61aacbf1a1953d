"""LZJB parse with range-coded output — literal/MATCH/EOF through an
order-1 context model over Fenwick trees, lengths and offsets through
log-distance models (offset extra state -1 = repeat last offset).

Format-compatible with the reference (lib/LzjbR.js):
'lzjR' magic with suppressed final byte, the same EXPAND candidate table
as Lzjb, and NoModel fallback above 32 entries.

A copy of ``compressjs_tpu.codecs.lzjbr``. The body is coded by the
native runtime (``native.lzjbr_encode`` / ``lzjbr_decode``) where the
input is an `ArrayInputStream` of known size (and, to encode, the output
takes whole arrays, ``write_array``); ``native_body=False``, a keyword
of ``compress_file`` and ``decompress_file``, takes the Python twin,
which any other stream takes too."""

from __future__ import annotations

from .. import native
from .range_coder import RangeCoder
from .context1_model import Context1Model
from .fenwick_model import FenwickModel
from .log_distance_model import LogDistanceModel
from .no_model import NoModel
from . import util
from .stream import ArrayInputStream, EOF

from .lzjb import MATCH_MAX, MATCH_MIN, OFFSET_MASK, expand_params

MAGIC = 'lzjR'
LENGTH_MODEL_CUTOFF = 32
MATCH = 256
EOF_SYM = 257


def _make_models(coder, size_hint_eof):
    no_factory = NoModel.factory(coder)
    model_factory = FenwickModel.factory(coder, 0xFF00, 0x100)
    literal_model = Context1Model(
        model_factory, 256, (EOF_SYM if size_hint_eof else MATCH) + 1)

    def sparse_factory(size):
        if size <= LENGTH_MODEL_CUTOFF:
            return model_factory(size)
        return no_factory(size)

    len_model = LogDistanceModel((MATCH_MAX - MATCH_MIN) + 1, 0,
                                 model_factory, sparse_factory)
    pos_model = LogDistanceModel(OFFSET_MASK + 1, 1,
                                 model_factory, sparse_factory)
    return literal_model, len_model, pos_model


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    lempel_size, expand = expand_params(props)
    encoder = RangeCoder(out_stream)
    encoder.encode_start(final_byte, 1)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        data = in_stream.read_array(file_size)
        st = encoder.export_enc_state()
        payload = native.lzjbr_encode(data, lempel_size, expand, st)
        out_stream.write_array(payload)
        encoder.import_enc_state(st)
        encoder.encode_finish()
        return
    lempel = [0] * (lempel_size * expand)

    window = bytearray(OFFSET_MASK + 1)
    wlen = OFFSET_MASK + 1
    windowpos = 0
    unbuffer = []

    def get():
        if unbuffer:
            return unbuffer.pop()
        return in_stream.read_byte()

    literal_model, len_model, pos_model = _make_models(encoder,
                                                       file_size < 0)
    last_char = 0x20
    last_offset = 0

    while True:
        initial_pos = windowpos
        c1 = get()
        if c1 == EOF:
            break
        c2 = get()
        if c2 == EOF:
            window[windowpos] = c1
            windowpos = (windowpos + 1) % wlen
            literal_model.encode(c1, last_char)
            break
        c3 = get()
        if c3 == EOF:
            window[windowpos] = c1
            windowpos = (windowpos + 1) % wlen
            literal_model.encode(c1, last_char)
            unbuffer.append(c2)
            last_char = c1
            continue

        h = (c1 << 16) + (c2 << 8) + c3
        h ^= (h >> 9)
        h += (h >> 5)
        h ^= c1
        hp = (h & (lempel_size - 1)) * expand
        matches = []
        for j in range(expand):
            offset = (windowpos - lempel[hp + j]) & OFFSET_MASK
            cpy = wlen + windowpos - offset
            w1 = window[cpy & OFFSET_MASK]
            w2 = window[(cpy + 1) & OFFSET_MASK]
            w3 = window[(cpy + 2) & OFFSET_MASK]
            if offset == 1:
                w2, w3 = c1, c2
            elif offset == 2:
                w3 = c1
            if c1 == w1 and c2 == w2 and c3 == w3:
                matches.append(offset)
        lempel[hp + 1:hp + expand] = lempel[hp:hp + expand - 1]
        lempel[hp] = windowpos

        if not matches:
            window[windowpos] = c1
            windowpos = (windowpos + 1) % wlen
            literal_model.encode(c1, last_char)
            unbuffer.append(c3)
            unbuffer.append(c2)
            last_char = c1
        else:
            literal_model.encode(MATCH, last_char)
            for ch in (c1, c2, c3):
                window[windowpos] = ch
                windowpos = (windowpos + 1) % wlen
            last_char = c3
            c4 = get()
            last = matches[0]
            base = wlen + windowpos
            mlen = MATCH_MIN
            while mlen < MATCH_MAX:
                if c4 == EOF:
                    break
                j = 0
                while j < len(matches):
                    w4 = window[(base - matches[j]) & OFFSET_MASK]
                    if c4 != w4:
                        last = matches.pop(j)
                    else:
                        j += 1
                if not matches:
                    break
                window[windowpos] = c4
                windowpos = (windowpos + 1) % wlen
                last_char = c4
                c4 = get()
                mlen += 1
                base += 1
            if matches:
                last = matches[0]
            unbuffer.append(c4)

            len_model.encode(mlen - MATCH_MIN)
            offset = (initial_pos - last) & OFFSET_MASK
            if offset == last_offset:
                pos_model.encode(-1)  # repeat-offset extra state
            else:
                pos_model.encode(offset)
                last_offset = offset
    if file_size < 0:
        literal_model.encode(EOF_SYM, last_char)
    encoder.encode_finish()


def _decompress_guts(in_stream, out_stream, out_size, native_body=True):
    decoder = RangeCoder(in_stream)
    decoder.decode_start(True)
    if (native_body and out_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        st = decoder.export_dec_state(in_stream.pos)
        out = native.lzjbr_decode(in_stream.data, st, out_size)
        in_stream.pos = decoder.import_dec_state(st)
        out_stream.write(out, 0, out_size)
        decoder.decode_finish()
        return
    window = bytearray(OFFSET_MASK + 1)
    wlen = OFFSET_MASK + 1
    windowpos = 0

    literal_model, len_model, pos_model = _make_models(decoder, out_size < 0)
    last_char = 0x20
    last_offset = 0
    while out_size != 0:
        c = literal_model.decode(last_char)
        if c == EOF_SYM:
            break
        if c == MATCH:
            mlen = len_model.decode() + MATCH_MIN
            # the coded "offset" is the absolute window position of the
            # match start (encoder sends (initialPos - rel) & OFFSET_MASK,
            # which is the hash-table entry itself)
            cpy = pos_model.decode()
            if cpy < 0:
                cpy = last_offset
            else:
                last_offset = cpy
            if out_size >= 0:
                out_size -= mlen
            for _ in range(mlen):
                b = window[cpy]
                last_char = b
                window[windowpos] = b
                out_stream.write_byte(b)
                windowpos = (windowpos + 1) % wlen
                cpy = (cpy + 1) % wlen
        else:
            out_stream.write_byte(c)
            last_char = c
            window[windowpos] = c
            windowpos = (windowpos + 1) % wlen
            if out_size >= 0:
                out_size -= 1
    decoder.decode_finish()


compress_file = util.compress_file_helper(MAGIC, _compress_guts, True)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)


class LzjbR:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
