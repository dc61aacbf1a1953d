"""LZJB (ZFS) with the compressjs container — copymap byte per 8 items,
matches coded as 6-bit len-3 + 10-bit offset over a 1 KiB window.

Format-compatible with the reference (lib/Lzjb.js):
'lzjb' magic, C_COMPAT offset-0 exclusion, and the multi-candidate hash
improvement (EXPAND slots per bucket from the level, all candidates
extended simultaneously, longest survivor wins).

A copy of ``compressjs_tpu.codecs.lzjb``. The body is coded by the
native runtime (``native.lzjb_encode`` / ``lzjb_decode``) where the
input is an `ArrayInputStream` of known size (and, to encode, the output
takes whole arrays, ``write_array``); ``native_body=False``, a keyword
of ``compress_file`` and ``decompress_file``, takes the Python twin,
which any other stream takes too."""

from __future__ import annotations

from .. import native
from . import util
from .stream import ArrayInputStream, EOF

MAGIC = 'lzjb'
NBBY = 8
MATCH_BITS = 6
MATCH_MIN = 3
MATCH_MAX = (1 << MATCH_BITS) + (MATCH_MIN - 1)
OFFSET_MASK = (1 << (16 - MATCH_BITS)) - 1
LEMPEL_SIZE_BASE = 1024
C_COMPAT = True


def expand_params(props):
    """Level -> (LEMPEL_SIZE, EXPAND) growth table
    (reference Lzjb.js:105-113)."""
    lempel_size = LEMPEL_SIZE_BASE
    expand = 1
    if isinstance(props, (int, float)) and not isinstance(props, bool):
        lempel_size *= 2
        p = max(1, min(9, int(props))) - 1
        expand = 1 << (p // 2)
        if p & 1:
            expand = round(expand * 1.5)
        if 2 <= p <= 4:
            expand += 1
    return lempel_size, expand


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    lempel_size, expand = expand_params(props)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        data = in_stream.read_array(file_size)
        out_stream.write_array(native.lzjb_encode(data, lempel_size,
                                                  expand))
        return
    lempel = [0] * (lempel_size * expand)

    window = bytearray(OFFSET_MASK + 1)
    wlen = OFFSET_MASK + 1
    windowpos = 0

    outwindow = bytearray(17)
    outpos = 0

    unbuffer = []

    def get():
        if unbuffer:
            return unbuffer.pop()
        return in_stream.read_byte()

    copymask = 1 << (NBBY - 1)

    while True:
        c1 = get()
        if c1 == EOF:
            break

        copymask <<= 1
        if copymask == (1 << NBBY):
            out_stream.write(outwindow, 0, outpos)
            copymask = 1
            outwindow[0] = 0
            outpos = 1

        c2 = get()
        if c2 == EOF:
            outwindow[outpos] = c1
            outpos += 1
            window[windowpos] = c1
            windowpos = (windowpos + 1) % wlen
            break
        c3 = get()
        if c3 == EOF:
            outwindow[outpos] = c1
            outpos += 1
            window[windowpos] = c1
            windowpos = (windowpos + 1) % wlen
            unbuffer.append(c2)
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
            # small offsets: tentative bytes may not be in the window yet
            # (offset 0 really means OFFSET_MASK+1; C breaks on it)
            if C_COMPAT and offset == 0:
                w1 = c1 ^ 1  # force mismatch
            elif offset == 1:
                w2, w3 = c1, c2
            elif offset == 2:
                w3 = c1
            if c1 == w1 and c2 == w2 and c3 == w3:
                matches.append(offset)
        # newest candidate first; oldest drops off
        lempel[hp + 1:hp + expand] = lempel[hp:hp + expand - 1]
        lempel[hp] = windowpos

        if not matches:
            outwindow[outpos] = c1
            outpos += 1
            window[windowpos] = c1
            windowpos = (windowpos + 1) % wlen
            unbuffer.append(c3)
            unbuffer.append(c2)
        else:
            outwindow[0] |= copymask
            for ch in (c1, c2, c3):
                window[windowpos] = ch
                windowpos = (windowpos + 1) % wlen
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
                c4 = get()
                mlen += 1
                base += 1
            if matches:
                last = matches[0]  # maximum length match
            unbuffer.append(c4)

            outwindow[outpos] = (((mlen - MATCH_MIN) << (NBBY - MATCH_BITS))
                                 | (last >> NBBY)) & 0xFF
            outwindow[outpos + 1] = last & 0xFF
            outpos += 2
    out_stream.write(outwindow, 0, outpos)


def _decompress_guts(in_stream, out_stream, out_size, native_body=True):
    if (native_body and out_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        data = in_stream.read_array(in_stream.size - in_stream.pos)
        out = native.lzjb_decode(data, out_size)
        out_stream.write(out, 0, len(out))
        return
    window = bytearray(OFFSET_MASK + 1)
    wlen = OFFSET_MASK + 1
    windowpos = 0
    copymask = 1 << (NBBY - 1)
    copymap = 0

    while out_size != 0:
        c = in_stream.read_byte()
        if c == EOF:
            break
        copymask <<= 1
        if copymask == (1 << NBBY):
            copymask = 1
            copymap = c
            c = in_stream.read_byte()
        if copymap & copymask:
            mlen = (c >> (NBBY - MATCH_BITS)) + MATCH_MIN
            offset = ((c << NBBY) | in_stream.read_byte()) & OFFSET_MASK
            cpy = windowpos - offset
            if cpy < 0:
                cpy += wlen
            if out_size >= 0:
                out_size -= mlen
            for _ in range(mlen):
                b = window[cpy]
                window[windowpos] = b
                out_stream.write_byte(b)
                windowpos += 1
                cpy += 1
                if windowpos >= wlen:
                    windowpos = 0
                if cpy >= wlen:
                    cpy = 0
        else:
            out_stream.write_byte(c)
            window[windowpos] = c
            windowpos += 1
            if windowpos >= wlen:
                windowpos = 0
            if out_size >= 0:
                out_size -= 1


compress_file = util.compress_file_helper(MAGIC, _compress_guts)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)


class Lzjb:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
