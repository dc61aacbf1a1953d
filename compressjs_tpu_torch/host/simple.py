"""Semi-static per-block range codec — statistics written raw, symbols
coded against the static cumulative table (reference
lib/Simple.js: 'smpl' container, 128 KiB blocks,
continuation bit per block, early block cut on count saturation).

A copy of ``compressjs_tpu.codecs.simple``. The body is coded by the
native runtime (``native.simple_encode`` / ``simple_decode``) where the
input is an `ArrayInputStream` of known size (and, to encode, the output
takes whole arrays, ``write_array``); ``native_body=False``, a keyword
of ``compress_file`` and ``decompress_file``, takes the Python twin,
which any other stream takes too."""

from __future__ import annotations

import numpy as np

from .. import native
from .range_coder import RangeCoder
from . import util
from .stream import ArrayInputStream, EOF

MAGIC = 'smpl'
MAX_BLOCK_SIZE = 1 << 17


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    encoder = RangeCoder(out_stream)
    encoder.encode_start(final_byte, 1)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        data = in_stream.read_array(file_size)
        st = encoder.export_enc_state()
        out_stream.write_array(native.simple_encode(data, st))
        encoder.import_enc_state(st)
        encoder.encode_finish()
        return

    block = np.zeros(MAX_BLOCK_SIZE, dtype=np.uint8)
    saw_eof = False

    def read_block():
        nonlocal saw_eof
        counts = np.zeros(257, dtype=np.int64)
        if saw_eof:
            return counts, 0
        pos = 0
        while pos < MAX_BLOCK_SIZE:
            c = in_stream.read_byte()
            if c == EOF:
                saw_eof = True
                break
            block[pos] = c
            pos += 1
            counts[c] += 1
            if counts[c] == 0xFFFF:  # count saturation cuts the block early
                break
        return counts, pos

    while True:
        counts, block_length = read_block()
        if saw_eof and block_length == 0:
            break
        encoder.encode_bit(True)  # another block follows
        for i in range(256):
            encoder.encode_short(int(counts[i]))
        cum = np.zeros(257, dtype=np.int64)
        cum[1:] = np.cumsum(counts[:256])
        tot = int(cum[256])
        for c in block[:block_length].tolist():
            encoder.encode_freq(int(counts[c]), int(cum[c]), tot)
    encoder.encode_bit(False)
    encoder.encode_finish()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    decoder = RangeCoder(in_stream)
    decoder.decode_start(True)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        st = decoder.export_dec_state(in_stream.pos)
        out = native.simple_decode(in_stream.data, st, file_size)
        in_stream.pos = decoder.import_dec_state(st)
        out_stream.write(out, 0, len(out))
        decoder.decode_finish()
        return
    while decoder.decode_bit():
        counts = np.zeros(256, dtype=np.int64)
        for i in range(256):
            counts[i] = decoder.decode_short()
        cum = np.zeros(257, dtype=np.int64)
        cum[1:] = np.cumsum(counts)
        blocksize = int(cum[256])
        cum_list = cum.tolist()
        out = np.empty(blocksize, dtype=np.uint8)
        for i in range(blocksize):
            cf = decoder.decode_cul_freq(blocksize)
            # binary search the cumulative table (careful: zero-width
            # ranges exist where counts[sym]==0)
            sym = int(np.searchsorted(cum, cf, side='right')) - 1
            out[i] = sym
            decoder.decode_update(cum_list[sym + 1] - cum_list[sym],
                                  cum_list[sym], blocksize)
        out_stream.write(out, 0, blocksize)
    decoder.decode_finish()


compress_file = util.compress_file_helper(MAGIC, _compress_guts, True)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)


class Simple:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
