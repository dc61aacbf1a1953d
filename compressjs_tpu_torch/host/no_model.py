"""Fixed-width bit coding, the "lack of model" for sparse alphabets (a
copy of ``compressjs_tpu.models.no_model``): each
symbol of an alphabet of `size` is written as fls(size - 1) bits
through any object with write_bit / read_bit (a `BitStream`, or the
range coder's bit interface, as the BWTC codec uses it).

Its stand-alone codec writes a known-size input as a raw copy
(alphabet 256: 8 bits a symbol, byte-aligned); ``native_body=False``
and any stream of unknown size take the bit-by-bit model.
"""

from __future__ import annotations

from . import util
from .stream import ArrayInputStream, BitStream


class NoModel:

    def __init__(self, bitstream, size):
        self.bitstream = bitstream
        self.bits = util.fls(size - 1)

    @staticmethod
    def factory(bitstream):
        def make(size):
            return NoModel(bitstream, size)
        return make

    def encode(self, symbol):
        for i in range(self.bits - 1, -1, -1):
            self.bitstream.write_bit((symbol >> i) & 1)

    def decode(self):
        r = 0
        for _ in range(self.bits):
            r <<= 1
            if self.bitstream.read_bit():
                r += 1
        return r


MAGIC = 'nomo'


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    if native_body and file_size >= 0 \
            and isinstance(in_stream, ArrayInputStream) \
            and hasattr(out_stream, 'write_array'):
        # alphabet 256 -> 8 bits per symbol, byte-aligned: a raw copy
        out_stream.write_array(in_stream.read_array(file_size))
        return
    bitstream = BitStream(out_stream)
    model = NoModel(bitstream, 257 if file_size < 0 else 256)
    util.compress_with_model(in_stream, file_size, model)
    bitstream.flush()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    if native_body and file_size >= 0 \
            and isinstance(in_stream, ArrayInputStream):
        out = in_stream.read_array(file_size)
        out_stream.write(out, 0, len(out))
        return
    bitstream = BitStream(in_stream)
    model = NoModel(bitstream, 257 if file_size < 0 else 256)
    util.decompress_with_model(out_stream, file_size, model)


compress_file = util.compress_file_helper(MAGIC, _compress_guts)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)
NoModel.MAGIC = MAGIC
NoModel.compress_file = staticmethod(compress_file)
NoModel.decompress_file = staticmethod(decompress_file)
