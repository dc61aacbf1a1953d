"""Fixed-width bit coding, the "lack of model" for sparse alphabets (a
copy of the model class of ``compressjs_tpu.models.no_model``): each
symbol of an alphabet of `size` is written as fls(size - 1) bits
through any object with write_bit / read_bit (a `BitStream`, or the
range coder's bit interface, as the BWTC codec uses it)."""

from __future__ import annotations

from .util import fls


class NoModel:

    def __init__(self, bitstream, size):
        self.bitstream = bitstream
        self.bits = fls(size - 1)

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
