"""Debug stand-in for RangeCoder: writes the (sy_f, lt_f, tot_f) triples as
varints and verifies them on decode — a coder/model contract sanitizer
(reference lib/DummyRangeCoder.js:8-78).  Swap it in for a
RangeCoder to turn model bugs into loud mismatch reports.

A copy of ``compressjs_tpu.coders.dummy_range_coder``.
"""

from __future__ import annotations

import sys

from .range_coder import RangeCoder
from .util import write_unsigned_number, read_unsigned_number


class DummyRangeCoder(RangeCoder):

    def encode_start(self, c, initlength):
        self.stream.write_byte(c)

    def encode_freq(self, sy_f, lt_f, tot_f):
        assert sy_f > 0
        assert tot_f > 0
        assert tot_f <= (1 << 23)
        if (sy_f + lt_f) > tot_f:
            print('dummy coder: lt_f + sy_f > tot_f', sy_f, lt_f, tot_f,
                  file=sys.stderr)
        write_unsigned_number(self.stream, sy_f)
        write_unsigned_number(self.stream, lt_f)
        write_unsigned_number(self.stream, tot_f)

    def encode_shift(self, sy_f, lt_f, shift):
        self.encode_freq(sy_f, lt_f, 1 << shift)

    def encode_finish(self):
        return 0

    def decode_start(self, skip_initial_read=False):
        return 0 if skip_initial_read else self.stream.read_byte()

    def decode_cul_freq(self, tot_f):
        assert tot_f > 0
        self._sy_f = read_unsigned_number(self.stream)
        self._lt_f = read_unsigned_number(self.stream)
        self._tot_f = read_unsigned_number(self.stream)
        if tot_f != self._tot_f:
            print('decodeCul* wrong total: got', tot_f,
                  'expected', self._tot_f, file=sys.stderr)
        return (self._sy_f >> 1) + self._lt_f

    def decode_cul_shift(self, shift):
        return self.decode_cul_freq(1 << shift)

    def decode_update(self, sy_f, lt_f, tot_f):
        assert sy_f > 0
        assert tot_f > 0
        if sy_f != self._sy_f or lt_f != self._lt_f or tot_f != self._tot_f:
            print('decodeUpdate wrong parameters; got', sy_f, lt_f, tot_f,
                  'expected', self._sy_f, self._lt_f, self._tot_f,
                  file=sys.stderr)

    def decode_finish(self):
        pass
