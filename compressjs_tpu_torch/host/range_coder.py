"""Carry-counting byte-oriented range coder (Schindler's rngcod13
family), a copy of ``compressjs_tpu.coders.range_coder``.

Bit-compatible with the reference coder: CODE_BITS=32, Top=2^31,
Bottom=2^23, SHIFT_BITS=23; the encoder takes a caller-supplied "free"
first byte and finishes with a 5-byte tail that holds the 24-bit byte
count; a total frequency must stay below 2^23.  The native block coder
(``native.bwtc_encode_block`` / ``bwtc_decode_block``) continues the
same coder through `export_enc_state` / `import_enc_state` and
`export_dec_state` / `import_dec_state`.
"""

from __future__ import annotations

CODE_BITS = 32
TOP_VALUE = 1 << (CODE_BITS - 1)        # 2^31
SHIFT_BITS = CODE_BITS - 9              # 23
EXTRA_BITS = (CODE_BITS - 2) % 8 + 1    # 7
BOTTOM_VALUE = TOP_VALUE >> 8           # 2^23
MASK32 = 0xFFFFFFFF


class RangeCoder:
    __slots__ = ('low', 'range', 'buffer', 'help', 'bytecount', 'stream')

    def __init__(self, stream):
        self.low = 0
        self.range = TOP_VALUE
        self.buffer = 0
        self.help = 0
        self.bytecount = 0
        self.stream = stream

    # ------------------------------------------------------------------ enc
    def _enc_normalize(self):
        out = self.stream
        while self.range <= BOTTOM_VALUE:
            if self.low < (0xFF << SHIFT_BITS):
                # no carry possible
                out.write_byte(self.buffer)
                while self.help:
                    out.write_byte(0xFF)
                    self.help -= 1
                self.buffer = (self.low >> SHIFT_BITS) & 0xFF
            elif self.low & TOP_VALUE:
                # carry now, no future carry
                out.write_byte((self.buffer + 1) & 0xFF)
                while self.help:
                    out.write_byte(0x00)
                    self.help -= 1
                self.buffer = (self.low >> SHIFT_BITS) & 0xFF
            else:
                self.help += 1
            self.range = (self.range << 8) & MASK32
            self.low = (self.low << 8) & (TOP_VALUE - 1)
            self.bytecount += 1

    def encode_start(self, c, initlength):
        self.low = 0
        self.range = TOP_VALUE
        self.buffer = c
        self.help = 0
        self.bytecount = initlength

    def encode_freq(self, sy_f, lt_f, tot_f):
        self._enc_normalize()
        r = self.range // tot_f
        tmp = r * lt_f
        self.low += tmp
        if (lt_f + sy_f) < tot_f:
            self.range = r * sy_f
        else:
            self.range -= tmp

    def encode_shift(self, sy_f, lt_f, shift):
        self._enc_normalize()
        r = self.range >> shift
        tmp = r * lt_f
        self.low += tmp
        if (lt_f + sy_f) >> shift:
            self.range -= tmp
        else:
            self.range = r * sy_f

    def encode_bit(self, b):
        self.encode_shift(1, 1 if b else 0, 1)

    def encode_byte(self, b):
        self.encode_shift(1, b, 8)

    def encode_short(self, s):
        self.encode_shift(1, s, 16)

    def encode_finish(self):
        out = self.stream
        self._enc_normalize()
        self.bytecount += 5
        tmp = self.low >> SHIFT_BITS
        if (self.low & (BOTTOM_VALUE - 1)) >= ((self.bytecount & 0xFFFFFF) >> 1):
            tmp += 1
        if tmp > 0xFF:  # carry
            out.write_byte((self.buffer + 1) & 0xFF)
            while self.help:
                out.write_byte(0x00)
                self.help -= 1
        else:
            out.write_byte(self.buffer)
            while self.help:
                out.write_byte(0xFF)
                self.help -= 1
        out.write_byte(tmp & 0xFF)
        out.write_byte((self.bytecount >> 16) & 0xFF)
        out.write_byte((self.bytecount >> 8) & 0xFF)
        out.write_byte(self.bytecount & 0xFF)
        return self.bytecount

    # ------------------------------------------------------------------ dec
    def decode_start(self, skip_initial_read=False):
        c = 0 if skip_initial_read else self.stream.read_byte()
        if not isinstance(c, int) or c < 0:
            return c  # EOF
        self.buffer = self.stream.read_byte()
        self.low = self.buffer >> (8 - EXTRA_BITS)
        self.range = 1 << EXTRA_BITS
        return c

    def _dec_normalize(self):
        ins = self.stream
        while self.range <= BOTTOM_VALUE:
            self.low = ((self.low << 8) | ((self.buffer << EXTRA_BITS) & 0xFF)) & MASK32
            self.buffer = ins.read_byte()
            # reads past EOF return -1; reproduce JS >>> semantics on it
            self.low = (self.low | ((self.buffer & MASK32) >> (8 - EXTRA_BITS))) & MASK32
            self.range = (self.range << 8) & MASK32

    def decode_cul_freq(self, tot_f):
        self._dec_normalize()
        self.help = self.range // tot_f
        tmp = self.low // self.help
        return tot_f - 1 if tmp >= tot_f else tmp

    def decode_cul_shift(self, shift):
        self._dec_normalize()
        self.help = self.range >> shift
        tmp = self.low // self.help
        return ((1 << shift) - 1) if (tmp >> shift) else tmp

    def decode_update(self, sy_f, lt_f, tot_f):
        tmp = self.help * lt_f
        self.low -= tmp
        if lt_f + sy_f < tot_f:
            self.range = self.help * sy_f
        else:
            self.range -= tmp

    def decode_bit(self):
        tmp = self.decode_cul_shift(1)
        self.decode_update(1, tmp, 2)
        return tmp

    def decode_byte(self):
        tmp = self.decode_cul_shift(8)
        self.decode_update(1, tmp, 1 << 8)
        return tmp

    def decode_short(self):
        tmp = self.decode_cul_shift(16)
        self.decode_update(1, tmp, 1 << 16)
        return tmp

    def decode_finish(self):
        self._dec_normalize()

    # ------------------------------------------------------------------
    # state exchange with the native (C++) coder: the sequential symbol
    # loops run in the native runtime on the same coder state
    def export_enc_state(self):
        import numpy as np
        return np.array([self.low, self.range, self.buffer, self.help,
                         self.bytecount], dtype=np.int64)

    def import_enc_state(self, s):
        self.low, self.range, self.buffer, self.help, self.bytecount = \
            (int(s[0]), int(s[1]), int(s[2]), int(s[3]), int(s[4]))

    def export_dec_state(self, pos):
        import numpy as np
        buf = self.buffer if self.buffer >= 0 else -1
        return np.array([self.low, self.range, buf, pos, 0],
                        dtype=np.int64)

    def import_dec_state(self, s):
        self.low, self.range, self.buffer = \
            int(s[0]), int(s[1]), int(s[2])
        return int(s[3])

    # bit and byte stream aliases (the reference coder's own)
    write_bit = encode_bit
    read_bit = decode_bit
    write_byte = encode_byte
    read_byte = decode_byte
