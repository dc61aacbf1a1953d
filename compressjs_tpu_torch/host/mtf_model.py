"""Adaptive order-0 range-coder model with escape, held as a move-to-front
list of (symbol, cumulative-prob) pairs.

Contract-compatible with the reference model
(lib/MTFModel.js:14-186): escape symbol == size, new
symbols appended after an escape-coded literal (uniform over the alphabet,
or exact over the unseen set with better_escape), coded symbol moved to the
MRU end with freq bumped by `increment`, rescale at max_prob halving freqs
and dropping zeros.

A copy of ``compressjs_tpu.models.mtf_model``. The body is coded by the
native runtime (``native.order0_encode('mtf')`` /
``order0_decode('mtf')``) where the input is an `ArrayInputStream` of
known size (and, to encode, the output takes whole arrays,
``write_array``); ``native_body=False``, a keyword of ``compress_file``
and ``decompress_file``, takes the Python twin, which any other stream
takes too."""

from __future__ import annotations

from .. import native
from .range_coder import RangeCoder
from . import util
from .stream import ArrayInputStream

DEFAULT_MAX_PROB = 0xFF00
DEFAULT_INCREMENT = 0x0100


class MTFModel:

    def __init__(self, coder, size, max_prob=None, increment=None,
                 better_escape=False):
        self.coder = coder
        self.increment = increment or DEFAULT_INCREMENT
        self.max_prob = max_prob or DEFAULT_MAX_PROB
        assert (self.max_prob + (self.increment - 1)) <= 0xFFFF
        self.sym = [0] * (size + 1)
        self.prob = [0] * (size + 2)
        self.sym[0] = size  # escape code
        self.prob[0] = 0
        self.seen_syms = 1
        self.prob[self.seen_syms] = self.increment  # running total
        self.num_syms = size
        self.sorted_seen = [size] if better_escape else None

    @staticmethod
    def factory(coder, max_prob=None, increment=None, better_escape=False):
        def make(size):
            return MTFModel(coder, size, max_prob, increment, better_escape)
        return make

    def clone(self):
        m = MTFModel(self.coder, self.num_syms, self.max_prob,
                     self.increment, self.sorted_seen is not None)
        k = self.seen_syms
        m.sym[:k] = self.sym[:k]
        m.prob[:k + 1] = self.prob[:k + 1]
        m.seen_syms = k
        if self.sorted_seen is not None:
            m.sorted_seen = list(self.sorted_seen)
        return m

    def _update(self, symbol, index, sy_f=0):
        # move symbol to the MRU end, shifting everything after it down
        j = index
        while j < self.seen_syms - 1:
            self.sym[j] = self.sym[j + 1]
            self.prob[j] = self.prob[j + 1] - sy_f
            j += 1
        if index < self.seen_syms:
            self.sym[j] = symbol
            self.prob[j] = self.prob[j + 1] - sy_f
            self.prob[self.seen_syms] = tot_f = \
                self.prob[self.seen_syms] + self.increment
            if symbol == self.num_syms and self.seen_syms >= self.num_syms:
                # last time we'll see an escape: remove it
                self.seen_syms -= 1
                tot_f = self.prob[self.seen_syms]
                if self.sorted_seen is not None:
                    self.sorted_seen.pop()
        else:  # append new symbol
            tot_f = self.prob[self.seen_syms]
            self.sym[index] = symbol
            self.prob[index] = tot_f
            tot_f += self.increment
            self.seen_syms += 1
            self.prob[self.seen_syms] = tot_f
            if self.sorted_seen is not None:
                self.sorted_seen.append(symbol)
                self.sorted_seen.sort()
        if tot_f >= self.max_prob:
            self._rescale()

    def _rescale(self):
        total = 0
        j = 0
        no_escape = True
        if self.sorted_seen is not None:
            self.sorted_seen = []
        for i in range(self.seen_syms):
            sym = self.sym[i]
            sy_f = (self.prob[i + 1] - self.prob[i]) >> 1
            if sy_f > 0:
                if sym == self.num_syms:
                    no_escape = False
                self.sym[j] = sym
                self.prob[j] = total
                j += 1
                total += sy_f
                if self.sorted_seen is not None:
                    self.sorted_seen.append(sym)
        self.prob[j] = total
        self.seen_syms = j
        if self.sorted_seen is not None:
            self.sorted_seen.sort()
        if no_escape and self.seen_syms < self.num_syms:
            # escape must keep nonzero probability while still needed
            self._update(self.num_syms, self.seen_syms)

    def decode(self):
        tot_f = self.prob[self.seen_syms]
        prob = self.coder.decode_cul_freq(tot_f)
        i = self.seen_syms - 1
        while i >= 0:
            if self.prob[i] <= prob:
                break
            i -= 1
        assert i >= 0
        symbol = self.sym[i]
        lt_f = self.prob[i]
        sy_f = self.prob[i + 1] - lt_f
        self.coder.decode_update(sy_f, lt_f, tot_f)
        self._update(symbol, i, sy_f)
        if symbol == self.num_syms:
            # escape: decode the literal
            sy_f = 1
            tot_f = self.num_syms
            if self.sorted_seen is not None:
                seen = self.sorted_seen
                tot_f = self.num_syms - self.seen_syms
                if seen and seen[-1] == self.num_syms:
                    tot_f += 1
                symbol = lt_f = self.coder.decode_cul_freq(tot_f)
                for s in seen:
                    if s <= symbol:
                        symbol += 1
                    else:
                        break
            else:
                symbol = lt_f = self.coder.decode_cul_freq(tot_f)
            self.coder.decode_update(sy_f, lt_f, tot_f)
            self._update(symbol, self.seen_syms)
        return symbol

    def encode(self, symbol):
        for i in range(self.seen_syms - 1, -1, -1):
            if symbol == self.sym[i]:
                lt_f = self.prob[i]
                sy_f = self.prob[i + 1] - lt_f
                tot_f = self.prob[self.seen_syms]
                self.coder.encode_freq(sy_f, lt_f, tot_f)
                return self._update(symbol, i, sy_f)
        # not found: escape, then literal
        assert symbol != self.num_syms
        self.encode(self.num_syms)
        sy_f = 1
        lt_f = symbol
        tot_f = self.num_syms
        if self.sorted_seen is not None:
            seen = self.sorted_seen
            tot_f -= self.seen_syms
            if seen and seen[-1] == self.num_syms:
                tot_f += 1
            for s in seen:
                if s < symbol:
                    lt_f -= 1
                else:
                    break
        self.coder.encode_freq(sy_f, lt_f, tot_f)
        return self._update(symbol, self.seen_syms)


MAGIC = 'mtfm'


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    coder = RangeCoder(out_stream)
    coder.encode_start(final_byte, 1)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        data = in_stream.read_array(file_size)
        st = coder.export_enc_state()
        out_stream.write_array(native.order0_encode('mtf', data, 256, -1,
                                                    st))
        coder.import_enc_state(st)
    else:
        model = MTFModel(coder, 257 if file_size < 0 else 256)
        util.compress_with_model(in_stream, file_size, model)
    coder.encode_finish()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    coder = RangeCoder(in_stream)
    coder.decode_start(True)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        st = coder.export_dec_state(in_stream.pos)
        out = native.order0_decode('mtf', in_stream.data, st, 256,
                                   file_size)
        in_stream.pos = coder.import_dec_state(st)
        out_stream.write(out, 0, file_size)
    else:
        model = MTFModel(coder, 257 if file_size < 0 else 256)
        util.decompress_with_model(out_stream, file_size, model)
    coder.decode_finish()


compress_file = util.compress_file_helper(MAGIC, _compress_guts, True)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)
MTFModel.MAGIC = MAGIC
MTFModel.compress_file = staticmethod(compress_file)
MTFModel.decompress_file = staticmethod(decompress_file)
