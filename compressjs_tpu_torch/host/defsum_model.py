"""Deferred-summation order-0 model (Charles Bloom) for dense alphabets,
a copy of ``compressjs_tpu.models.defsum_model``.

A fixed total of 256; updates accumulate and are folded into the
cumulative tables only when their count reaches the threshold; the
escape symbol has its own reduced cumulative table and a hard
MAX_ESCAPE_COUNT cap; the decoder keeps O(1) prob -> symbol tables,
rebuilt at every fold.  The BWTC codec codes its block bodies with it at
levels 5 and below (natively in ``cz_bwtc_encode_block``; this class is
that loop's twin).

The stand-alone order-0 codec (``compress_file``, ``decompress_file``)
codes its body in the native runtime (``native.order0_encode('defsum')``
/ ``order0_decode('defsum')``) where the input is an `ArrayInputStream`
of known size (and, to encode, the output takes whole arrays);
``native_body=False`` takes the Python model, which any other stream
takes too."""

from __future__ import annotations

from .. import native
from .range_coder import RangeCoder
from .stream import ArrayInputStream
from . import util

LOG_PROB_TOTAL = 8
PROB_TOTAL = 1 << LOG_PROB_TOTAL
MAX_ESCAPE_COUNT = 40


class DefSumModel:

    def __init__(self, coder, size, is_decoder=False):
        assert size < 300  # dense alphabets only
        self.num_syms = size
        self.coder = coder
        self.prob = [0] * (size + 2)      # cumulative; prob[ESCAPE+1]=total
        self.escape = list(range(size + 1))
        self.update = [0] * (size + 1)
        self.prob[size + 1] = PROB_TOTAL
        self.update_count = 0
        self.update_thresh = PROB_TOTAL - (PROB_TOTAL // 2)
        self.is_decoder = is_decoder
        if is_decoder:
            self.prob_to_sym = [size] * PROB_TOTAL
            self.esc_prob_to_sym = list(range(size))

    @staticmethod
    def factory(coder, is_decoder=False):
        def make(size):
            return DefSumModel(coder, size, is_decoder)
        return make

    def _update(self, symbol, is_decoder=False):
        if symbol == self.num_syms:
            if self.update[symbol] >= MAX_ESCAPE_COUNT:
                return  # hard cap on escape counts
            # an escape may not trigger the fold, else the escaped literal
            # would be decoded against post-fold tables
            if self.update_count >= (self.update_thresh - 1):
                return
        self.update[symbol] += 1
        self.update_count += 1
        if self.update_count < self.update_thresh:
            return  # deferred

        # fold accumulated updates into the cumulative tables
        cum_prob = cum_esc = odd = 0
        self.escape[0] = self.prob[0] = 0
        for i in range(self.num_syms + 1):
            new_prob = ((self.prob[i + 1] - self.prob[i]) >> 1) + self.update[i]
            if new_prob:
                self.prob[i] = cum_prob
                cum_prob += new_prob
                if new_prob & 1:
                    odd += 1
                self.escape[i] = cum_esc
            else:  # this symbol will escape
                self.prob[i] = cum_prob
                self.escape[i] = cum_esc
                cum_esc += 1
        self.prob[self.num_syms + 1] = cum_prob
        assert cum_prob == PROB_TOTAL
        self.update_thresh = PROB_TOTAL - ((cum_prob - odd) // 2)
        for i in range(self.num_syms + 1):
            self.update[i] = 0
        self.update[self.num_syms] = 1  # escape never vanishes
        self.update_count = 1
        if not is_decoder:
            return
        j = k = 0
        for i in range(self.num_syms + 1):
            lim = self.prob[i + 1]
            while j < lim:
                self.prob_to_sym[j] = i
                j += 1
            esc_lim = self.escape[i + 1] if i + 1 <= self.num_syms else None
            if esc_lim is not None:
                while k < esc_lim:
                    self.esc_prob_to_sym[k] = i
                    k += 1

    def encode(self, symbol):
        lt_f = self.prob[symbol]
        sy_f = self.prob[symbol + 1] - lt_f
        assert self.prob[self.num_syms + 1] == PROB_TOTAL
        if sy_f:
            self.coder.encode_shift(sy_f, lt_f, LOG_PROB_TOTAL)
            return self._update(symbol)
        # escape, then literal against the reduced escape table
        assert symbol != self.num_syms
        self.encode(self.num_syms)
        lt_f = self.escape[symbol]
        sy_f = self.escape[symbol + 1] - lt_f
        tot_f = self.escape[self.num_syms]
        self.coder.encode_freq(sy_f, lt_f, tot_f)
        return self._update(symbol)

    def decode(self):
        prob = self.coder.decode_cul_shift(LOG_PROB_TOTAL)
        symbol = self.prob_to_sym[prob]
        lt_f = self.prob[symbol]
        sy_f = self.prob[symbol + 1] - lt_f
        self.coder.decode_update(sy_f, lt_f, PROB_TOTAL)
        self._update(symbol, True)
        if symbol != self.num_syms:
            return symbol
        # escape
        tot_f = self.escape[self.num_syms]
        prob = self.coder.decode_cul_freq(tot_f)
        symbol = self.esc_prob_to_sym[prob]
        lt_f = self.escape[symbol]
        sy_f = self.escape[symbol + 1] - lt_f
        self.coder.decode_update(sy_f, lt_f, tot_f)
        self._update(symbol, True)
        return symbol


MAGIC = 'dfsm'


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    coder = RangeCoder(out_stream)
    coder.encode_start(final_byte, 1)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        data = in_stream.read_array(file_size)
        st = coder.export_enc_state()
        out_stream.write_array(native.order0_encode('defsum', data, 256,
                                                    -1, st))
        coder.import_enc_state(st)
    else:
        model = DefSumModel(coder, 257 if file_size < 0 else 256)
        util.compress_with_model(in_stream, file_size, model)
    coder.encode_finish()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    coder = RangeCoder(in_stream)
    coder.decode_start(True)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        st = coder.export_dec_state(in_stream.pos)
        out = native.order0_decode('defsum', in_stream.data, st, 256,
                                   file_size)
        in_stream.pos = coder.import_dec_state(st)
        out_stream.write(out, 0, file_size)
    else:
        model = DefSumModel(coder, 257 if file_size < 0 else 256, True)
        util.decompress_with_model(out_stream, file_size, model)
    coder.decode_finish()


compress_file = util.compress_file_helper(MAGIC, _compress_guts, True)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)
DefSumModel.MAGIC = MAGIC
DefSumModel.compress_file = staticmethod(compress_file)
DefSumModel.decompress_file = staticmethod(decompress_file)
