"""PPM with method-D-style escapes and full exclusion.

Format-compatible with the reference (lib/PPM.js):
'ppm2' magic, MAX_CONTEXT=5, 256 KiB sliding window primed with 'cSaCsA',
per-context dense MTF models with escape/exclusion, order -1 uniform
coder with exclusion, half-increment updates on contexts >= match level,
refcounted context GC as the window slides.

A copy of ``compressjs_tpu.codecs.ppm``. The body is coded by the native
runtime (``native.ppm_encode`` / ``ppm_decode``) where the input is an
`ArrayInputStream` of known size (and, to encode, the output takes whole
arrays, ``write_array``); ``native_body=False``, a keyword of
``compress_file`` and ``decompress_file``, takes the Python twin, which
any other stream takes too."""

from __future__ import annotations

from .. import native
from .range_coder import RangeCoder
from . import util
from .stream import ArrayInputStream

MAGIC = 'ppm2'
MAX_CONTEXT = 5
LOG_WINDOW_SIZE = 18
WINDOW_SIZE = 1 << LOG_WINDOW_SIZE
DMM_INCREMENT = 0x100
DMM_MAX_PROB = 0xFF00


class _Window:
    def __init__(self):
        self.buffer = bytearray(WINDOW_SIZE)
        self.pos = 0
        self.first_pass = True
        for i in range(MAX_CONTEXT):
            self.put(ord('cSaCsA'[i % 6]))

    def put(self, byte):
        # the reference stores into a Uint8Array, so the EOF symbol (256)
        # wraps to 0 in the window
        self.buffer[self.pos] = byte & 0xFF
        self.pos += 1
        if self.pos >= WINDOW_SIZE:
            self.pos = 0
            self.first_pass = False
        return byte

    def get(self, pos):
        return self.buffer[pos & (WINDOW_SIZE - 1)]

    def context(self, pos, n):
        """The n bytes ending just before pos, as a bytes key."""
        pos = (pos - n) & (WINDOW_SIZE - 1)
        out = bytearray(n)
        for i in range(n):
            out[i] = self.buffer[pos]
            pos += 1
            if pos >= WINDOW_SIZE:
                pos = 0
        return bytes(out)


class _DenseMTFModel:
    """Per-context MTF model with escape and exclusion support
    (reference PPM.js:67-232)."""

    __slots__ = ('sym', 'prob', 'refcount', 'size', 'coder')

    def __init__(self, coder, size):
        self.coder = coder
        self.size = size
        self.sym = [size]                 # escape
        self.prob = [0, DMM_INCREMENT]
        self.refcount = 0

    def _rescale(self):
        size = self.size
        seen = len(self.sym)
        total = 0
        j = 0
        no_escape = True
        for i in range(seen):
            sym = self.sym[i]
            sy_f = (self.prob[i + 1] - self.prob[i]) >> 1
            if sy_f > 0:
                if sym == size:
                    no_escape = False
                self.sym[j] = sym
                self.prob[j] = total
                j += 1
                total += sy_f
        self.prob[j] = total
        del self.sym[j:]
        del self.prob[j + 1:]
        if no_escape and len(self.sym) < size:
            total = self._update(size, len(self.sym), 0, 1)
        return total

    def update(self, symbol, incr):
        for i, s in enumerate(self.sym):
            if s == symbol:
                return self._update(symbol, i,
                                    self.prob[i + 1] - self.prob[i], incr)
        return self._update(symbol, len(self.sym), 0, incr)

    def _update(self, symbol, index, sy_f, incr):
        seen = len(self.sym)
        j = index
        while j < seen - 1:
            self.sym[j] = self.sym[j + 1]
            self.prob[j] = self.prob[j + 1] - sy_f
            j += 1
        if index < seen:
            self.sym[j] = symbol
            self.prob[j] = self.prob[j + 1] - sy_f
            self.prob[seen] = tot_f = self.prob[seen] + incr
        else:
            tot_f = self.prob[seen]
            self.sym.append(symbol)
            self.prob.append(tot_f + incr)
            self.prob[index] = tot_f
            tot_f += incr
            seen += 1
            # if the table just filled, drop the escape
            if len(self.sym) > self.size:
                for i in range(seen):
                    if self.sym[i] == self.size:
                        self._update(self.size, i,
                                     self.prob[i + 1] - self.prob[i], -1)
                        self.sym.pop()
                        self.prob.pop()
                        tot_f = self.prob[-1]
                        break
        if tot_f >= DMM_MAX_PROB:
            tot_f = self._rescale()
        return tot_f

    def encode(self, symbol, exclude, exclude_total):
        coder = self.coder
        seen = len(self.sym)
        ex_seen = 0
        ex_tot_f = 0
        for i in range(seen - 1, -1, -1):
            lt_f = self.prob[i]
            sy_f = self.prob[i + 1] - lt_f
            if symbol == self.sym[i]:
                # found; subtract excluded probability below it
                ex_lt_f = 0
                j = i - 1
                while j >= 0 and ex_seen < exclude_total[0]:
                    if exclude[self.sym[j]]:
                        ex_seen += 1
                        f = self.prob[j + 1] - self.prob[j]
                        ex_lt_f += f
                        ex_tot_f += f
                    j -= 1
                tot_f = self.prob[seen]
                coder.encode_freq(sy_f, lt_f - ex_lt_f, tot_f - ex_tot_f)
                if symbol == self.size:  # escape: update table now
                    self._update(symbol, i, sy_f, DMM_INCREMENT // 2)
                    return False
                return True  # character coded; update deferred
            elif exclude[self.sym[i]]:
                ex_seen += 1
                ex_tot_f += sy_f
        # symbol not present: code an escape, extend exclusion set
        self.encode(self.size, exclude, exclude_total)
        assert self.sym[-1] == self.size
        for s in self.sym[:-1]:
            if not exclude[s]:
                exclude[s] = True
                exclude_total[0] += 1
        return None

    def decode(self, exclude, exclude_total):
        coder = self.coder
        seen = len(self.sym)
        tot_f = self.prob[seen]
        ex_seen = 0
        ex_tot_f = 0
        i = seen - 1
        while i >= 0 and ex_seen < exclude_total[0]:
            if exclude[self.sym[i]]:
                ex_seen += 1
                ex_tot_f += self.prob[i + 1] - self.prob[i]
            i -= 1
        prob = coder.decode_cul_freq(tot_f - ex_tot_f) + ex_tot_f
        ex_lt_f = ex_tot_f
        for i in range(seen - 1, -1, -1):
            if exclude[self.sym[i]]:
                f = self.prob[i + 1] - self.prob[i]
                ex_lt_f -= f
                prob -= f
            elif self.prob[i] <= prob:
                break
        assert i >= 0
        symbol = self.sym[i]
        lt_f = self.prob[i]
        sy_f = self.prob[i + 1] - lt_f
        coder.decode_update(sy_f, lt_f - ex_lt_f, tot_f - ex_tot_f)
        if symbol < self.size:
            return symbol  # update deferred
        # escape
        self._update(symbol, i, sy_f, DMM_INCREMENT // 2)
        assert self.sym[-1] == self.size
        for s in self.sym[:-1]:
            if not exclude[s]:
                exclude[s] = True
                exclude_total[0] += 1
        return -1


class PPMModel:

    def __init__(self, coder, size):
        self.coder = coder
        self.size = size
        self.window = _Window()
        self.contexts = {}
        # prime the initial contexts (reference PPM.js:242-251)
        for i in range(MAX_CONTEXT):
            for j in range(i + 1):
                cc = self.window.context(j + (MAX_CONTEXT - 1 - i), j)
                if cc not in self.contexts:
                    self.contexts[cc] = _DenseMTFModel(coder, size)
                self.contexts[cc].refcount += 1

    # order -1 uniform coder with exclusion (reference Cm1Context)
    def _cm1_encode(self, symbol, exclude, exclude_total):
        lt_f = 0
        for i in range(symbol):
            if not exclude[i]:
                lt_f += 1
        tot_f = self.size - exclude_total[0]
        self.coder.encode_freq(1, lt_f, tot_f)

    def _cm1_decode(self, exclude, exclude_total):
        tot_f = self.size - exclude_total[0]
        symbol = lt_f = self.coder.decode_cul_freq(tot_f)
        i = 0
        while i <= symbol:
            if exclude[i]:
                symbol += 1
            i += 1
        self.coder.decode_update(1, lt_f, tot_f)
        return symbol

    def _update(self, symbol, context_string, match_level):
        # update/refcount all context lengths 0..MAX_CONTEXT
        for c in range(MAX_CONTEXT + 1):
            cc = context_string[MAX_CONTEXT - c:]
            model = self.contexts.get(cc)
            if model is None:
                model = self.contexts[cc] = _DenseMTFModel(self.coder,
                                                           self.size)
            if c >= match_level:
                model.update(symbol, DMM_INCREMENT // 2)
            model.refcount += 1
        # GC contexts sliding out of the window
        context_string = self.window.context(self.window.pos + MAX_CONTEXT,
                                             MAX_CONTEXT)
        if not self.window.first_pass:
            for c in range(MAX_CONTEXT, -1, -1):
                cc = context_string[:c]
                model = self.contexts[cc]
                model.refcount -= 1
                if model.refcount <= 0:
                    assert cc != b''  # never GC context-0
                    del self.contexts[cc]
        self.window.put(symbol)

    def encode(self, symbol):
        context_string = self.window.context(self.window.pos, MAX_CONTEXT)
        exclude = [False] * (self.size + 1)
        exclude_total = [0]
        for c in range(MAX_CONTEXT, -1, -1):
            cc = context_string[MAX_CONTEXT - c:]
            model = self.contexts.get(cc)
            if model is not None:
                success = model.encode(symbol, exclude, exclude_total)
                if success:
                    self._update(symbol, context_string, c)
                    return
        self._cm1_encode(symbol, exclude, exclude_total)
        # match level -1: every context level gets the symbol update
        self._update(symbol, context_string, -1)

    def decode(self):
        context_string = self.window.context(self.window.pos, MAX_CONTEXT)
        exclude = [False] * (self.size + 1)
        exclude_total = [0]
        for c in range(MAX_CONTEXT, -1, -1):
            cc = context_string[MAX_CONTEXT - c:]
            model = self.contexts.get(cc)
            if model is not None:
                symbol = model.decode(exclude, exclude_total)
                if symbol >= 0:
                    self._update(symbol, context_string, c)
                    return symbol
        symbol = self._cm1_decode(exclude, exclude_total)
        self._update(symbol, context_string, -1)
        return symbol


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    coder = RangeCoder(out_stream)
    coder.encode_start(final_byte, 1)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        data = in_stream.read_array(file_size)
        st = coder.export_enc_state()
        out_stream.write_array(native.ppm_encode(data, 256, -1, st))
        coder.import_enc_state(st)
        coder.encode_finish()
        return
    model = PPMModel(coder, 257 if file_size < 0 else 256)
    util.compress_with_model(in_stream, file_size, model)
    coder.encode_finish()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    coder = RangeCoder(in_stream)
    coder.decode_start(True)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        st = coder.export_dec_state(in_stream.pos)
        out = native.ppm_decode(in_stream.data, st, 256, file_size)
        in_stream.pos = coder.import_dec_state(st)
        out_stream.write(out, 0, file_size)
        coder.decode_finish()
        return
    model = PPMModel(coder, 257 if file_size < 0 else 256)
    util.decompress_with_model(out_stream, file_size, model)
    coder.decode_finish()


compress_file = util.compress_file_helper(MAGIC, _compress_guts, True)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)


class PPM:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
