"""Dynamic Markov Compression, byte-oriented states.

Format-compatible with the reference (lib/Dmc.js):
'dmc!' magic, MIN_CNT1/MIN_CNT2 split thresholds as header varints,
256/257 fully-connected initial states each carrying its own MTF emission
model, node cloning with proportional count redistribution, and —
faithfully — no model shrinking (unbounded growth on large inputs).

A copy of ``compressjs_tpu.codecs.dmc``. The body is coded by the native
runtime (``native.dmc_encode`` / ``dmc_decode``) where the input is an
`ArrayInputStream` of known size (and, to encode, the output takes whole
arrays, ``write_array``); ``native_body=False``, a keyword of
``compress_file`` and ``decompress_file``, takes the Python twin, which
any other stream takes too."""

from __future__ import annotations

from .. import native
from .range_coder import RangeCoder
from .mtf_model import MTFModel
from . import util
from .stream import ArrayInputStream

MAGIC = 'dmc!'
MAX_TRANS_CNT = 0xFFFF
DEFAULT_MIN_CNT1 = 8
DEFAULT_MIN_CNT2 = 128
MODEL_PROB_MAX = 0xFF00
MODEL_PROB_INCR = 0x0100
CLONE_MODELS = False


class _MarkovNode:
    __slots__ = ('out', 'model', 'count', 'sum')

    def __init__(self, coder, size, opt_model=None):
        self.out = [None] * size
        self.model = opt_model.clone() if opt_model is not None else \
            MTFModel(coder, size, MODEL_PROB_MAX, MODEL_PROB_INCR)
        self.count = [0] * size
        self.sum = 0

    def clone_node(self, coder, size):
        node = _MarkovNode(coder, size,
                           self.model if CLONE_MODELS else None)
        node.out = list(self.out)
        return node


class MarkovModel:

    def __init__(self, coder, size, min_cnt1=None, min_cnt2=None):
        self.coder = coder
        self.size = size
        self.min_cnt1 = min_cnt1 or DEFAULT_MIN_CNT1
        self.min_cnt2 = min_cnt2 or DEFAULT_MIN_CNT2
        self.nodes = [_MarkovNode(coder, size) for _ in range(size)]
        for node in self.nodes:
            node.out = list(self.nodes)
        self.current = self.nodes[0]

    def _maybe_split(self, from_node, symbol, to):
        trans_cnt = from_node.count[symbol]
        next_cnt = to.sum
        if (trans_cnt <= self.min_cnt1
                or next_cnt - trans_cnt <= self.min_cnt2):
            return to
        # clone, redistributing counts proportionally (integer division as
        # in the reference's float-then-store-to-U16 arithmetic)
        new_node = to.clone_node(self.coder, self.size)
        self.nodes.append(new_node)
        from_node.out[symbol] = new_node
        new_node.sum = to.sum = 0
        for i in range(self.size):
            share = int(to.count[i] * trans_cnt / next_cnt)
            new_node.count[i] = share
            new_node.sum += share
            to.count[i] -= share
            to.sum += to.count[i]
        return new_node

    def _advance(self, symbol):
        from_node = self.current
        to = from_node.out[symbol]
        if from_node.count[symbol] != MAX_TRANS_CNT:
            from_node.count[symbol] += 1
            from_node.sum += 1
        self.current = self._maybe_split(from_node, symbol, to)

    def encode(self, symbol):
        self.current.model.encode(symbol)
        self._advance(symbol)

    def decode(self):
        symbol = self.current.model.decode()
        self._advance(symbol)
        return symbol


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    min_cnt1, min_cnt2 = DEFAULT_MIN_CNT1, DEFAULT_MIN_CNT2
    if isinstance(props, dict):
        min_cnt1 = int(props.get('m', 0)) or DEFAULT_MIN_CNT1
        min_cnt2 = int(props.get('n', 0)) or DEFAULT_MIN_CNT2
    util.write_unsigned_number(out_stream, min_cnt1)
    util.write_unsigned_number(out_stream, min_cnt2)

    coder = RangeCoder(out_stream)
    coder.encode_start(0xCA, 0)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        data = in_stream.read_array(file_size)
        st = coder.export_enc_state()
        out_stream.write_array(native.dmc_encode(data, 256, -1,
                                                 min_cnt1, min_cnt2, st))
        coder.import_enc_state(st)
        coder.encode_finish()
        return
    mm = MarkovModel(coder, 257 if file_size < 0 else 256,
                     min_cnt1, min_cnt2)
    util.compress_with_model(in_stream, file_size, mm)
    coder.encode_finish()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    min_cnt1 = util.read_unsigned_number(in_stream)
    min_cnt2 = util.read_unsigned_number(in_stream)
    coder = RangeCoder(in_stream)
    coder.decode_start()
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        st = coder.export_dec_state(in_stream.pos)
        out = native.dmc_decode(in_stream.data, st, 256,
                                min_cnt1, min_cnt2, file_size)
        in_stream.pos = coder.import_dec_state(st)
        out_stream.write(out, 0, file_size)
        coder.decode_finish()
        return
    mm = MarkovModel(coder, 257 if file_size < 0 else 256,
                     min_cnt1, min_cnt2)
    util.decompress_with_model(out_stream, file_size, mm)
    coder.decode_finish()


compress_file = util.compress_file_helper(MAGIC, _compress_guts)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)


class Dmc:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
