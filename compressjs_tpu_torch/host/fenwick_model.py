"""Adaptive order-0 model with escape over an implicit complete binary tree
in heap layout (leaves at [num_syms, 2 num_syms)), a copy of
``compressjs_tpu.models.fenwick_model``.

Each uint32 node packs the escape probability (low 16 bits) and the
symbol probability (high 16 bits); unseen symbols carry esc = 1; encode
walks leaf -> root summing lt_f from left siblings while it applies the
update; decode walks root -> leaf; a rescale halves the leaves,
re-escaping zeros.  The BWTC codec codes its block bodies with it above
level 5 (natively in ``cz_bwtc_encode_block``; this class is that
loop's twin).

The stand-alone order-0 codec (``compress_file``, ``decompress_file``)
codes its body in the native runtime (``native.order0_fenwick_encode`` /
``order0_fenwick_decode``) where the input is an `ArrayInputStream` of
known size (and, to encode, the output takes whole arrays);
``native_body=False`` takes the Python model, which any other stream
takes too."""

from __future__ import annotations

from .. import native
from .range_coder import RangeCoder
from .stream import ArrayInputStream
from . import util

DEFAULT_MAX_PROB = 0xFF00
DEFAULT_INCREMENT = 0x0100

ESC_MASK, ESC_SHIFT = 0x0000FFFF, 0
SYM_MASK, SYM_SHIFT = 0xFFFF0000, 16
SCALE_MASK = 0xFFFEFFFE
U32 = 0xFFFFFFFF


class FenwickModel:

    def __init__(self, coder, size, max_prob=None, increment=None):
        self.coder = coder
        self.num_syms = size + 1  # +1 for the escape symbol
        self.tree = [0] * (self.num_syms * 2)
        self.increment = increment or DEFAULT_INCREMENT
        self.max_prob = max_prob or DEFAULT_MAX_PROB
        assert (self.max_prob + (self.increment - 1)) <= 0xFFFF
        assert size <= 0xFFFF
        for i in range(size):
            self.tree[self.num_syms + i] = (1 << ESC_SHIFT)  # esc=1, sym=0
        self.tree[self.num_syms + size] = (self.increment << SYM_SHIFT)
        self._sum_tree()

    @staticmethod
    def factory(coder, max_prob=None, increment=None):
        def make(size):
            return FenwickModel(coder, size, max_prob, increment)
        return make

    def clone(self):
        m = FenwickModel(self.coder, self.num_syms - 1,
                         self.max_prob, self.increment)
        m.tree[1:] = self.tree[1:]
        return m

    def encode(self, symbol):
        tree = self.tree
        i = self.num_syms + symbol
        sy_f = tree[i]
        mask, shift = SYM_MASK, SYM_SHIFT
        update = (self.increment << SYM_SHIFT)

        if (sy_f & SYM_MASK) == 0:  # escape!
            self.encode(self.num_syms - 1)
            mask, shift = ESC_MASK, ESC_SHIFT
            update -= (1 << ESC_SHIFT)
        elif (symbol == self.num_syms - 1 and
              ((tree[1] & ESC_MASK) >> ESC_SHIFT) == 1):
            # last escape: zero it out
            update = -tree[i]

        lt_f = 0
        while i > 1:
            parent = i >> 1
            if i & 1:  # right child adds left sibling's prob
                lt_f += tree[2 * parent]
            tree[i] = (tree[i] + update) & U32
            i = parent
        tot_f = tree[1]
        tree[1] = (tree[1] + update) & U32
        sy_f = (sy_f & mask) >> shift
        lt_f = (lt_f & mask) >> shift
        tot_f = (tot_f & mask) >> shift
        self.coder.encode_freq(sy_f, lt_f, tot_f)
        if ((tree[1] & SYM_MASK) >> SYM_SHIFT) >= self.max_prob:
            self._rescale()

    def _decode(self, is_escape):
        tree = self.tree
        mask, shift = SYM_MASK, SYM_SHIFT
        update = (self.increment << SYM_SHIFT)
        if is_escape:
            mask, shift = ESC_MASK, ESC_SHIFT
            update -= (1 << ESC_SHIFT)
        tot_f = (tree[1] & mask) >> shift
        prob = self.coder.decode_cul_freq(tot_f)
        i = 1
        lt_f = 0
        while i < self.num_syms:
            tree[i] = (tree[i] + update) & U32
            left_prob = (tree[2 * i] & mask) >> shift
            i *= 2
            if (prob - lt_f) >= left_prob:
                lt_f += left_prob
                i += 1
        symbol = i - self.num_syms
        sy_f = (tree[i] & mask) >> shift
        tree[i] = (tree[i] + update) & U32
        self.coder.decode_update(sy_f, lt_f, tot_f)
        if (symbol == self.num_syms - 1 and
                ((tree[1] & ESC_MASK) >> ESC_SHIFT) == 1):
            update = -tree[i]
            while i >= 1:
                tree[i] = (tree[i] + update) & U32
                i >>= 1
        if ((tree[1] & SYM_MASK) >> SYM_SHIFT) >= self.max_prob:
            self._rescale()
        return symbol

    def decode(self):
        symbol = self._decode(False)
        if symbol == self.num_syms - 1:
            symbol = self._decode(True)
        return symbol

    def _rescale(self):
        tree = self.tree
        no_escape = True
        for i in range(self.num_syms - 1):
            prob = tree[self.num_syms + i]
            if (prob & ESC_MASK) != 0:
                no_escape = False
                continue
            prob = (prob & SCALE_MASK) >> 1
            if prob == 0:  # newly escapes
                prob = (1 << ESC_SHIFT)
                no_escape = False
            tree[self.num_syms + i] = prob
        # scale the escape symbol itself
        i = self.num_syms - 1
        prob = (tree[self.num_syms + i] & SCALE_MASK) >> 1
        if no_escape:
            prob = 0
        elif prob == 0:
            prob = (1 << SYM_SHIFT)
        tree[self.num_syms + i] = prob
        self._sum_tree()

    def _sum_tree(self):
        tree = self.tree
        for i in range(self.num_syms - 1, 0, -1):
            tree[i] = (tree[2 * i] + tree[2 * i + 1]) & U32


MAGIC = 'fenw'


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    coder = RangeCoder(out_stream)
    coder.encode_start(final_byte, 1)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        data = in_stream.read_array(file_size)
        st = coder.export_enc_state()
        payload = native.order0_fenwick_encode(data, 256, -1, st)
        out_stream.write_array(payload)
        coder.import_enc_state(st)
    else:
        model = FenwickModel(coder, 257 if file_size < 0 else 256)
        util.compress_with_model(in_stream, file_size, model)
    coder.encode_finish()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    coder = RangeCoder(in_stream)
    coder.decode_start(True)
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        st = coder.export_dec_state(in_stream.pos)
        out = native.order0_fenwick_decode(in_stream.data, st, 256,
                                           file_size)
        in_stream.pos = coder.import_dec_state(st)
        out_stream.write(out, 0, file_size)
    else:
        model = FenwickModel(coder, 257 if file_size < 0 else 256)
        util.decompress_with_model(out_stream, file_size, model)
    coder.decode_finish()


compress_file = util.compress_file_helper(MAGIC, _compress_guts, True)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)
FenwickModel.MAGIC = MAGIC
FenwickModel.compress_file = staticmethod(compress_file)
FenwickModel.decompress_file = staticmethod(decompress_file)
