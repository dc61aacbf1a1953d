"""Adaptive Huffman coding (Vitter's algorithm) over a bit stream.

Behavior-compatible with the reference adaptive coder
(lib/Huffman.js:61-489): implicit-tree table with leaves
preceding internal nodes of equal weight, an escape node that admits unseen
symbols (escaped id sent LSB-first counting unmapped slots), weight
increments of 2, and scale() halving weights / pruning zero-weight leaves
when the root reaches max_weight.

Stored as parallel int arrays (struct-of-arrays) rather than the
reference's array of node objects — the natural layout for a port to a
device-resident kernel.

A copy of ``compressjs_tpu.coders.huffman``. The stand-alone order-0
codec's body is coded by the native runtime (``native.huff_encode`` /
``huff_decode``) where the input is an `ArrayInputStream` of known size
(and, to encode, the output takes whole arrays, ``write_array``);
``native_body=False``, a keyword of ``compress_file`` and
``decompress_file``, takes the Python twin, which any other stream takes
too."""

from __future__ import annotations

from .. import native
from . import util as _util
from .stream import ArrayInputStream, BitStream as _BitStream

__all__ = ['Huffman']


class Huffman:

    def __init__(self, size, root=None, bitstream=None, max_weight=None):
        assert size and isinstance(size, int)
        if not root or root > size:
            root = size
        root = root * 2 - 1 if root else 0

        n = root + 1
        self.up = [0] * n
        self.down = [0] * n
        self.symbol = [0] * n
        self.weight = [0] * n

        self.map = [0] * size
        self.size = size
        self.esc = self.root = root

        if bitstream is not None:
            self.read_bit = bitstream.read_bit
            self.write_bit = bitstream.write_bit
        self.max_weight = max_weight

    @staticmethod
    def factory(bitstream, max_weight=None):
        def make(size):
            return Huffman(size, size, bitstream, max_weight)
        return make

    # ------------------------------------------------------------------
    def _split(self, symbol):
        """Split the escape node to admit a new symbol leaf."""
        pair = self.esc
        assert pair
        self.esc -= 1

        if self.esc:
            node = self.esc
            self.down[pair] = node
            self.weight[pair] = 1
            self.up[node] = pair
            self.esc -= 1
        else:
            pair = 0
            node = 1

        self.symbol[node] = symbol
        self.weight[node] = 0
        self.down[node] = 0
        self.map[symbol] = node

        self.weight[self.esc] = 0
        self.down[self.esc] = 0
        self.up[self.esc] = pair
        return node

    def _leader(self, node):
        """Swap a leaf into its weight-group leader position."""
        weight = self.weight[node]
        leader = node
        while weight == self.weight[leader + 1]:
            leader += 1
        if leader == node:
            return node
        symbol = self.symbol[node]
        prev = self.symbol[leader]
        self.symbol[leader] = symbol
        self.symbol[node] = prev
        self.map[symbol] = leader
        self.map[prev] = node
        return leader

    def _slide(self, node):
        """Slide an internal node over equal-weight leaves, or exchange a
        leaf with the next smaller-weight internal node."""
        nxt = node + 1
        s_up, s_down = self.up[node], self.down[node]
        s_sym, s_w = self.symbol[node], self.weight[node]

        if s_w & 1:  # internal: find highest leaf to exchange with
            while s_w > self.weight[nxt + 1]:
                nxt += 1

        # swap the two nodes (up pointers keep tree positions)
        self.up[node], self.down[node] = self.up[nxt], self.down[nxt]
        self.symbol[node], self.weight[node] = self.symbol[nxt], self.weight[nxt]
        self.down[nxt], self.symbol[nxt], self.weight[nxt] = s_down, s_sym, s_w
        self.up[nxt] = self.up[node]
        self.up[node] = s_up
        # note: after the JS double-swap, node keeps its own original up
        # (swap.up) and nxt gets the up that was at node's slot pre-swap —
        # but both slots held ups that referred to tree positions, so the
        # net effect is: positions keep their parent links.
        # Reproduce exactly:
        #   table[node] <- table[next]; table[next] <- swap;
        #   table[next].up = table[node].up; table[node].up = swap.up;
        # table[node].up was set from table[next].up in the first copy.

        if s_w & 1:  # we moved an internal node to position nxt
            self.up[s_down] = nxt
            self.up[s_down - 1] = nxt
            self.map[self.symbol[node]] = node
        else:        # a leaf moved to position nxt
            d = self.down[node]
            self.up[d - 1] = node
            self.up[d] = node
            self.map[s_sym] = nxt

        return nxt

    def _increment(self, node):
        """Add 2 to a node's weight and restore the sibling property."""
        if self.up[node] == node + 1:
            self.weight[node] += 2
            node += 1
        else:
            node = self._leader(node)

        while True:
            self.weight[node] += 2
            up = self.up[node]
            if not up:
                break
            while self.weight[node] > self.weight[node + 1]:
                node = self._slide(node)
            if self.weight[node] & 1:
                node = up
            else:
                node = self.up[node]

        if self.max_weight and self.weight[self.root] >= self.max_weight:
            self.scale(1)

    def scale(self, bits):
        """Halve all weights (>> bits) and rebalance; zero-weight leaves are
        slid out and unmapped, growing the escape region."""
        node = self.esc
        while True:
            node += 1
            if node > self.root:
                break
            w = self.weight[node]
            if w & 1:
                # internal: recompute weight from (already scaled) children
                weight = self.weight[self.down[node]] & ~1
                if weight:
                    weight += self.weight[self.down[node] - 1] | 1
            else:
                weight = (w >> bits) & ~1
                if not weight:
                    # remove zero-weight leaf
                    self.map[self.symbol[node]] = 0
                    if self.esc:
                        self.esc += 2
                    else:
                        self.esc += 1
            self.weight[node] = weight
            prev = node
            while True:
                prev -= 1
                if weight < self.weight[prev]:
                    self._slide(prev)
                else:
                    break
        self.down[self.esc] = 0

    # ------------------------------------------------------------------
    def _sendid(self, symbol):
        """Send the escaped-symbol id: count of unmapped symbols before it,
        LSB-first, using just enough bits for the max possible count."""
        empty = 0
        for s in range(symbol):
            if not self.map[s]:
                empty += 1
        mx = self.size - (self.root - self.esc) // 2 - 1
        if mx:
            while True:
                self.write_bit(empty & 1)
                empty >>= 1
                mx >>= 1
                if not mx:
                    break

    def encode(self, symbol):
        assert symbol < self.size
        node = self.map[symbol]

        idx = node
        if not idx:
            idx = self.esc
            if not idx:
                return  # tree full, refuse input

        # accumulate code bits from leaf to root
        emit = 1
        while True:
            up = self.up[idx]
            if not up:
                break
            emit = (emit << 1) | (idx & 1)
            idx = up

        # send root-selector bit first
        while True:
            bit = emit & 1
            emit >>= 1
            if not emit:
                break
            self.write_bit(bit)

        if not node:
            self._sendid(symbol)
            node = self._split(symbol)

        self._increment(node)

    def _readid(self):
        empty = 0
        bit = 1
        mx = self.size - (self.root - self.esc) // 2 - 1
        if mx:
            while True:
                if self.read_bit():
                    empty |= bit
                bit <<= 1
                mx >>= 1
                if not mx:
                    break
        for symbol in range(self.size):
            if not self.map[symbol]:
                if not empty:
                    return symbol
                empty -= 1
        raise AssertionError('escaped symbol id out of range')

    def decode(self):
        node = self.root
        while True:
            down = self.down[node]
            if not down:
                break
            if self.read_bit():
                node = down - 1  # left child precedes right child
            else:
                node = down

        if node == self.esc:
            assert self.esc
            symbol = self._readid()
            node = self._split(symbol)
        else:
            symbol = self.symbol[node]

        self._increment(node)
        return symbol


# ---------------------------------------------------------------------------
# stand-alone order-0 codec, mostly for testing (reference Huffman.js:492-511)


MAGIC = 'huff'


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        out_stream.write_array(
            native.huff_encode(in_stream.read_array(file_size)))
        return
    bitstream = _BitStream(out_stream)
    alphabet_size = 257 if file_size < 0 else 256
    huff = Huffman(257, alphabet_size, bitstream, 8191)
    _util.compress_with_model(in_stream, file_size, huff)
    bitstream.flush()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        data = in_stream.read_array(in_stream.size - in_stream.pos)
        out = native.huff_decode(data, file_size)
        out_stream.write(out, 0, file_size)
        return
    bitstream = _BitStream(in_stream)
    alphabet_size = 257 if file_size < 0 else 256
    huff = Huffman(257, alphabet_size, bitstream, 8191)
    _util.decompress_with_model(out_stream, file_size, huff)


compress_file = _util.compress_file_helper(MAGIC, _compress_guts)
decompress_file = _util.decompress_file_helper(MAGIC, _decompress_guts)
Huffman.MAGIC = MAGIC
Huffman.compress_file = staticmethod(compress_file)
Huffman.decompress_file = staticmethod(decompress_file)
