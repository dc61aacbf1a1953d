"""The entropy coders under the JAX package's import path
(``compressjs_tpu.coders``): re-exports of ``host``."""

from ..host.dummy_range_coder import DummyRangeCoder
from ..host.huffman import Huffman
from ..host.huffman_allocator import allocate_huffman_code_lengths
from ..host.range_coder import RangeCoder

__all__ = ['DummyRangeCoder', 'Huffman', 'RangeCoder',
           'allocate_huffman_code_lengths']
