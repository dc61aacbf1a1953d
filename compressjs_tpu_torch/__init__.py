"""PyTorch and CUDA port of compressjs_tpu's all-device bzip2 encode and
decode.

The block encode (rotation sort, BWT, MTF, RLE2, Huffman group
optimisation, payload packing) and the block decode (parallel Huffman
walk, RLE2 and MTF undo, inverse BWT, RLE1 undo) run as tensor code on
the GPU, with hand-written CUDA kernels for the MTF scan, the Huffman
length allocator, the windowed map composition and the selector chase.
Entry points run on 'cuda' unless the caller passes device='cpu', where
each kernel's plain version runs instead.  The package imports neither
JAX nor compressjs_tpu.
"""

from .parallel.decode import decompress_file_device
from .parallel.pipeline import DeviceBzip2Encoder, compress_file_device

__all__ = ['DeviceBzip2Encoder', 'compress_file_device',
           'decompress_file_device']
