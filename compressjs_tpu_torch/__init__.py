"""PyTorch and CUDA port of compressjs_tpu's device bzip2 encode and
decode.

`compress_file_device` encodes with the block transforms on the GPU in
one of three splits (``mode``): 'full' (the default) runs the whole
block encode there -- rotation sort, BWT, MTF, RLE2, Huffman group
optimisation, payload packing; 'core' runs sort, BWT, MTF and RLE2 there
and the Huffman stages on the host; 'hybrid' runs only the sort and BWT
there (``batch=True``: one call for all full-size blocks).  The host
stages run in a native runtime (``native``, C++ built by g++ at first
use).  `decompress_file_device` decodes with the parallel Huffman walk,
RLE2 and MTF undo, inverse BWT and RLE1 undo on the GPU.  Hand-written
CUDA kernels carry the MTF scan, the Huffman length allocator, the
windowed map composition, the selector chase and the MTF undo.  Entry
points run on 'cuda' unless the caller passes device='cpu', where each
kernel's plain version runs instead.  The package imports neither JAX
nor compressjs_tpu.
"""

from .parallel.decode import decompress_file_device
from .parallel.pipeline import DeviceBzip2Encoder, compress_file_device

__all__ = ['DeviceBzip2Encoder', 'compress_file_device',
           'decompress_file_device']
