"""PyTorch and CUDA port of compressjs_tpu's all-device bzip2 encode.

The block encode (rotation sort, BWT, MTF, RLE2, Huffman group
optimisation, payload packing) runs as tensor code on the GPU, with
hand-written CUDA kernels for the MTF scan and the Huffman length
allocator.  Entry points run on 'cuda' unless the caller passes
device='cpu', where each kernel's plain version runs instead.  The
package imports neither JAX nor compressjs_tpu.
"""

from .parallel.pipeline import DeviceBzip2Encoder, compress_file_device

__all__ = ['DeviceBzip2Encoder', 'compress_file_device']
