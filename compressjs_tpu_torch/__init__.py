"""PyTorch and CUDA port of compressjs_tpu's device bzip2 encode and
decode.

On the card (each takes ``device='cuda'``, or a mesh built with it, and
raises without a card unless the caller passes ``'cpu'``, where each
kernel's plain version runs instead):

* `compress_file_device` encodes with the block transforms on the GPU in
  one of three splits (``mode``): 'full' (the default) runs the whole
  block encode there -- rotation sort, BWT, MTF, RLE2, Huffman group
  optimisation, payload packing; 'core' runs sort, BWT, MTF and RLE2
  there and the Huffman stages on the host; 'hybrid' runs only the sort
  and BWT there (``batch=True``: one call for all full-size blocks).
* `hetero_compress_bzip2` encodes with host workers and a device worker
  (``DeviceBzip2Encoder``) draining one block queue from its two ends.
* `mesh_compress_bzip2` shards the blocks' whole encode over a
  `make_mesh` mesh (``torch.distributed``: one process per card).
* `decompress_file_device` decodes with the parallel Huffman walk, RLE2
  and MTF undo, inverse BWT and RLE1 undo on the GPU.
* `decompress_file_mesh` decodes each block's symbols on host threads
  (``entropy='host'``) or on the card (``'device'``) and shards the
  inverse BWTs over a mesh.

On the host only: `decompress_file_parallel` decodes whole blocks on a
thread pool with the native block decoder.

The host stages run in a native runtime (``native``, C++ built by g++ at
first use).  Hand-written CUDA kernels carry the MTF scan, the Huffman
length allocator, the windowed map composition, the selector chase and
the MTF undo.  The package imports neither JAX nor compressjs_tpu.
"""

from .parallel.decode import (decompress_file_device, decompress_file_mesh,
                              decompress_file_parallel)
from .parallel.hetero import hetero_compress_bzip2
from .parallel.mesh import make_mesh, mesh_compress_bzip2
from .parallel.pipeline import DeviceBzip2Encoder, compress_file_device

__all__ = ['DeviceBzip2Encoder', 'compress_file_device',
           'decompress_file_device', 'decompress_file_mesh',
           'decompress_file_parallel', 'hetero_compress_bzip2', 'make_mesh',
           'mesh_compress_bzip2']
