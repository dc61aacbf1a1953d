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
* `DeviceBWTCEncoder` encodes the BWTC format with each full block's
  EOF-terminated BWT on the GPU and the range coder on the host
  (``host.bwtc``, a copy of the JAX package's codec, whose
  ``BWTC.compress_file`` / ``decompress_file`` run on the host alone).
* ``parallel.mesh.sharded_bwt_eof`` and ``sharded_block_decode(...,
  eof=True)`` shard BWTC's transform and its inverse over a mesh, and
  ``parallel.sharded_sort.sharded_cyclic_suffix_sort`` splits one
  block's rotation sort over the ranks (O(n/d) on each).

* `bwtcp_compress_device` encodes the BWTC-P format (one range coder a
  block) and `bwtcl_compress_device` / `bwtcl_decompress_device` the
  lane-interleaved BWTC-L format (128 coders a block) with the whole
  block body on the GPU, the adaptive Fenwick model and the range coder
  included; `mesh_compress_bwtcp` shards BWTC-P's transforms over a
  mesh.  ``BWTCP`` and ``BWTCL`` are the host codecs (copies of the JAX
  package's).

On the host only: `decompress_file_parallel` decodes whole blocks on a
thread pool with the native block decoder.

The host stages run in a native runtime (``native``, C++ built by g++ at
first use).  Hand-written CUDA kernels carry the MTF scan, the Huffman
length allocator, the windowed map composition, the selector chase, the
MTF undo, and the Fenwick model's encode and decode scans and the range
coder's.  The package imports neither JAX nor compressjs_tpu.
"""

from .host.bwtcl import BWTCL
from .host.bwtcp import BWTCP
from .parallel.decode import (decompress_file_device, decompress_file_mesh,
                              decompress_file_parallel)
from .parallel.hetero import hetero_compress_bzip2
from .parallel.mesh import make_mesh, mesh_compress_bwtcp, mesh_compress_bzip2
from .parallel.pipeline import (DeviceBWTCEncoder, DeviceBzip2Encoder,
                                bwtcl_compress_device, bwtcl_decompress_device,
                                bwtcp_compress_device, compress_file_device)

__all__ = ['BWTCL', 'BWTCP', 'DeviceBWTCEncoder', 'DeviceBzip2Encoder',
           'bwtcl_compress_device', 'bwtcl_decompress_device',
           'bwtcp_compress_device', 'compress_file_device',
           'decompress_file_device', 'decompress_file_mesh',
           'decompress_file_parallel', 'hetero_compress_bzip2', 'make_mesh',
           'mesh_compress_bwtcp', 'mesh_compress_bzip2']
