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

The JAX package's namespace, on the host (``host``, copies of its
codecs, coders and models): the classes `Stream`, `BitStream`, `BWT`,
`RangeCoder`, `DummyRangeCoder`, `Huffman`, `HuffmanAllocator`,
`MTFModel`, `FenwickModel`, `DefSumModel`, `Context1Model`, `NoModel`,
`LogDistanceModel` and `DeflateDistanceModel`, and the codecs `Bzip2`,
`BWTC`, `BWTCP`, `Lzp3`, `Lzjb`, `LzjbR`, `PPM`, `Dmc` and `Simple`
(loaded at first use), each with ``compress_file`` / ``decompress_file``
byte for byte the JAX package's.  The subpackages `coders`, `models`
and `utils` re-export them under the JAX package's import paths.
``python -m compressjs_tpu_torch.cli`` is its command line, with the
bzip2, BWTC and BWTC-P encodes on the card (``--device``).

The host stages run in a native runtime (``native``, C++ built by g++ at
first use).  Hand-written CUDA kernels carry the MTF scan, the Huffman
length allocator, the windowed map composition, the selector chase, the
MTF undo, and the Fenwick model's encode and decode scans and the range
coder's.  The package imports neither JAX nor compressjs_tpu.
"""

__version__ = '0.1.0'

from .host import bwt as BWT
from .host import huffman_allocator as HuffmanAllocator
from .host.bwtcl import BWTCL
from .host.bwtcp import BWTCP
from .host.context1_model import Context1Model
from .host.defsum_model import DefSumModel
from .host.deflate_distance_model import DeflateDistanceModel
from .host.dummy_range_coder import DummyRangeCoder
from .host.fenwick_model import FenwickModel
from .host.huffman import Huffman
from .host.log_distance_model import LogDistanceModel
from .host.mtf_model import MTFModel
from .host.no_model import NoModel
from .host.range_coder import RangeCoder
from .host.stream import BitStream, Stream
from .parallel.decode import (decompress_file_device, decompress_file_mesh,
                              decompress_file_parallel)
from .parallel.hetero import hetero_compress_bzip2
from .parallel.mesh import make_mesh, mesh_compress_bwtcp, mesh_compress_bzip2
from .parallel.pipeline import (DeviceBWTCEncoder, DeviceBzip2Encoder,
                                bwtcl_compress_device, bwtcl_decompress_device,
                                bwtcp_compress_device, compress_file_device)

version = __version__

# the codecs load at first use (``__getattr__``), as in the JAX package
_CODEC_MODULES = {
    'Bzip2': '.host.bzip2',
    'BWTC': '.host.bwtc',
    'Lzp3': '.host.lzp3',
    'Lzjb': '.host.lzjb',
    'LzjbR': '.host.lzjbr',
    'PPM': '.host.ppm',
    'Dmc': '.host.dmc',
    'Simple': '.host.simple',
}

__all__ = ['BWT', 'BWTC', 'BWTCL', 'BWTCP', 'BitStream', 'Bzip2',
           'Context1Model', 'DefSumModel', 'DeflateDistanceModel',
           'DeviceBWTCEncoder', 'DeviceBzip2Encoder', 'Dmc',
           'DummyRangeCoder', 'FenwickModel', 'Huffman', 'HuffmanAllocator',
           'LogDistanceModel', 'Lzjb', 'LzjbR', 'Lzp3', 'MTFModel',
           'NoModel', 'PPM', 'RangeCoder', 'Simple', 'Stream',
           'bwtcl_compress_device', 'bwtcl_decompress_device',
           'bwtcp_compress_device', 'compress_file_device',
           'decompress_file_device', 'decompress_file_mesh',
           'decompress_file_parallel', 'hetero_compress_bzip2', 'make_mesh',
           'mesh_compress_bwtcp', 'mesh_compress_bzip2', 'version']


def __getattr__(name):
    if name in _CODEC_MODULES:
        import importlib
        obj = getattr(importlib.import_module(_CODEC_MODULES[name],
                                              __name__), name)
        globals()[name] = obj
        return obj
    raise AttributeError(name)


def __dir__():
    return sorted(set(globals()) | set(_CODEC_MODULES))
