"""Host-side helpers of the bzip2 encode (no torch, no device).

Copies of the JAX-free host modules of ``compressjs_tpu`` that the
device encode needs around its kernels: CRC, RLE1 block packing, the
block-header bit fields and the scalar Huffman length allocator.  They
are copied rather than imported so that this package never loads the
JAX package.
"""
