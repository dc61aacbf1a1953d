"""Host-side helpers of the bzip2 encode and decode (no torch, no
device).

Copies of the JAX-free host modules of ``compressjs_tpu`` that the
device encode and decode need around their kernels: CRC, RLE1 block
packing, the block-header bit fields, the scalar Huffman length
allocator, and the stream and block-header parse with the block-magic
scan.  They are copied rather than imported so that this package never
loads the JAX package.
"""
