"""Host-side helpers of the bzip2 encode and decode (no torch, no
device).

Copies of the JAX-free host modules of ``compressjs_tpu`` that the
device encode and decode need around their kernels: CRC, RLE1 block
packing, the block-header bit fields, the scalar Huffman length
allocator, the stream and block-header parse with the block-magic scan,
the host stages of the encoder's 'core' and 'hybrid' splits (MTF and
RLE2, the Huffman group optimisation and payload, the cyclic BWT), and
the host block decode of the parallel and mesh decoders (the inverse
BWT, the RLE1 undo).
The sequential scans among them call the native runtime (``native``)
and keep a numpy twin for the tests.  They are copied rather than
imported so that this package never loads the JAX package.
"""
