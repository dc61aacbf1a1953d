"""Host-side helpers of the bzip2 encode and decode and the BWTC codec
(no torch, no device).

Copies of the JAX-free host modules of ``compressjs_tpu`` that the
device encode and decode need around their kernels: CRC, RLE1 block
packing, the block-header bit fields, the scalar Huffman length
allocator, the stream and block-header parse with the block-magic scan,
the host stages of the encoder's 'core' and 'hybrid' splits (MTF and
RLE2, the Huffman group optimisation and payload, the cyclic BWT), and
the host block decode of the parallel and mesh decoders (the inverse
BWT, the RLE1 undo); and the BWTC codec (`bwtc`) with what it calls:
the range coder, the four models, MTF, the zero-run digits, the
EOF-terminated BWT (in `bwt`), the streams and the container helpers;
and the rest of the JAX package's public layer: the `Bzip2` codec class
(`bzip2`), the codecs LZP3, LZJB, LZJB-R, PPM, DMC and Simple, the
adaptive Huffman coder, the MTF-list, order-1 and deflate-distance
models, the dummy coder, the incremental `CRC32` (`crc32`) and
`freeze`.  The sequential scans among them call the
native runtime (``native``) and keep a numpy or Python twin for the
tests (a codec's ``native_body=False``).  They are copied rather than
imported so that this package never loads the JAX package.
"""
