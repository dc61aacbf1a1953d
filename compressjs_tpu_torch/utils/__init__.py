"""Streams, CRCs and helpers under the JAX package's import path
(``compressjs_tpu.utils``): re-exports of ``host``, with its modules
``crc32``, ``freeze``, ``stream`` and ``util`` as attributes."""

from ..host import crc32, freeze, stream, util
from ..host.crc32 import CRC32, crc32_bzip2, stream_crc_combine
from ..host.stream import (EOF, ArrayInputStream, BitStream, BufferStream,
                           Stream, coerce_input_stream, coerce_output_stream)

__all__ = ['ArrayInputStream', 'BitStream', 'BufferStream', 'CRC32', 'EOF',
           'Stream', 'coerce_input_stream', 'coerce_output_stream', 'crc32',
           'crc32_bzip2', 'freeze', 'stream', 'stream_crc_combine', 'util']
