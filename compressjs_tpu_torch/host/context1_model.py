"""Order-1 wrapper: one sub-model per previous-symbol context
(reference lib/Context1Model.js:5-18).

A copy of ``compressjs_tpu.models.context1_model``. The body is coded by
the native runtime (``native.ctx1_encode`` / ``ctx1_decode``) where the
input is an `ArrayInputStream` of known size (and, to encode, the output
takes whole arrays, ``write_array``); ``native_body=False``, a keyword
of ``compress_file`` and ``decompress_file``, takes the Python twin,
which any other stream takes too."""

from __future__ import annotations

from .. import native
from .huffman import Huffman
from . import util
from .stream import ArrayInputStream, BitStream


class Context1Model:

    def __init__(self, model_factory, context_size, alphabet_size):
        # no context needed for an EOF symbol, hence context_size may be
        # smaller than alphabet_size
        self.literal_model = [model_factory(alphabet_size)
                              for _ in range(context_size)]

    def encode(self, ch, context):
        self.literal_model[context].encode(ch)

    def decode(self, context):
        return self.literal_model[context].decode()


MAGIC = 'ctx1'


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)
            and hasattr(out_stream, 'write_array')):
        out_stream.write_array(
            native.ctx1_encode(in_stream.read_array(file_size)))
        return
    bitstream = BitStream(out_stream)
    alphabet_size = 257 if file_size < 0 else 256
    coder = Huffman.factory(bitstream, 8191)
    model = Context1Model(coder, 256, alphabet_size)
    state = {'last': 0x20}

    class _P:
        @staticmethod
        def encode(symbol):
            model.encode(symbol, state['last'])
            state['last'] = symbol

    util.compress_with_model(in_stream, file_size, _P)
    bitstream.flush()


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    if (native_body and file_size >= 0
            and isinstance(in_stream, ArrayInputStream)):
        data = in_stream.read_array(in_stream.size - in_stream.pos)
        out = native.ctx1_decode(data, file_size)
        out_stream.write(out, 0, file_size)
        return
    bitstream = BitStream(in_stream)
    alphabet_size = 257 if file_size < 0 else 256
    coder = Huffman.factory(bitstream, 8191)
    model = Context1Model(coder, 256, alphabet_size)
    state = {'last': 0x20}

    class _P:
        @staticmethod
        def decode():
            symbol = model.decode(state['last'])
            state['last'] = symbol
            return symbol

    util.decompress_with_model(out_stream, file_size, _P)


compress_file = util.compress_file_helper(MAGIC, _compress_guts)
decompress_file = util.decompress_file_helper(MAGIC, _decompress_guts)
Context1Model.MAGIC = MAGIC
Context1Model.compress_file = staticmethod(compress_file)
Context1Model.decompress_file = staticmethod(decompress_file)
