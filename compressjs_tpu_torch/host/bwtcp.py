"""The BWTC-P codec on the host (a copy of ``compressjs_tpu.codecs.bwtcp``):
BWTC's block pipeline with one independent range coder per block, so
that blocks encode and decode in parallel.

Each block is the BWTC body: the EOF-terminated BWT, the used bytes as
a usage tree, MTF, and RUNA/RUNB zero-run digits with literal c + 1
through a DefSumModel (level <= 5) or a FenwickModel (level > 5), on a
coder of its own that is finished at the block's end.  The block's
length and pidx go first, through a LogDistanceModel over NoModel bits.

Container: 'bwtP', the file size + 1 as a varint (``host.util``), the
level byte, a varint block count, each block's varint size, then the
blocks' streams.

The block body is coded by the native runtime (``native.
bwtc_encode_block`` / ``bwtc_decode_block``) on the block coder's
state; ``native_body=False`` (also a keyword of ``compress_file`` and
``decompress_file``) takes the Python twins of ``host.bwtc``.
`_PRE_BWT` lets a caller supply the blocks' transforms for one call
(``parallel.mesh.mesh_compress_bwtcp``), and the card's entry point
(``parallel.pipeline.bwtcp_compress_device``) builds the same block
streams from the header this module's models code.
"""

from __future__ import annotations

import contextvars
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from . import bwt as bwt_ops
from . import mtf as mtf_ops
from .bwtc import (_decode_block_plain, _decode_usage_tree,
                   _encode_block_plain, _encode_usage_tree)
from .log_distance_model import LogDistanceModel
from .no_model import NoModel
from .range_coder import RangeCoder
from .stream import ArrayInputStream, BufferStream
from .util import (compress_file_helper, decompress_file_helper,
                   read_unsigned_number, write_unsigned_number)

MAGIC = 'bwtP'
F_PROB_MAX = 0xFF00
F_PROB_INCR = 0x0100

# this call's transforms: {block index: (U, pidx + 1)} (a context
# variable, so concurrent calls stay apart)
_PRE_BWT = contextvars.ContextVar('bwtcp_pre_bwt', default=None)


def _write_header(enc, level, length, pidx, used):
    """The block's header on its fresh coder: length and pidx through a
    LogDistanceModel over NoModel bits, then the usage tree."""
    bit_model_factory = NoModel.factory(enc)
    len_model = LogDistanceModel(level * 100000, 0,
                                 bit_model_factory, bit_model_factory)
    len_model.encode(length)
    len_model.encode(pidx)
    _encode_usage_tree(enc, used)


def _encode_block(block, level, pre=None, native_body=True):
    """One self-contained block stream (uint8 array).  `pre` supplies
    the block's EOF BWT (U, pidx + 1) where the caller computed it."""
    fast = level <= 5
    length = block.shape[0]
    out = BufferStream()
    enc = RangeCoder(out)
    enc.encode_start(0, 0)
    if pre is not None:
        U, pidx = np.asarray(pre[0], dtype=np.uint8), int(pre[1])
    else:
        U = np.zeros(length, dtype=np.uint8)
        A = np.zeros(length, dtype=np.int32)
        pidx = bwt_ops.bwtransform(block, U, A, length, 256)
    used = np.zeros(256, dtype=np.int64)
    used[U] = 1
    _write_header(enc, level, length, pidx, used)
    alphabet = np.nonzero(used)[0].astype(np.uint8)
    mtf_seq = mtf_ops.mtf_encode(U, alphabet)
    if native_body:
        st = enc.export_enc_state()
        out.write_array(native.bwtc_encode_block(mtf_seq, len(alphabet),
                                                 fast, st))
        enc.import_enc_state(st)
    else:
        _encode_block_plain(enc, mtf_seq, len(alphabet), fast)
    enc.encode_finish()
    return out.get_buffer()


def _decode_block(payload, level, native_body=True):
    """The bytes of one block stream."""
    fast = level <= 5
    ins = ArrayInputStream(payload)
    dec = RangeCoder(ins)
    dec.decode_start()
    bit_model_factory = NoModel.factory(dec)
    len_model = LogDistanceModel(level * 100000, 0,
                                 bit_model_factory, bit_model_factory)
    length = len_model.decode()
    pidx = len_model.decode()
    alphabet = np.nonzero(_decode_usage_tree(dec))[0].astype(np.uint8)
    if native_body:
        st = dec.export_dec_state(ins.pos)
        b = native.bwtc_decode_block(ins.data, st, len(alphabet), fast,
                                     length)
        ins.pos = dec.import_dec_state(st)
    else:
        b = _decode_block_plain(dec, len(alphabet), fast, length)
    U = np.zeros(length, dtype=np.uint8)
    A = np.zeros(length, dtype=np.int32)
    bwt_ops.unbwtransform(mtf_ops.mtf_decode(b, alphabet), U, A, length,
                          pidx)
    return U[:length]


def _level_of(props):
    """Clamped level from the props argument (default 9)."""
    if isinstance(props, (int, float)) and not isinstance(props, bool) \
            and 1 <= int(props) <= 9:
        return int(props)
    return 9


def _read_all(in_stream, file_size):
    if isinstance(in_stream, ArrayInputStream) and file_size >= 0:
        return in_stream.read_array(file_size)
    chunks = []
    buf = np.zeros(1 << 20, dtype=np.uint8)
    while True:
        n = in_stream.read(buf, 0, buf.shape[0])
        if n <= 0:
            break
        chunks.append(buf[:n].copy())
    return np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)


def split_blocks(data, block_size):
    """The codec's blocks of `data`: block_size bytes each, the last
    shorter; none for empty data."""
    return [data[i:i + block_size]
            for i in range(0, len(data), block_size)]


def write_container_body(out_stream, level, payloads):
    """Everything after the size varint: level, block count, sizes and
    the block streams."""
    out_stream.write_byte(level)
    write_unsigned_number(out_stream, len(payloads))
    for p in payloads:
        write_unsigned_number(out_stream, len(p))
    for p in payloads:
        p = np.asarray(p, dtype=np.uint8)
        if hasattr(out_stream, 'write_array'):
            out_stream.write_array(p)
        else:
            out_stream.write(p, 0, len(p))


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    level = _level_of(props)
    blocks = split_blocks(_read_all(in_stream, file_size), level * 100000)
    pre_map = _PRE_BWT.get() or {}
    if len(blocks) > 1:
        with ThreadPoolExecutor(min(8, os.cpu_count() or 2)) as ex:
            payloads = list(ex.map(
                lambda i: _encode_block(blocks[i], level, pre_map.get(i),
                                        native_body),
                range(len(blocks))))
    else:
        payloads = [_encode_block(b, level, native_body=native_body)
                    for b in blocks]
    write_container_body(out_stream, level, payloads)


def read_container_body(in_stream):
    """(level, block streams) after the size varint."""
    level = in_stream.read_byte()
    n_blocks = read_unsigned_number(in_stream)
    sizes = [read_unsigned_number(in_stream) for _ in range(n_blocks)]
    payloads = []
    for sz in sizes:
        buf = np.zeros(sz, dtype=np.uint8)
        in_stream.read(buf, 0, sz)
        payloads.append(buf)
    return level, payloads


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    level, payloads = read_container_body(in_stream)
    if len(payloads) > 1:
        with ThreadPoolExecutor(min(8, os.cpu_count() or 2)) as ex:
            outs = list(ex.map(
                lambda p: _decode_block(p, level, native_body), payloads))
    else:
        outs = [_decode_block(p, level, native_body) for p in payloads]
    for o in outs:
        out_stream.write(o, 0, len(o))


compress_file = compress_file_helper(MAGIC, _compress_guts)
decompress_file = decompress_file_helper(MAGIC, _decompress_guts)


class BWTCP:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
