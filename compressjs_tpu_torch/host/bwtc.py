"""The BWTC codec on the host (a copy of ``compressjs_tpu.codecs.bwtc``):
a bzip2-style block codec whose blocks take the EOF-terminated BWT, MTF
and RUNA/RUNB zero-run digits, coded through one adaptive order-0 model
over a range coder.

The format is the reference's: a 'bwtc' container whose last header
byte is the range coder's free first byte, the level as a coded byte,
one range coder spanning every block, a 3-way indicator before each
block (full, short, end), a short block's length and every block's pidx
through a LogDistanceModel over NoModel bits, the block's used bytes as
a 512-node usage tree (full and empty subtrees pruned), then the block
body through a DefSumModel (level <= 5) or a FenwickModel (level > 5).

Each block's transform (BWT and MTF) is independent of the others, so a
small thread pool transforms the blocks ahead while the coder drains
them in order.  `_BWT_HOOK` lets a caller supply the BWT (the card's,
``parallel.pipeline.DeviceBWTCEncoder``) for one call.  The block body
is coded by the native runtime (``native.bwtc_encode_block`` /
``bwtc_decode_block``) on the same coder state, where the output stream
takes whole arrays (``write_array``) and the input is an
`ArrayInputStream`; `_encode_block_plain` / `_decode_block_plain` are
the Python twins that run on any other stream, and wherever the caller
passes ``native_body=False`` (a keyword of ``compress_file`` and
``decompress_file``).
"""

from __future__ import annotations

import contextvars
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from . import bwt as bwt_ops
from . import mtf as mtf_ops
from .defsum_model import DefSumModel
from .fenwick_model import FenwickModel
from .log_distance_model import LogDistanceModel
from .no_model import NoModel
from .range_coder import RangeCoder
from .rle import runab_encode_lengths
from .stream import ArrayInputStream
from .util import compress_file_helper, decompress_file_helper, fls

MAGIC = 'bwtc'
F_PROB_MAX = 0xFF00
F_PROB_INCR = 0x0100

# this call's BWT: fn(T, U, A, n, alphabet_size) -> pidx + 1, as
# bwt.bwtransform (a context variable, so concurrent calls stay apart)
_BWT_HOOK = contextvars.ContextVar('bwtc_bwt_hook', default=None)


def _encode_usage_tree(encoder, used):
    """Binary usage tree over the 256 byte values: internal nodes carry
    subtree counts, coded 3-way (empty / partial / full), with the
    children of a full or empty node known and skipped."""
    tree = np.zeros(512, dtype=np.int64)
    tree[256:512] = used
    for i in range(255, 0, -1):
        tree[i] = tree[2 * i] + tree[2 * i + 1]
    tree[0] = 1  # sentinel
    for i in range(1, 512):
        parent = tree[i >> 1]
        full = 1 << (9 - fls(i))
        if parent == 0 or parent == full * 2:
            continue  # known full/empty
        if i >= 256:
            encoder.encode_bit(int(tree[i]))
        else:
            v = 0 if tree[i] == 0 else (2 if tree[i] == full else 1)
            encoder.encode_freq(1, v, 3)


def _decode_usage_tree(decoder):
    tree = np.zeros(512, dtype=np.int64)
    tree[0] = 1
    for i in range(1, 512):
        parent = tree[i >> 1]
        full = 1 << (9 - fls(i))
        if parent == 0 or parent == full * 2:
            tree[i] = parent >> 1
        elif i >= 256:
            tree[i] = decoder.decode_bit()
        else:
            v = decoder.decode_cul_freq(3)
            decoder.decode_update(1, v, 3)
            tree[i] = full if v == 2 else v
    return tree[256:512] != 0


def _compress_guts(in_stream, out_stream, file_size, props, final_byte,
                   native_body=True):
    encoder = RangeCoder(out_stream)
    encoder.encode_start(final_byte, 1)
    level = 9
    if isinstance(props, (int, float)) and not isinstance(props, bool) \
            and 1 <= int(props) <= 9:
        level = int(props)
    encoder.encode_byte(level)
    fast = level <= 5
    block_size = level * 100000

    bit_model_factory = NoModel.factory(encoder)
    len_model = LogDistanceModel(block_size, 0,
                                 bit_model_factory, bit_model_factory)
    block = np.zeros(block_size, dtype=np.uint8)

    # read here: the pool's threads do not see this call's context
    bwt_fn = _BWT_HOOK.get() or bwt_ops.bwtransform

    def transform_job(b):
        n = b.shape[0]
        U = np.zeros(n, dtype=np.uint8)
        A = np.zeros(n, dtype=np.int32)
        pidx = bwt_fn(b, U, A, n, 256)
        used = np.zeros(256, dtype=np.int64)
        used[U] = 1
        alphabet = np.flatnonzero(used).astype(np.uint8)
        return pidx, used, alphabet, mtf_ops.mtf_encode(U, alphabet)

    workers = max(1, min(4, os.cpu_count() or 1))
    ex = ThreadPoolExecutor(workers)
    pending = deque()
    eof = False
    try:
        while True:
            while not eof and len(pending) <= workers:
                length = in_stream.read(block, 0, block_size)
                if length == 0:
                    eof = True
                    break
                pending.append((length, ex.submit(transform_job,
                                                  block[:length].copy())))
                if length != block_size:
                    eof = True  # a short block is always the last one
            if not pending:
                break
            length, fut = pending.popleft()
            pidx, used, alphabet, mtf_seq = fut.result()
            # the block's coder steps, in the format's order: indicator,
            # [short length], pidx, usage tree, body
            if length == block_size:
                encoder.encode_freq(1, 0, 3)  # full-size block
            else:
                encoder.encode_freq(1, 1, 3)  # short block
                len_model.encode(length)
            len_model.encode(pidx)
            _encode_usage_tree(encoder, used)
            if native_body and hasattr(out_stream, 'write_array'):
                st = encoder.export_enc_state()
                out_stream.write_array(native.bwtc_encode_block(
                    mtf_seq, len(alphabet), fast, st))
                encoder.import_enc_state(st)
            else:
                _encode_block_plain(encoder, mtf_seq, len(alphabet), fast)
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    encoder.encode_freq(1, 2, 3)  # no more blocks
    encoder.encode_finish()


def _encode_block_plain(encoder, mtf_seq, alphabet_size, fast):
    """Python twin of ``native.bwtc_encode_block``: zero runs as
    RUNA/RUNB digits, index c as symbol c + 1, through a fresh model."""
    if fast:
        model = DefSumModel(encoder, alphabet_size + 1)
    else:
        model = FenwickModel(encoder, alphabet_size + 1, F_PROB_MAX,
                             F_PROB_INCR)
    encode = model.encode
    run_length = 0
    for c in np.asarray(mtf_seq).tolist():
        if c == 0:
            run_length += 1
            continue
        for d in runab_encode_lengths(run_length):
            encode(d)
        run_length = 0
        encode(c + 1)
    for d in runab_encode_lengths(run_length):
        encode(d)


def _decode_block_plain(decoder, alphabet_size, fast, length):
    """Python twin of ``native.bwtc_decode_block``: the block's `length`
    MTF indices (uint8)."""
    if fast:
        model = DefSumModel(decoder, alphabet_size + 1, True)
    else:
        model = FenwickModel(decoder, alphabet_size + 1, F_PROB_MAX,
                             F_PROB_INCR)
    decode = model.decode
    b = np.empty(length, dtype=np.uint8)
    i = 0
    val = 1  # the weight of the zero-run digit
    while i < length:
        c = decode()
        if c == 0:    # RUNA
            b[i:i + val] = 0
            i += val
            val *= 2
        elif c == 1:  # RUNB
            b[i:i + 2 * val] = 0
            i += 2 * val
            val *= 2
        else:
            val = 1
            b[i] = c - 1
            i += 1
    return b


def _decompress_guts(in_stream, out_stream, file_size, native_body=True):
    decoder = RangeCoder(in_stream)
    decoder.decode_start(True)
    level = decoder.decode_byte()
    assert 1 <= level <= 9
    fast = level <= 5
    block_size = level * 100000

    bit_model_factory = NoModel.factory(decoder)
    len_model = LogDistanceModel(block_size, 0,
                                 bit_model_factory, bit_model_factory)
    U = np.zeros(block_size, dtype=np.uint8)
    A = np.zeros(block_size, dtype=np.int32)
    while True:
        indicator = decoder.decode_cul_freq(3)
        decoder.decode_update(1, indicator, 3)
        if indicator == 0:
            length = block_size
        elif indicator == 1:
            length = len_model.decode()
        else:  # 2: done
            break
        pidx = len_model.decode()
        alphabet = np.flatnonzero(_decode_usage_tree(decoder)) \
            .astype(np.uint8)
        if native_body and isinstance(in_stream, ArrayInputStream):
            st = decoder.export_dec_state(in_stream.pos)
            b = native.bwtc_decode_block(in_stream.data, st, len(alphabet),
                                         fast, length)
            in_stream.pos = decoder.import_dec_state(st)
        else:
            b = _decode_block_plain(decoder, len(alphabet), fast, length)
        bwt_ops.unbwtransform(mtf_ops.mtf_decode(b, alphabet), U, A, length,
                              pidx)
        out_stream.write(U, 0, length)
    decoder.decode_finish()


compress_file = compress_file_helper(MAGIC, _compress_guts, True)
decompress_file = decompress_file_helper(MAGIC, _decompress_guts)


class BWTC:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
