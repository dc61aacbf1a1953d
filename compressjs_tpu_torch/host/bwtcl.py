"""The BWTC-L codec on the host (a copy of ``compressjs_tpu.codecs.bwtcl``):
the lane-interleaved entropy format.

A block's RLE2 symbol stream (EOF-terminated BWT, MTF, RUNA/RUNB
zero-run digits and literal c + 1) is split round robin over L lanes,
and each lane runs its own adaptive FenwickModel(asize + 1, 0xFF00,
0x100) over its own fresh range coder.  The lanes are independent, so
both directions run them side by side (``ops.device_lane`` on the
card, 128 lanes a block).

Container: 'bwtL', the file size + 1 as a varint, the level byte, a
varint block count, each block's varint size, then the blocks.  A block
is: varint length, varint pidx, varint symbol count S, varint lane
count L, the 32-byte used-byte bitmap, L varint lane sizes, then the
lanes' streams.

Each piece that the native runtime runs has a Python twin
(``plain=True``): `rle2_symbols` (``native.mtf_rle2``), `_encode_lane`
and `_decode_lane` (``native.order0_fenwick_encode`` / ``_decode``,
which take symbols below 256; a block that uses all 256 byte values
takes the twins).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native
from . import bwt as bwt_ops
from . import mtf as mtf_ops
from .bwtcp import (_level_of, _read_all, read_container_body, split_blocks,
                    write_container_body)
from .fenwick_model import FenwickModel
from .mtf_rle2 import mtf_rle2_plain
from .range_coder import RangeCoder
from .stream import ArrayInputStream, BufferStream
from .util import (compress_file_helper, decompress_file_helper,
                   read_unsigned_number, write_unsigned_number)

MAGIC = 'bwtL'
# the lane count each block header records (the JAX package measured
# 128 as the balance of ratio and parallelism on sample5 -9)
LANES = 128
F_PROB_MAX = 0xFF00
F_PROB_INCR = 0x0100


def rle2_symbols(U, used, plain=False):
    """The BWTC body symbols of a BWT column: MTF indices with zero runs
    as bijective base-2 RUNA/RUNB digits and literal c + 1, without
    bzip2's EOB.  Returns (syms, asize)."""
    alphabet = np.nonzero(used)[0].astype(np.uint8)
    asize = len(alphabet)
    if plain:
        syms, _ = mtf_rle2_plain(U, alphabet, asize)
    else:
        syms, _ = native.mtf_rle2(U, alphabet)
    return np.asarray(syms)[:-1], asize


def rle2_undo(syms, length):
    """Invert `rle2_symbols` (vectorised): RUNA/RUNB digit groups become
    zero runs, literal c + 1 becomes c.  Returns MTF indices
    uint16[length]; raises ValueError if the stream does not expand to
    exactly `length`."""
    s = np.asarray(syms, dtype=np.int64)
    n = len(s)
    if n == 0:
        if length:
            raise ValueError('empty symbol stream')
        return np.zeros(0, dtype=np.uint16)
    idx = np.arange(n, dtype=np.int64)
    is_digit = s < 2
    grp_start = np.maximum.accumulate(np.where(~is_digit, idx + 1, 0))
    dpos = np.minimum(idx - grp_start, 40)
    contrib = np.where(is_digit, (s + 1) << dpos, 0)
    csum = np.cumsum(contrib)
    grp_end = is_digit & np.concatenate([~is_digit[1:],
                                         np.ones(1, dtype=bool)])
    seg_base = np.where(grp_start > 0, csum[np.maximum(grp_start - 1, 0)],
                        0)
    run_len = np.where(grp_end, csum - seg_base, 0)
    out_cnt = np.where(is_digit, run_len, 1)
    offsets = np.cumsum(out_cnt) - out_cnt
    total = int(offsets[-1] + out_cnt[-1])
    if total != length:
        raise ValueError('RLE2 stream expands to %d, expected %d'
                         % (total, length))
    out = np.zeros(length, dtype=np.uint16)
    lit = ~is_digit
    out[offsets[lit]] = (s[lit] - 1).astype(np.uint16)
    return out


def lane_split(syms, lanes):
    """Round-robin lane views: lane l gets syms[l::lanes]."""
    return [np.ascontiguousarray(syms[l::lanes]) for l in range(lanes)]


def lane_sizes(S, lanes):
    """Per-lane symbol counts of a round-robin split of S symbols."""
    base = S // lanes
    return [base + (1 if l < S % lanes else 0) for l in range(lanes)]


def _encode_lane(lane_syms, asize, plain=False):
    """One lane's byte stream: a fresh coder and Fenwick(asize + 1)."""
    out = BufferStream()
    enc = RangeCoder(out)
    enc.encode_start(0, 0)
    if not plain and asize <= 255:
        st = enc.export_enc_state()
        out.write_array(native.order0_fenwick_encode(
            np.asarray(lane_syms).astype(np.uint8), asize + 1, -1, st))
        enc.import_enc_state(st)
    else:
        model = FenwickModel(enc, asize + 1, F_PROB_MAX, F_PROB_INCR)
        for c in np.asarray(lane_syms).tolist():
            model.encode(int(c))
    enc.encode_finish()
    return out.get_buffer()


def _decode_lane(payload, asize, n_syms, plain=False):
    """One lane's symbols (int32) back from its byte stream."""
    ins = ArrayInputStream(payload)
    dec = RangeCoder(ins)
    dec.decode_start()
    if not plain and asize <= 255:
        st = dec.export_dec_state(ins.pos)
        out = native.order0_fenwick_decode(ins.data, st, asize + 1, n_syms)
        ins.pos = dec.import_dec_state(st)
        return out.astype(np.int32)
    model = FenwickModel(dec, asize + 1, F_PROB_MAX, F_PROB_INCR)
    return np.array([model.decode() for _ in range(n_syms)],
                    dtype=np.int32)


def block_head(length, pidx, S, lanes, used, lane_lens):
    """A block's header bytes (uint8 array)."""
    head = BufferStream()
    for v in (length, pidx, S, lanes):
        write_unsigned_number(head, int(v))
    head.write_array(np.packbits(used))
    for ln in lane_lens:
        write_unsigned_number(head, int(ln))
    return head.get_buffer()


def encode_block(block, lanes=None, pre=None):
    """One self-contained block payload (uint8 array).  `pre` supplies
    the block's EOF BWT (U, pidx + 1) where the caller computed it."""
    if lanes is None:
        lanes = LANES                # the module's, read at call time
    length = block.shape[0]
    if pre is not None:
        U, pidx = np.asarray(pre[0], dtype=np.uint8), int(pre[1])
    else:
        U = np.zeros(length, dtype=np.uint8)
        A = np.zeros(length, dtype=np.int32)
        pidx = bwt_ops.bwtransform(block, U, A, length, 256)
    used = np.zeros(256, dtype=bool)
    used[block] = True
    syms, asize = rle2_symbols(U, used)
    S = len(syms)
    lanes = min(lanes, max(S, 1))
    lane_payloads = [_encode_lane(ls, asize)
                     for ls in lane_split(syms, lanes)]
    head = block_head(length, pidx, S, lanes, used,
                      [len(p) for p in lane_payloads])
    return np.concatenate([head] + [np.asarray(p, dtype=np.uint8)
                                    for p in lane_payloads])


def parse_block_header(payload):
    """(length, pidx, S, lanes, used, lane_payload_list) of one block."""
    ins = ArrayInputStream(payload)
    length = read_unsigned_number(ins)
    pidx = read_unsigned_number(ins)
    S = read_unsigned_number(ins)
    lanes = read_unsigned_number(ins)
    bitmap = np.zeros(32, dtype=np.uint8)
    ins.read(bitmap, 0, 32)
    used = np.unpackbits(bitmap).astype(bool)
    sizes = [read_unsigned_number(ins) for _ in range(lanes)]
    offs = np.cumsum([ins.pos] + sizes)
    lane_payloads = [payload[offs[i]:offs[i + 1]] for i in range(lanes)]
    return length, pidx, S, lanes, used, lane_payloads


def decode_block(payload, lane_syms_hook=None):
    """Invert `encode_block`.  `lane_syms_hook(lane_payloads, asize,
    counts) -> syms` replaces the lanes' entropy decode where given."""
    length, pidx, S, lanes, used, lane_payloads = \
        parse_block_header(payload)
    alphabet = np.nonzero(used)[0].astype(np.uint8)
    asize = len(alphabet)
    counts = lane_sizes(S, lanes)
    if lane_syms_hook is not None:
        syms = lane_syms_hook(lane_payloads, asize, counts)
    else:
        syms = np.zeros(S, dtype=np.int32)
        for l in range(lanes):
            syms[l::lanes] = _decode_lane(lane_payloads[l], asize,
                                          counts[l])
    mtf_seq = rle2_undo(syms, length)
    b = mtf_ops.mtf_decode(mtf_seq.astype(np.uint8)
                           if asize <= 256 else mtf_seq, alphabet)
    U = np.zeros(length, dtype=np.uint8)
    A = np.zeros(length, dtype=np.int32)
    bwt_ops.unbwtransform(b, U, A, length, pidx)
    return U[:length]


def _compress_guts(in_stream, out_stream, file_size, props, final_byte):
    level = _level_of(props)
    blocks = split_blocks(_read_all(in_stream, file_size), level * 100000)
    if len(blocks) > 1:
        with ThreadPoolExecutor(min(8, os.cpu_count() or 2)) as ex:
            payloads = list(ex.map(encode_block, blocks))
    else:
        payloads = [encode_block(b) for b in blocks]
    write_container_body(out_stream, level, payloads)


def _decompress_guts(in_stream, out_stream, file_size):
    _, payloads = read_container_body(in_stream)
    if len(payloads) > 1:
        with ThreadPoolExecutor(min(8, os.cpu_count() or 2)) as ex:
            outs = list(ex.map(decode_block, payloads))
    else:
        outs = [decode_block(p) for p in payloads]
    for o in outs:
        out_stream.write(o, 0, len(o))


compress_file = compress_file_helper(MAGIC, _compress_guts)
decompress_file = decompress_file_helper(MAGIC, _decompress_guts)


class BWTCL:
    MAGIC = MAGIC
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
