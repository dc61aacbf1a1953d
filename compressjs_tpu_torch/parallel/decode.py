"""bzip2 decoder with every block's decode on the GPU (counterpart of
``compressjs_tpu.parallel.decode.decompress_file_mesh`` with
``entropy='device'``, on one card).

The host scans the stream for the 48-bit block magic at every bit
alignment and parses each candidate block's small header; the device
runs the parallel Huffman walk, RLE2 and MTF undo of every candidate
(all launched before any is read back), and then, for the blocks that
chain bit-exactly from the first to the end-of-stream magic, the
inverse BWT and RLE1 undo.  The host checks each block's CRC and the
stream CRC.  A payload may hold either magic's bit pattern: a false
block magic makes the block before it retry with a wider bound, and a
false end magic makes the chain go on to the next end hit.  There is no
host decoder to fall back to: a stream that does not decode raises
``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import decode_tables
from ..host.bits import SQRTPI, WHOLEPI
from ..host.bzip2_parse import (_BitReader, _parse_block_header,
                                _parse_candidates, _pow2_at_least, _start)
from ..host.crc32 import crc32_bzip2, stream_crc_combine
from ..ops.device_huffman import MAX_CODE_BITS, block_bytes, bwt_column, \
    huffman_walk_dev, tables_for_device

# The most bits a block takes from its magic to the end of its EOB code.
# The header: magic 48, block CRC 32, randomised flag 1, origPtr 24,
# symbol map 16 + 16 x 16, group count 3, selector count 15, at most
# 32,767 unary selectors of at most 7 bits, and 6 tables of a 5-bit
# first length and 258 lengths of at most 2 x 19 + 1 delta bits each
# (the shortest steps from the previous length, as encoders write them).
# Then at most dbuf_size + 1 symbols (a BWT byte gives at most one
# symbol, and the EOB) of at most 20 bits.
_MAX_HEADER_BITS = (48 + 32 + 1 + 24 + 16 + 16 * 16 + 3 + 15 + 32767 * 7
                    + 6 * (5 + 258 * 39))


def _max_block_bits(dbuf_size):
    return _MAX_HEADER_BITS + (dbuf_size + 1) * MAX_CODE_BITS


def _walk_inputs(data, pos, bound, dbuf_size, device):
    """Parse the header of the candidate block at bit `pos` on the host.
    `bound` is the bit the block's symbols cannot run past: the next
    candidate's, an end hit's, or the most a block can take.  Returns
    None when the header does not parse, else a dict: 'walk', the
    arguments of `huffman_walk_dev` on `device`; 'sym_to_byte', a uint8
    tensor of 256 entries; and the block's 'byte0', 'orig_ptr' and
    'target_crc'."""
    rr = _BitReader(data)
    rr.seek_bit(pos)
    if rr.read_bits(48) != WHOLEPI:
        return None
    target_crc = rr.read_bits(32)
    try:
        orig_ptr, sym_to_byte, selectors, groups = _parse_block_header(
            rr, dbuf_size)
    except ValueError:
        return None
    sym_start = rr.pos
    if bound <= sym_start:
        return None
    byte0 = sym_start >> 3
    bit0 = sym_start & 7
    nbits_cap = _pow2_at_least(bound - sym_start + 1, 1 << 12)
    s_cap = _pow2_at_least(len(selectors), 64)
    payload = torch.from_numpy(np.array(
        data[byte0:byte0 + ((nbits_cap + bit0 + 7) >> 3) + 8])).to(device)
    tables = decode_tables(*tables_for_device(groups, len(groups)), device)
    sel = np.zeros(s_cap, dtype=np.int32)
    sel[:len(selectors)] = selectors
    s2b = np.zeros(256, dtype=np.uint8)
    s2b[:len(sym_to_byte)] = sym_to_byte
    walk = (payload, bit0, nbits_cap, s_cap, *tables,
            torch.from_numpy(sel).to(device), len(selectors),
            len(sym_to_byte) + 1)
    return dict(walk=walk, sym_to_byte=torch.from_numpy(s2b).to(device),
                byte0=byte0, orig_ptr=orig_ptr, target_crc=target_crc)


def _device_entropy_launch(data, pos, bound, dbuf_size, device):
    """Launch the walk, RLE2 undo, MTF undo and alphabet map of the
    candidate block at bit `pos` on the device.  Returns unsynchronised
    device handles, or None when the header does not parse."""
    h = _walk_inputs(data, pos, bound, dbuf_size, device)
    if h is None:
        return None
    syms, h['count'], h['end_bit'] = huffman_walk_dev(*h.pop('walk'))
    h['U'], h['total'] = bwt_column(syms, h['count'], dbuf_size,
                                    h.pop('sym_to_byte'))
    return h


def _device_entropy_collect(h, bound, dbuf_size):
    """Read back one launched block (one host sync) and check it against
    its payload bound.  Returns (U, orig_ptr, target_crc, end_bit) or
    None."""
    if h is None:
        return None
    end_bit, count, total = torch.stack(
        [h['end_bit'], h['count'], h['total']]).tolist()
    end_bit += h['byte0'] * 8
    if count == 0 or end_bit > bound:
        return None
    if not (0 < total <= dbuf_size) or h['orig_ptr'] >= total:
        return None
    return h['U'][:total], h['orig_ptr'], h['target_crc'], end_bit


def _empty_stream(data):
    """A stream with no block: its end magic and a zero CRC must follow
    the stream header."""
    r = _BitReader(data)
    _start(r)
    if r.read_bits(48) != SQRTPI or r.read_bits(32) != 0:
        raise ValueError('no bzip2 block chain from the stream header to '
                         'an end-of-stream magic')
    return b''


def decompress_file_device(data, output=None, device='cuda'):
    """Decode the bzip2 stream `data` (bytes-like or uint8 array) with
    every block's decode on `device` ('cuda' unless the caller asks for
    'cpu', where each kernel's plain version runs).  Returns the original
    bytes, or writes them to `output` (a binary file object) and returns
    `output`.  Raises ValueError on a stream that does not decode (bad
    header, broken block chain, block or stream CRC mismatch)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('decompress_file_device: CUDA is not available; '
                           "pass device='cpu' to run on the CPU")
    data = np.frombuffer(bytes(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data, dtype=np.uint8)
    parsed = _parse_candidates(data)
    if parsed is None:
        result = _empty_stream(data)
    else:
        result = _decode_chain(data, *parsed, device)
    if output is None:
        return result
    output.write(result)
    return output


def _decode_window(data, cands, end, dbuf_size, device):
    """{bit position: `_device_entropy_collect` result} for the candidate
    blocks `cands` (ascending, all before the end hit `end`) that decode.
    Each is first bounded by the next candidate; one that fails is tried
    again to `end`.  Neither bound exceeds the most bits a block of this
    dbuf_size can take, so no valid block is out of reach and the
    speculative arrays stay bounded."""
    most = _max_block_bits(dbuf_size)
    bounds = [min(b, p + most) for p, b in zip(cands, cands[1:] + [end])]
    # launch every candidate before reading any back, so the host's
    # header parsing overlaps the device's walks
    launched = [_device_entropy_launch(data, p, b, dbuf_size, device)
                for p, b in zip(cands, bounds)]
    by_pos = {}
    for p, b, h in zip(cands, bounds, launched):
        res = _device_entropy_collect(h, b, dbuf_size)
        retry = min(end, p + most)
        if res is None and retry > b:
            # a false magic inside a payload makes the first bound too
            # tight for the true block before it
            res = _device_entropy_collect(
                _device_entropy_launch(data, p, retry, dbuf_size, device),
                retry, dbuf_size)
        if res is not None and res[3] > p:
            by_pos[p] = res
    return by_pos


def _decode_chain(data, dbuf_size, first_block_pos, candidates, end_hits,
                  device):
    """Chain the blocks bit-exactly from the first block to an end hit.
    The chain is built against the first end hit; where it stops short
    of an end hit, that end hit was a false one inside the payload of
    the block at the stop, so the blocks from there are decoded again
    against the next end hit.  Blocks already chained are kept."""
    ends = set(end_hits)
    chain = []
    pos = first_block_pos
    for end in end_hits:
        if end <= pos:
            continue
        by_pos = _decode_window(
            data, [p for p in candidates if pos <= p < end], end,
            dbuf_size, device)
        while pos in by_pos:
            chain.append(by_pos.pop(pos))
            pos = chain[-1][3]
        if pos in ends:
            break
    if not chain:
        raise ValueError('no decodable bzip2 block at the stream start')
    if pos not in ends:
        raise ValueError('block chain does not end at the end-of-stream '
                         'magic')

    pieces = []
    stream_crc = 0
    for U, orig_ptr, target_crc, _ in chain:
        n = U.shape[0]
        out, _ = block_bytes(U, n, n, orig_ptr)
        piece = out.cpu().numpy()
        crc = crc32_bzip2(piece)
        if crc != target_crc:
            raise ValueError('bad block CRC (got %x expected %x)'
                             % (crc, target_crc))
        pieces.append(piece.tobytes())
        stream_crc = stream_crc_combine(stream_crc, target_crc)
    rr = _BitReader(data)
    rr.seek_bit(pos + 48)
    target = rr.read_bits(32)
    if target != stream_crc:
        raise ValueError('bad stream CRC (got %x expected %x)'
                         % (stream_crc, target))
    return b''.join(pieces)
