"""bzip2 decoders that decode a stream's blocks in parallel (counterparts
of ``compressjs_tpu.parallel.decode``).

All three scan the stream for the 48-bit block magic at every bit
alignment, decode every candidate block on its own, and keep the blocks
that chain bit-exactly from the first block to an end-of-stream magic
whose stream CRC matches; candidates off the chain (a magic's bit
pattern inside a payload, blocks appended after the end magic) are
skipped.  A payload may hold either magic's pattern: a false block magic
makes the device decode of the block before it retry with a wider
bound, and a false end magic makes the chain go on to the next end hit.

* `decompress_file_device`: every block's decode on one card -- the
  host parses each candidate's small header; the card runs the parallel
  Huffman walk, RLE2 and MTF undo of every candidate (all launched
  before any is read back), then the inverse BWT and RLE1 undo of the
  chained blocks.
* `decompress_file_mesh`: the symbol decode on a host thread pool
  (``entropy='host'``, the native block decoder) or on the card
  (``'device'``, as `decompress_file_device`), then the inverse BWTs
  sharded over a `parallel.mesh.Mesh` and the RLE1 undo on the host.
* `decompress_file_parallel`: whole blocks on a host thread (or
  process) pool with the native block decoder; nothing on the card.

There is no sequential decoder to fall back to: a stream that does not
decode raises ``ValueError`` where the JAX decoders hand it to their
sequential decoder.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
import os

import numpy as np
import torch

from ..convert import decode_tables
from ..host.bits import SQRTPI, WHOLEPI
from ..host.bzip2_decode import _decode_one_block, _read_block_header
from ..host.bzip2_parse import (MAGIC_BYTES, _BitReader, _parse_block_header,
                                _parse_candidates, _pow2_at_least,
                                _scan_magic, _start)
from ..host.crc32 import crc32_bzip2, stream_crc_combine
from ..host.rle1 import rle1_decode
from ..ops.device_huffman import MAX_CODE_BITS, block_bytes, bwt_column, \
    huffman_walk_dev, tables_for_device
from .mesh import make_mesh, sharded_ragged_inverse_bwt

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


def _as_stream(data):
    return np.frombuffer(bytes(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data, dtype=np.uint8)


def _emit(result, output):
    if output is None:
        return result
    output.write(result)
    return output


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
    data = _as_stream(data)
    parsed = _parse_candidates(data)
    if parsed is None:
        return _emit(_empty_stream(data), output)
    dbuf_size, first_block_pos, candidates, end_hits = parsed
    chain, end = _chain(
        first_block_pos, candidates, end_hits,
        lambda cands, bound: _decode_window(data, cands, bound, dbuf_size,
                                            device))
    pieces = []
    for U, orig_ptr, target_crc, _ in chain:
        n = U.shape[0]
        out, _ = block_bytes(U, n, n, orig_ptr)
        pieces.append(_checked(out.cpu().numpy(), target_crc))
    _check_stream_crc(data, end, [res[2] for res in chain])
    return _emit(b''.join(pieces), output)


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


def _host_window(decode_all):
    """A window decoder for `_chain` from `decode_all(cands)`, which
    returns each candidate's result (its end bit last) or None."""
    def window(cands, end):
        return {p: r for p, r in zip(cands, decode_all(cands))
                if r is not None and r[-1] > p}
    return window


def _chain(first_block_pos, candidates, end_hits, decode_window):
    """Chain the blocks bit-exactly from the first block to an end hit:
    (the chained results, the end hit's bit position).
    `decode_window(cands, end)` decodes the candidates `cands`, which lie
    before the end hit `end`, to {bit position: result}, each result's
    last element the bit after its block.  The chain is built against the
    first end hit; where it stops short of an end hit, that end hit was a
    false one inside the payload of the block at the stop, so the
    candidates from there are decoded again against the next end hit.
    Blocks already chained are kept."""
    ends = set(end_hits)
    chain = []
    pos = first_block_pos
    for end in end_hits:
        if end <= pos:
            continue
        by_pos = decode_window([p for p in candidates if pos <= p < end],
                               end)
        while pos in by_pos:
            chain.append(by_pos.pop(pos))
            pos = chain[-1][-1]
        if pos in ends:
            break
    if not chain:
        raise ValueError('no decodable bzip2 block at the stream start')
    if pos not in ends:
        raise ValueError('block chain does not end at the end-of-stream '
                         'magic')
    return chain, pos


def _checked(piece, target_crc):
    """A decoded block's bytes, after its CRC check."""
    crc = crc32_bzip2(piece)
    if crc != target_crc:
        raise ValueError('bad block CRC (got %x expected %x)'
                         % (crc, target_crc))
    return piece.tobytes()


def _check_stream_crc(data, end, crcs):
    """The stream CRC after the end magic at bit `end` must combine the
    chained blocks' CRCs `crcs`."""
    stream_crc = 0
    for crc in crcs:
        stream_crc = stream_crc_combine(stream_crc, crc)
    rr = _BitReader(data)
    rr.seek_bit(end + 48)
    target = rr.read_bits(32)
    if target != stream_crc:
        raise ValueError('bad stream CRC (got %x expected %x)'
                         % (stream_crc, target))


def block_index(data):
    """Every bit position of the block magic in `data`: the candidate
    block starts (each points at the magic itself)."""
    return _scan_magic(_as_stream(data), MAGIC_BYTES)


def _parse_at(data, pos, dbuf_size):
    """Parse and symbol-decode the candidate block at bit `pos` on the
    host: (BWT column, origPtr, block CRC, the bit after the block), or
    None where it does not decode."""
    rr = _BitReader(data)
    rr.seek_bit(pos)
    try:
        res = _read_block_header(rr, dbuf_size)
    except ValueError:
        return None
    if res is None:
        return None
    return res + (rr.tell_bit(),)


def _decode_at(data, pos, dbuf_size):
    """Decode the candidate block at bit `pos` on the host to its bytes:
    (bytes, block CRC, the bit after the block), or None where it does
    not decode (or its block CRC does not match)."""
    rr = _BitReader(data)
    rr.seek_bit(pos)
    try:
        res = _decode_one_block(rr, dbuf_size)
    except ValueError:
        return None
    if res is None:
        return None
    out, crc = res
    return out, crc, rr.tell_bit()


_FORK_DATA = {}


def _decode_at_fork(args):
    key, pos, dbuf_size = args
    return _decode_at(_FORK_DATA[key], pos, dbuf_size)


def _default_workers():
    # oversubscribed: the native LF walk waits on memory, so extra
    # threads hide its stalls
    return min(8, 2 * (os.cpu_count() or 2))


def decompress_file_parallel(input_data, output=None, n_workers=None,
                             executor='thread'):
    """Decode the bzip2 stream `input_data` with its blocks decoded
    concurrently on the host by the native block decoder; nothing runs
    on the card.  Returns the original bytes, or writes them to `output`
    and returns it.  Raises ValueError on a stream that does not decode.

    executor='thread' (the default) runs the native decode loops, which
    drop the GIL, on `n_workers` threads.  executor='process' forks
    worker processes that inherit the input copy-on-write (Linux): it is
    opt-in because forking a process that has threads, or that holds a
    CUDA context, is unsafe -- the child may deadlock or fail on the
    card."""
    if executor not in ('thread', 'process'):
        raise ValueError("executor must be 'thread' or 'process', not %r"
                         % (executor,))
    data = _as_stream(input_data)
    parsed = _parse_candidates(data)
    if parsed is None:
        return _emit(_empty_stream(data), output)
    dbuf_size, first_block_pos, candidates, end_hits = parsed
    n_workers = n_workers or _default_workers()
    if executor == 'process' and len(candidates) > 2 and n_workers > 1:
        import multiprocessing as mp
        key = id(data)
        _FORK_DATA[key] = data
        try:
            with mp.get_context('fork').Pool(n_workers) as pool:
                chain, end = _chain(
                    first_block_pos, candidates, end_hits,
                    _host_window(lambda cands: pool.map(
                        _decode_at_fork, [(key, p, dbuf_size)
                                          for p in cands],
                        chunksize=max(1, len(cands) // (4 * n_workers)))))
        finally:
            del _FORK_DATA[key]
    else:
        with ThreadPoolExecutor(n_workers) as ex:
            chain, end = _chain(
                first_block_pos, candidates, end_hits,
                _host_window(lambda cands: list(ex.map(
                    lambda p: _decode_at(data, p, dbuf_size), cands))))
    _check_stream_crc(data, end, [crc for _, crc, _ in chain])
    return _emit(b''.join(out.tobytes() for out, _, _ in chain), output)


def decompress_file_mesh(input_data, output=None, mesh=None, n_workers=None,
                         entropy='host'):
    """Decode the bzip2 stream `input_data`: each candidate block's
    symbol decode on a host thread pool (``entropy='host'``, the native
    block decoder) or on the mesh's card (``'device'``: the parallel
    Huffman walk, RLE2 and MTF undo, as `decompress_file_device`); then
    the inverse BWTs of the chained blocks sharded over `mesh` (a
    `parallel.mesh.Mesh`; default ``make_mesh()``, one rank on 'cuda',
    which raises without a card), the RLE1 undo and the CRC checks on
    the host.  The RLE1 undo stays on the host because the pre-RLE1
    column is the smaller download.  Every rank of the mesh must call it
    with the same stream; each returns the original bytes (or writes
    them to `output` and returns it).  Raises ValueError on a stream
    that does not decode."""
    if entropy not in ('host', 'device'):
        raise ValueError("entropy must be 'host' or 'device', not %r"
                         % (entropy,))
    mesh = mesh if mesh is not None else make_mesh()
    data = _as_stream(input_data)
    parsed = _parse_candidates(data)
    if parsed is None:
        return _emit(_empty_stream(data), output)
    dbuf_size, first_block_pos, candidates, end_hits = parsed
    if entropy == 'device':
        chain, end = _chain(
            first_block_pos, candidates, end_hits,
            lambda cands, bound: _decode_window(data, cands, bound,
                                                dbuf_size, mesh.device))
        Us = torch.zeros((len(chain), dbuf_size), dtype=torch.uint8,
                         device=mesh.device)
    else:
        with ThreadPoolExecutor(n_workers or _default_workers()) as ex:
            chain, end = _chain(
                first_block_pos, candidates, end_hits,
                _host_window(lambda cands: list(ex.map(
                    lambda p: _parse_at(data, p, dbuf_size), cands))))
        Us = np.zeros((len(chain), dbuf_size), dtype=np.uint8)
    ns = [res[0].shape[0] for res in chain]
    for i, res in enumerate(chain):
        Us[i, :ns[i]] = res[0]
    packed = sharded_ragged_inverse_bwt(
        mesh, Us, ns, [res[1] for res in chain]).cpu().numpy()
    pieces = [_checked(rle1_decode(packed[i, :ns[i]]), res[2])
              for i, res in enumerate(chain)]
    _check_stream_crc(data, end, [res[2] for res in chain])
    return _emit(b''.join(pieces), output)
