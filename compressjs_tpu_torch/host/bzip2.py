"""The bzip2 codec on the host (the `Bzip2` class of
``compressjs_tpu.codecs.bzip2``): 'BZh1'-'BZh9' streams, byte for byte
the JAX package's.

* `compress_file` packs RLE1 blocks of level x 100000 - 19 bytes and
  encodes them on a thread pool: the native cyclic BWT, the fused native
  MTF + RLE2 scan, then the Huffman stages (`_finish_block`: group
  optimisation, canonical codes, payload packing).  With few blocks a
  block is two chained tasks (BWT, then the entropy stage), so a core
  that finished its sort takes another block's entropy stage.
* `decompress_file` sends an in-memory (``output=None``), single-stream
  input over 64 KB to ``parallel.decode.decompress_file_parallel`` (whole
  blocks on a host thread pool) unless COMPRESSJS_TPU_NO_PARALLEL is
  set, as the JAX package does.  Where that decoder refuses the stream,
  the sequential decoder below decodes it or raises its error, as the
  JAX package's parallel decoder hands such a stream to its sequential
  one.  The sequential decoder (``host.bzip2_decode``) writes block by
  block and follows concatenated streams with ``multistream=True``.
* `decompress_block` decodes the one block whose magic starts at a bit
  position; `table` calls back (bit position, size) for every block.
* `compress_block_bits` is one block's whole encode after its magic and
  CRC (`bwt_stage`, then `entropy_stage_bits`).

``native_body=False`` takes the Python twins of the native scans: the
encode's MTF + RLE2 (``host.mtf_rle2.mtf_rle2_plain``) and the decode's
symbol loop (``host.bzip2_decode.decode_symbols_plain``, sequential).
Format errors raise `Bzip2Error` (a ValueError) with an `Err` code and
the JAX codec's message at each site (``host.bzip2_parse._throw``).

The stream's layout is written here once for every bzip2 encoder of the
package, this codec and the card's (``parallel.pipeline``,
``parallel.mesh``, ``parallel.hetero``): the level's block size
(`block_size_of`), the RLE1 split with each block's CRC (`split_blocks`),
a block's alphabet (`block_meta`) and the framing around the blocks
(`StreamWriter`).  `_block_header` and `_finish_block` are also the card
encoders' host entropy stage.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np

from . import huffman_stages as hs
from .bits import SQRTPI, WHOLEPI, BitArrayWriter, BitWriter
from .bwt import bwtransform2, inverse_bwt
from .bzip2_decode import _decode_one_block, _read_block_header
from .bzip2_parse import Err, _BitReader, _start, _throw
from .crc32 import crc32_bzip2, stream_crc_combine
from .mtf_rle2 import mtf_rle2, mtf_rle2_plain
from .rle1 import rle1_decode, rle1_encode
from .stream import (ArrayInputStream, BitStream, coerce_input_stream,
                     coerce_output_stream)
# the JAX module's other public names
from .bzip2_parse import (  # noqa: F401
    MAX_HUFCODE_BITS, MAX_SYMBOLS, Bzip2Error)
from .huffman_stages import GROUP_SIZE  # noqa: F401
from .stream import EOF  # noqa: F401

PARALLEL_MIN_BYTES = 65536


# ===========================================================================
# encoder

def block_size_of(level):
    """The RLE1 block size of level `level` (1-9; ValueError for another):
    the reference shaves 19 bytes so that block cuts line up in the common
    case of no run at the block's edge."""
    if not 1 <= level <= 9:
        raise ValueError('Invalid block size multiplier')
    return level * 100000 - 19


def split_blocks(data, block_size):
    """The host RLE1 pass over the uint8 array `data`, block by block as
    it goes: (packed block, CRC of the input bytes it holds), both from
    native calls that drop the GIL, so that a card encoder's worker
    thread runs beside it."""
    start = 0
    while start < data.shape[0]:
        block, consumed = rle1_encode(data, start, block_size)
        if block.shape[0] == 0 or consumed == 0:
            break
        yield block, crc32_bzip2(data[start:start + consumed])
        # mid-stream blocks may be short of block_size (the RLE1 count
        # byte's back-off defers a byte), so the input position ends it
        start += consumed


def block_meta(block):
    """(used-byte mask, alphabet size, byte -> dense symbol remap)."""
    used = np.zeros(256, dtype=bool)
    used[block] = True
    alphabet = np.nonzero(used)[0]
    remap = np.zeros(256, dtype=np.int32)
    remap[alphabet] = np.arange(len(alphabet))
    return used, len(alphabet), remap


class StreamWriter:
    """The stream's framing around its blocks, written to `out` (default a
    ``host.bits.BitWriter``; the codec's own ``host.stream.BitStream``):
    the magic with the level, each block's magic, CRC and bits, then the
    end magic and the blocks' CRCs combined."""

    def __init__(self, level, out=None):
        self.out = BitWriter() if out is None else out
        self.crc = 0
        self.out.write_bits(32, int.from_bytes(b'BZh' + bytes([48 + level]),
                                               'big'))

    def block(self, crc, *bits):
        """One block: its CRC, then its bit arrays in order."""
        self.crc = stream_crc_combine(self.crc, crc)
        self.out.write_bits(48, WHOLEPI)
        self.out.write_bits(32, crc)
        for b in bits:
            self.out.write_bit_array(b)

    def end(self):
        """The stream's end; returns `out`."""
        self.out.write_bits(48, SQRTPI)
        self.out.write_bits(32, self.crc)
        return self.out


def _ref_ties_default():
    """Whether COMPRESSJS_TPU_BZ2_REF_TIES asks for the reference's
    grouping (``host.huffman_stages.optimize_groups``'s `ref_ties`), as
    the JAX package reads it."""
    return os.environ.get('COMPRESSJS_TPU_BZ2_REF_TIES',
                          '0') not in ('0', '', 'false')


def _block_header(pidx, used, selectors, tables):
    """Block header bits after the block CRC: randomised flag, pidx,
    used-byte bitmap, group count, selectors and length tables."""
    w = BitArrayWriter()
    w.write_bit(0)  # not randomised
    w.write_bits(24, int(pidx))
    compact = used.reshape(16, 16).any(axis=1)
    for i in range(16):
        w.write_bit(bool(compact[i]))
    for i in range(16):
        if compact[i]:
            for j in range(16):
                w.write_bit(bool(used[(i << 4) | j]))
    w.write_bits(3, len(tables))
    w.write_bits(15, len(selectors))
    w.append(hs.selector_mtf_bits(selectors, len(tables)))
    for lengths in tables:
        w.append(hs.emit_table_deltas(lengths))
    return w.bits()


def _finish_block(block, pidx, syms, count, freq, alphabet_size, used,
                  ref_ties=None):
    """Host entropy stage of a block: group optimisation, canonical codes
    and payload packing of the symbol stream.  `ref_ties` defaults to
    `_ref_ties_default()`.  Returns (header_bits, (payload_bytes,
    nbits))."""
    if ref_ties is None:
        ref_ties = _ref_ties_default()
    end_of_block = alphabet_size + 1
    syms = syms[:count]
    length_matrix, selectors = hs.optimize_groups(
        syms, end_of_block + 1, freq[:end_of_block + 1], ref_ties)
    code_matrix = np.stack([hs.canonical_codes(row)
                            for row in length_matrix])
    payload = hs.payload_bytes(syms, selectors, length_matrix, code_matrix)
    return _block_header(pidx, used, selectors, list(length_matrix)), \
        payload


def compress_block_bits(block):
    """One RLE1-packed block encoded: everything after its magic and CRC,
    as 0/1 bits."""
    return entropy_stage_bits(block, *bwt_stage(block))


def bwt_stage(block):
    """The block's cyclic BWT: (U, pidx)."""
    n = block.shape[0]
    U = np.zeros(n, dtype=np.uint8)
    return U, bwtransform2(block, U, n)


def entropy_stage_bits(block, U, pidx, native_body=True):
    """Everything of a block after its magic and CRC, as 0/1 bits."""
    used, alphabet_size, _ = block_meta(block)
    alphabet = np.flatnonzero(used).astype(np.uint8)
    scan = mtf_rle2 if native_body else mtf_rle2_plain
    syms, freq = scan(U, alphabet, alphabet_size)
    header, (payload, bits) = _finish_block(block, pidx, syms, len(syms),
                                            freq, alphabet_size, used)
    return np.concatenate([header, np.unpackbits(payload, count=bits)])


def _read_input(in_stream):
    if isinstance(in_stream, ArrayInputStream):
        return in_stream.read_array(in_stream.size - in_stream.pos)
    chunks = []
    buf = np.zeros(1 << 20, dtype=np.uint8)
    while True:
        n = in_stream.read(buf, 0, buf.shape[0])
        if n <= 0:
            break
        chunks.append(buf[:n].copy())
    return np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)


def compress_file(input_data, output=None, props=None, native_body=True):
    """bzip2-compress `input_data`: props is the level (block size
    multiplier 1-9, default 9).  Returns the stream (uint8 array), or
    writes it to `output` (a stream with write_byte) and returns it."""
    in_stream = coerce_input_stream(input_data)
    o = coerce_output_stream(output)
    level = 9
    if isinstance(props, (int, float)) and not isinstance(props, bool):
        level = int(props)
    block_size = block_size_of(level)
    stream = StreamWriter(level, BitStream(o.stream))
    data = _read_input(in_stream)

    workers = max(1, min(8, os.cpu_count() or 1))
    split_stages = -(-data.shape[0] // block_size) <= 3 * workers

    def ent_job(block, U, pidx):
        return entropy_stage_bits(block, U, pidx, native_body)

    def whole_job(block):
        return ent_job(block, *bwt_stage(block))

    def chain_ent(ex, block, bwt_fut):
        """A future of ent_job(block, *bwt_fut.result()), submitted once
        the BWT is done (no worker waits on another)."""
        outf = Future()

        def on_bwt(f):
            if f.exception() is not None:
                outf.set_exception(f.exception())
                return
            try:
                nxt = ex.submit(ent_job, block, *f.result())
            except RuntimeError as e:   # the pool shut down on an error
                outf.set_exception(e)
                return
            nxt.add_done_callback(
                lambda g: outf.set_exception(g.exception())
                if g.exception() is not None else outf.set_result(g.result()))

        bwt_fut.add_done_callback(on_bwt)
        return outf

    with ThreadPoolExecutor(workers) as ex:
        inflight = deque()

        def drain():
            crc, fut = inflight.popleft()
            stream.block(crc, fut.result())

        for block, crc in split_blocks(data, block_size):
            if split_stages:
                fut = chain_ent(ex, block, ex.submit(bwt_stage, block))
            else:
                fut = ex.submit(whole_job, block)
            inflight.append((crc, fut))
            while len(inflight) > workers + 1:
                drain()
        while inflight:
            drain()
    stream.end().flush()
    return o.retval


# ===========================================================================
# decoder

def _slurp(input_data):
    """The compressed input as a uint8 array (a view where it is one)."""
    if hasattr(input_data, 'read_byte'):
        s = coerce_input_stream(input_data)
        if isinstance(s, ArrayInputStream):
            return s.data[s.pos:]
        return _read_input(s)
    if isinstance(input_data, np.ndarray):
        return input_data
    return np.frombuffer(bytes(input_data), dtype=np.uint8)


def _write(stream, out):
    if hasattr(stream, 'write_array'):
        stream.write_array(out)
    else:
        stream.write(out, 0, len(out))


def decompress_file(input_data, output=None, multistream=False,
                    native_body=True, _sequential=False):
    """Decode the bzip2 stream `input_data` (with ``multistream``, the
    streams concatenated in it).  Returns the bytes (uint8 array), or
    writes them to `output` and returns it."""
    data = _slurp(input_data)
    if (not _sequential and not multistream and native_body
            and output is None
            and data.shape[0] > PARALLEL_MIN_BYTES
            and (os.cpu_count() or 1) > 1
            and os.environ.get('COMPRESSJS_TPU_NO_PARALLEL', '') == ''):
        from ..parallel.decode import decompress_file_parallel
        try:
            return np.frombuffer(decompress_file_parallel(data),
                                 dtype=np.uint8)
        except ValueError:
            pass   # the sequential decoder decodes it or names the error
    r = _BitReader(data)
    o = coerce_output_stream(output)
    dbuf_size = _start(r)
    stream_crc = 0
    while True:
        res = _decode_one_block(r, dbuf_size, native_body)
        if res is not None:
            out, block_crc = res
            _write(o.stream, out)
            stream_crc = stream_crc_combine(stream_crc, block_crc)
            continue
        target_stream_crc = r.read_bits(32)
        if target_stream_crc != stream_crc:
            _throw(Err.DATA_ERROR, 'Bad stream CRC (got %x expected %x)'
                   % (stream_crc, target_stream_crc))
        if multistream and not r.eof():
            r.align_byte()
            if r.eof():
                break
            dbuf_size = _start(r)
            stream_crc = 0
            continue
        break
    return o.retval


def decompress_block(input_data, pos, output=None):
    """Random access: decode the one block whose magic starts at bit
    `pos`.  Returns its bytes (uint8 array), or writes them to `output`
    and returns it."""
    data = _slurp(input_data)
    r = _BitReader(data)
    o = coerce_output_stream(output)
    dbuf_size = _start(r)
    r.seek_bit(pos)
    res = _decode_one_block(r, dbuf_size)
    if res is not None:
        _write(o.stream, res[0])
    return o.retval


def table(input_data, callback, multistream=False):
    """Call callback(bit position, decoded size) for every block: the
    seek index of `decompress_block`."""
    data = _slurp(input_data)
    r = _BitReader(data)
    dbuf_size = _start(r)
    while True:
        position = r.tell_bit()
        res = _read_block_header(r, dbuf_size)
        if res is not None:
            dbuf, orig_pointer, _ = res
            callback(position, len(rle1_decode(inverse_bwt(dbuf,
                                                           orig_pointer))))
            continue
        r.read_bits(32)  # the stream CRC (not checked here)
        if multistream and not r.eof():
            r.align_byte()
            if r.eof():
                break
            if _start(r) != dbuf_size:
                # the JAX codec's assert, raised even under -O
                raise AssertionError("shouldn't change block size within "
                                     "multistream file")
            continue
        break


class Bzip2:
    Err = Err
    compress_file = staticmethod(compress_file)
    decompress_file = staticmethod(decompress_file)
    decompress_block = staticmethod(decompress_block)
    table = staticmethod(table)
