"""bzip2 encoder with the block transforms on the GPU (counterpart of
``compressjs_tpu.parallel.pipeline.DeviceBzip2Encoder``).

The host packs RLE1 blocks and computes their CRCs.  Then each block
goes to the device in one of three splits:

* ``'full'`` (the default): the whole block encode on the device --
  sort, BWT, MTF, RLE2, group optimisation, payload packing
  (``ops.device_entropy.encode_block_full``).  The host downloads the
  payload and the small table matrices and writes the block header.
* ``'core'``: sort, BWT, MTF and RLE2 on the device
  (``ops.block_kernels.encode_block_core``); the host downloads the
  symbol stream and runs the Huffman stages (`_finish_block`).
* ``'hybrid'``: sort and BWT on the device; MTF, RLE2 and the Huffman
  stages on the host.  With ``batch=True`` every full-size block's BWT
  is one call (``ops.block_kernels.bwt_block_batch``).

The host stages run in the native runtime (``native``).  A worker
thread runs each block's device work and downloads its results, in
block order, while the calling thread runs the host stage of the block
before; both drop the GIL for their native work.  With
``self_check=True`` every block's device BWT is held against the host
transform (``host.bwt.bwtransform2``): U and pidx in ``'hybrid'``, pidx
in the others.

Every block, the short tail included, takes the device path in every
mode: the port sizes each payload from its real bit count and compiles
nothing per shape, so it needs neither the JAX encoder's host route for
odd-length blocks nor its fixed fetch buckets (``FETCH_BUCKET``) and
MTF width (``fixed_width``).  Output is byte-identical to
``compressjs_tpu.codecs.bzip2.compress_file``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..convert import block_inputs
from ..host import huffman_stages as hs
from ..host.bits import SQRTPI, WHOLEPI, BitArrayWriter, BitWriter
from ..host.bwt import bwtransform2
from ..host.crc32 import crc32_bzip2, stream_crc_combine
from ..host.mtf_rle2 import mtf_rle2
from ..host.rle1 import rle1_encode
from ..ops import block_kernels as bk
from ..ops.device_entropy import GROUP_SIZE, encode_block_full
from .profiling import stage_timer

MODES = ('full', 'core', 'hybrid')


def _split_blocks(data, block_size):
    """Host RLE1 pass: list of (packed_block, crc)."""
    out = []
    start = 0
    n = data.shape[0]
    while start < n:
        block, consumed = rle1_encode(data, start, block_size)
        if block.shape[0] == 0 or consumed == 0:
            break
        out.append((block, crc32_bzip2(data[start:start + consumed])))
        # mid-stream blocks may be short of block_size (the RLE1
        # count-byte back-off defers a byte), so stop by input position
        start += consumed
    return out


def _block_meta(block):
    """(used-byte mask, alphabet size, byte -> dense symbol remap)."""
    used = np.zeros(256, dtype=bool)
    used[block] = True
    alphabet = np.nonzero(used)[0]
    remap = np.zeros(256, dtype=np.int32)
    remap[alphabet] = np.arange(len(alphabet))
    return used, len(alphabet), remap


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


def _device_block_header(pidx, lens, n_groups, sel, count, alphabet_size,
                         used):
    """`_block_header` from the matrices encode_block_full downloads."""
    nvc = (count + GROUP_SIZE - 1) // GROUP_SIZE
    m = alphabet_size + 2
    return _block_header(pidx, used, sel[:nvc],
                         [lens[g, :m] for g in range(n_groups)])


def _finish_block(block, pidx, syms, count, freq, alphabet_size, used):
    """Host entropy stage of 'core' and 'hybrid': group optimisation,
    canonical codes and payload packing of the symbol stream.  Returns
    (header_bits, (payload_bytes, nbits))."""
    end_of_block = alphabet_size + 1
    syms = syms[:count]
    length_matrix, selectors = hs.optimize_groups(
        syms, end_of_block + 1, freq[:end_of_block + 1], ref_ties=False)
    code_matrix = np.stack([hs.canonical_codes(row)
                            for row in length_matrix])
    payload = hs.payload_bytes(syms, selectors, length_matrix, code_matrix)
    return _block_header(pidx, used, selectors, list(length_matrix)), \
        payload


def _block_bits(block, used, alphabet_size, res):
    """The host side of one block from its `_device_stage` result `res`:
    (header bits, payload bytes, payload bit count).  'full' leaves only
    the header to write; 'core' and 'hybrid' run the Huffman stages
    (and for 'hybrid' MTF and RLE2) here."""
    if res[0] == 'full':
        _, pidx, payload, bits, lens, g, sel, count = res
        return (_device_block_header(pidx, lens, g, sel, count,
                                     alphabet_size, used), payload, bits)
    if res[0] == 'core':
        _, pidx, syms, count, freq = res
    else:
        _, pidx, U = res
        alphabet = np.flatnonzero(used).astype(np.uint8)
        syms, freq = mtf_rle2(U, alphabet, alphabet_size)
        count = len(syms)
    header, (payload, bits) = _finish_block(block, pidx, syms, count, freq,
                                            alphabet_size, used)
    return header, payload, bits


class DeviceBzip2Encoder:
    """bzip2 encoder whose block transforms run on `device` ('cuda'
    unless the caller asks for 'cpu'; the CPU runs every kernel's plain
    version).  `mode` is 'full', 'core' or 'hybrid' (module docstring);
    `batch` applies to 'hybrid'; `self_check` holds every device BWT
    against the host one and raises AssertionError on a mismatch."""

    def __init__(self, level=9, mode='full', self_check=False, batch=False,
                 device='cuda'):
        if not 1 <= level <= 9:
            raise ValueError('Invalid block size multiplier')
        if mode not in MODES:
            raise ValueError('mode must be one of %s, not %r'
                             % (', '.join(MODES), mode))
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('DeviceBzip2Encoder: CUDA is not available; '
                               "pass device='cpu' to run on the CPU")
        self.level = level
        self.block_size = level * 100000 - 19
        self.mode = mode
        self.self_check = self_check
        self.batch = batch
        self._pool = None

    def _device_stage(self, block, alphabet_size, remap):
        """One block's device work, downloaded: ('full', pidx, payload,
        bits, lens, n_groups, sel, count), ('core', pidx, syms, count,
        freq) or ('hybrid', pidx, U)."""
        n = block.shape[0]
        blk, remap_t, eob = block_inputs(block, remap, alphabet_size + 1,
                                         self.device)
        if self.mode == 'full':
            pidx, payload, bits, lens, g, sel, count, _ = encode_block_full(
                blk, n, remap_t, eob)
            return ('full', int(pidx), payload.cpu().numpy(), bits,
                    lens.cpu().numpy(), g, sel.cpu().numpy(), count)
        if self.mode == 'core':
            pidx, syms, count, freq = bk.encode_block_core(blk, n, remap_t,
                                                           eob)
            count = int(count)
            return ('core', int(pidx),
                    syms[:count].cpu().numpy().astype(np.uint16), count,
                    freq.cpu().numpy().astype(np.int64))
        U, pidx = bk.bwt_block(blk, n)
        return ('hybrid', int(pidx), U.cpu().numpy())

    def _batch_stage(self, blocks):
        """'hybrid' device work of equal-length blocks in one call:
        [('hybrid', pidx, U), ...]."""
        stacked = torch.from_numpy(np.stack(blocks)).to(self.device)
        U, pidx = bk.bwt_block_batch(stacked, stacked.shape[1])
        U, pidx = U.cpu().numpy(), pidx.cpu().tolist()
        return [('hybrid', p, u) for p, u in zip(pidx, U)]

    def compress(self, data, output=None):
        """Compress bytes-like or uint8 `data`.  Returns the stream as
        bytes, or writes it to `output` (a binary file object) and
        returns `output`."""
        data = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) \
            else np.ascontiguousarray(data, dtype=np.uint8)
        blocks = _split_blocks(data, self.block_size)
        metas = [_block_meta(block) for block, _ in blocks]
        full_rows = [i for i, (b, _) in enumerate(blocks)
                     if b.shape[0] == self.block_size]
        use_batch = (self.batch and self.mode == 'hybrid'
                     and len(full_rows) > 1)
        # one worker: the device stages run in block order, each while
        # the calling thread runs the host stage of the block before
        try:
            results = []
            if use_batch:
                batch = self._worker().submit(
                    self._batch_stage, [blocks[i][0] for i in full_rows])
                row_of = {i: r for r, i in enumerate(full_rows)}
            for i, ((block, _), (_, alphabet_size, remap)) in enumerate(
                    zip(blocks, metas)):
                if use_batch and i in row_of:
                    results.append((batch, row_of[i]))
                else:
                    results.append((self._submit(block, alphabet_size,
                                                 remap), None))
            return self._assemble(blocks, metas, results, output)
        finally:
            self.close()

    def _worker(self):
        """The encoder's one worker thread, where its device work runs in
        the order it was queued."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1)
        return self._pool

    def _submit(self, block, alphabet_size, remap):
        """Queue one block's device work (`_device_stage`) on the worker
        thread, behind the blocks queued before it; returns a handle for
        `_fetch_full`.  (The JAX encoder's `_submit` dispatches the same
        work asynchronously.)"""
        return self._worker().submit(self._device_stage, block,
                                     alphabet_size, remap)

    def _fetch_full(self, handle):
        """Wait for a `_submit` handle: the block's `_device_stage`
        result.  An error of the device work is raised here."""
        return handle.result()

    def _cancel(self, handle):
        """Drop a `_submit` handle's device work if it has not started;
        False where it ran or is running (`_fetch_full` then waits for
        it)."""
        return handle.cancel()

    def close(self):
        """Drop the device work still queued, wait for the block that is
        running and end the worker thread."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def _assemble(self, blocks, metas, results, output):
        timer = stage_timer()
        out = BitWriter()
        out.write_bits(32, int.from_bytes(b'BZh' + bytes([48 + self.level]),
                                          'big'))
        stream_crc = 0
        for (block, crc), (used, alphabet_size, _), (fut, row) in zip(
                blocks, metas, results):
            with timer.stage('device wait+fetch'):
                res = fut.result() if row is None else fut.result()[row]
            if self.self_check:
                self._check_block(block, res)
            with timer.stage('host header stage' if res[0] == 'full'
                             else 'host entropy stage'):
                header, payload, bits = _block_bits(block, used,
                                                    alphabet_size, res)
            stream_crc = stream_crc_combine(stream_crc, crc)
            out.write_bits(48, WHOLEPI)
            out.write_bits(32, crc)
            out.write_bit_array(header)
            out.write_bit_array(np.unpackbits(payload, count=bits))
        out.write_bits(48, SQRTPI)
        out.write_bits(32, stream_crc)
        timer.report()
        result = out.getvalue()
        if output is None:
            return result
        output.write(result)
        return output

    def _check_block(self, block, res):
        """Hold the device BWT of `block` against the host transform."""
        n = block.shape[0]
        U_ref = np.zeros(n, dtype=np.uint8)
        pidx_ref = bwtransform2(block, U_ref, n)
        if res[0] == 'hybrid' and not np.array_equal(res[2], U_ref):
            raise AssertionError('device BWT mismatch vs host')
        if res[1] != pidx_ref:
            raise AssertionError('device pidx mismatch vs host')


def compress_file_device(data, output=None, level=9, mode='full',
                         batch=False, device='cuda'):
    """bzip2-compress `data` with the block transforms on `device`."""
    return DeviceBzip2Encoder(level, mode=mode, batch=batch,
                              device=device).compress(data, output)
