"""bzip2 encoder with the block transforms on the GPU (counterpart of
``compressjs_tpu.parallel.pipeline.DeviceBzip2Encoder``).

The host packs RLE1 blocks and computes their CRCs, and writes the
stream around the blocks, as every bzip2 encoder of the package does
(``host.bzip2``: `split_blocks`, `block_meta`, `StreamWriter`).  Then
each block goes to the device in one of three splits (`device_stage`;
the host's side of each is `block_bits`):

* ``'full'`` (the default): the whole block encode on the device --
  sort, BWT, MTF, RLE2, group optimisation, payload packing
  (``ops.device_entropy.encode_block_full``).  The host downloads the
  payload and the small table matrices and writes the block header.
* ``'core'``: sort, BWT, MTF and RLE2 on the device
  (``ops.block_kernels.encode_block_core``); the host downloads the
  symbol stream and runs the Huffman stages (`_finish_block`, shared
  with the host codec ``host.bzip2``).
* ``'hybrid'``: sort and BWT on the device; MTF, RLE2 and the Huffman
  stages on the host.  With ``batch=True`` every full-size block's BWT
  is one call (``ops.block_kernels.bwt_block_batch``).

The host stages run in the native runtime (``native``).  A worker
thread runs each block's device work and downloads its results, in
block order; both threads drop the GIL for their native work.
`DeviceBzip2Encoder.compress` queues each block there as the split
produces it, so the worker runs block i's device stage while the
calling thread splits block i + 1; once the split ends the calling
thread collects the blocks in order, each one's host stage while the
worker runs the blocks after.  Only the batch route (``'hybrid'`` with
``batch=True``) splits the whole file before it queues anything.
`DeviceBzip2Encoder.submit` queues one block there and returns its job,
whose `bits()` gives the block's header and payload: the encoder's own
`compress` and ``parallel.hetero``'s device worker both drive it.  With
``self_check=True`` every block's device BWT is held against the host
transform (``host.bwt.bwtransform2``): U and pidx in ``'hybrid'``, pidx
in the others.

Every block, the short tail included, takes the device path in every
mode: the port sizes each payload from its real bit count and compiles
nothing per shape, so it needs neither the JAX encoder's host route for
odd-length blocks nor its fixed fetch buckets (``FETCH_BUCKET``) and
MTF width (``fixed_width``).  Output is byte-identical to
``compressjs_tpu.codecs.bzip2.compress_file``.  The host Huffman stage
reads COMPRESSJS_TPU_BZ2_REF_TIES as the JAX package does
(`_finish_block`); the device one has no such switch, so while it is set
'full' runs its tail block as 'core' and its full blocks keep the
default grouping, as the JAX encoder's do.

`DeviceBWTCEncoder` is the BWTC codec (``host.bwtc``) with the full
blocks' EOF-terminated BWT on the device.

`bwtcp_compress_device`, `bwtcl_compress_device` and
`bwtcl_decompress_device` run the BWTC-P and BWTC-L codecs' whole block
bodies on the device, the adaptive Fenwick model and the range coder
included (``ops.device_model``, ``ops.device_coder``,
``ops.device_lane``); the host writes the headers and the container.
They take the JAX package's routes of the formats: levels <= 5 (BWTC-P's
DefSum model) and short tail blocks go to the host codecs, and a block
whose device result passes its caps is coded again on the host
(``last_stats['overflow_blocks']`` counts those).
"""

from __future__ import annotations

import functools
import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..convert import as_u8, block_inputs, checked_device, coder_states
from ..host import bwt as host_bwt
from ..host import bwtc as host_bwtc
from ..host import bwtcl as host_bwtcl
from ..host import bwtcp as host_bwtcp
from ..host.bwt import bwtransform2
from ..host.bzip2 import (StreamWriter, _block_header, _finish_block,
                          _ref_ties_default, block_meta, block_size_of,
                          split_blocks)
from ..host.mtf_rle2 import mtf_rle2
from ..host.range_coder import RangeCoder
from ..host.stream import (ArrayInputStream, BufferStream,
                           coerce_output_stream)
from ..host.util import compress_file_helper, read_unsigned_number
from ..ops import block_kernels as bk
from ..ops import device_coder as dc
from ..ops import device_lane as dl
from ..ops import device_model as dm
from ..ops.device_entropy import GROUP_SIZE, encode_block_full
from .profiling import stage_timer

MODES = ('full', 'core', 'hybrid')


def _device_block_header(pidx, lens, n_groups, sel, count, alphabet_size,
                         used):
    """`_block_header` from the matrices encode_block_full downloads."""
    nvc = (count + GROUP_SIZE - 1) // GROUP_SIZE
    m = alphabet_size + 2
    return _block_header(pidx, used, sel[:nvc],
                         [lens[g, :m] for g in range(n_groups)])


def device_stage(block, meta, mode, device, index=None):
    """One block's device work in `mode` on `device`, downloaded:
    ('full', pidx, payload, bits, lens, n_groups, sel, count), ('core',
    pidx, syms, count, freq) or ('hybrid', pidx, U).  `meta` is the
    block's ``host.bzip2.block_meta``; `index`, the block's place in the
    stream, labels its stages."""
    _, alphabet_size, remap = meta
    timer = stage_timer()
    with timer.stage('encode.device', index):
        n = block.shape[0]
        with timer.stage('encode.upload', index):
            blk, remap_t, eob = block_inputs(block, remap, alphabet_size + 1,
                                             device)
        if mode == 'full':
            pidx, payload, bits, lens, g, sel, count, _ = \
                encode_block_full(blk, n, remap_t, eob)
            with timer.stage('encode.wait', index):
                res = ('full', int(pidx), payload.cpu().numpy(), bits,
                       lens.cpu().numpy(), g, sel.cpu().numpy(), count)
            timer.add('host_syncs', 4)
        elif mode == 'core':
            pidx, syms, count, freq = bk.encode_block_core(
                blk, n, remap_t, eob)
            with timer.stage('encode.wait', index):
                count = int(count)
                res = ('core', int(pidx),
                       syms[:count].cpu().numpy().astype(np.uint16),
                       count, freq.cpu().numpy().astype(np.int64))
            timer.add('host_syncs', 4)
        else:
            U, pidx = bk.bwt_block(blk, n)
            with timer.stage('encode.wait', index):
                res = ('hybrid', int(pidx), U.cpu().numpy())
            timer.add('host_syncs', 2)
    return res


def block_bits(block, meta, res):
    """The host side of one block from its `device_stage` result `res`:
    (header bits, payload bytes, payload bit count).  'full' leaves only
    the header to write; 'core' and 'hybrid' run the Huffman stages
    (and for 'hybrid' MTF and RLE2) here."""
    used, alphabet_size, _ = meta
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


class _BlockJob:
    """One block queued on a `DeviceBzip2Encoder` (its `submit`)."""

    def __init__(self, enc, block, meta, future, row=None):
        self._enc, self._block, self._meta = enc, block, meta
        self._future, self._row = future, row

    def cancel(self):
        """Drop the block's device work if it has not started; False where
        it ran or is running (`bits` then waits for it)."""
        return self._future.cancel()

    def done(self):
        """Whether the block's device work has ended (or was dropped)."""
        return self._future.done()

    def bits(self):
        """Wait for the block's device work and run its host stage:
        (header bits, payload bytes, payload bit count).  An error of the
        device work is raised here."""
        timer = stage_timer()
        with timer.stage('device wait+fetch'):
            res = self._future.result()
            if self._row is not None:
                res = res[self._row]
        if self._enc.self_check:
            self._enc._check_block(self._block, res)
        with timer.stage('host header stage' if res[0] == 'full'
                         else 'host entropy stage'):
            return block_bits(self._block, self._meta, res)


class DeviceBzip2Encoder:
    """bzip2 encoder whose block transforms run on `device` ('cuda'
    unless the caller asks for 'cpu'; the CPU runs every kernel's plain
    version).  `mode` is 'full', 'core' or 'hybrid' (module docstring);
    `batch` applies to 'hybrid'; `self_check` holds every device BWT
    against the host one and raises AssertionError on a mismatch."""

    def __init__(self, level=9, mode='full', self_check=False, batch=False,
                 device='cuda'):
        self.block_size = block_size_of(level)
        if mode not in MODES:
            raise ValueError('mode must be one of %s, not %r'
                             % (', '.join(MODES), mode))
        self.device = checked_device(device, 'DeviceBzip2Encoder')
        self.level = level
        self.mode = mode
        self.self_check = self_check
        self.batch = batch
        self._pool = None

    def _device_stage(self, block, meta, index=None):
        """`device_stage` in the encoder's mode.  While
        COMPRESSJS_TPU_BZ2_REF_TIES is set, 'full' runs the short tail
        block as 'core', so that its Huffman stage takes the reference's
        grouping on the host (the device group optimisation has no such
        switch, in either package; the JAX encoder sends the tail to the
        host)."""
        mode = self.mode
        if (mode == 'full' and block.shape[0] != self.block_size
                and _ref_ties_default()):
            mode = 'core'
        return device_stage(block, meta, mode, self.device, index)

    def _batch_stage(self, blocks):
        """'hybrid' device work of equal-length blocks in one call:
        [('hybrid', pidx, U), ...]."""
        timer = stage_timer()
        with timer.stage('encode.device'):
            with timer.stage('encode.upload'):
                stacked = torch.from_numpy(np.stack(blocks)).to(self.device)
            U, pidx = bk.bwt_block_batch(stacked, stacked.shape[1])
            with timer.stage('encode.wait'):
                U, pidx = U.cpu().numpy(), pidx.cpu().tolist()
            timer.add('host_syncs', 2)
        return [('hybrid', p, u) for p, u in zip(pidx, U)]

    def compress(self, data, output=None):
        """Compress bytes-like or uint8 `data`.  Returns the stream as
        bytes, or writes it to `output` (a binary file object) and
        returns `output`.

        Each block is queued on the worker as the split produces it (its
        RLE1 pass and CRC, then its `block_meta`), so the worker runs
        block i's device stage while this thread splits block i + 1;
        once the split ends the jobs are collected in order.  Only the
        batch route ('hybrid' with ``batch=True``) splits the whole file
        first, since its one device call takes every full block.  An
        error of the split, a meta or a device stage is raised here, and
        the device work still queued is dropped."""
        data = as_u8(data)
        try:
            if self.batch and self.mode == 'hybrid':
                crcs, jobs = self._queue_batch(data)
            else:
                crcs, jobs = self._queue_streamed(data)
            return self._assemble(crcs, jobs, output)
        finally:
            self.close()

    def _queue_streamed(self, data):
        """Split `data` block by block and queue each block at once:
        (the blocks' CRCs, their jobs)."""
        timer = stage_timer()
        blocks = split_blocks(data, self.block_size)
        crcs, jobs = [], []
        while True:
            i = len(jobs)
            with timer.stage('encode.split', i):
                item = next(blocks, None)
            if item is None:
                return crcs, jobs
            block, crc = item
            with timer.stage('encode.queue', i):
                meta = block_meta(block)
                busy = bool(jobs) and not jobs[-1].done()
                jobs.append(self.submit(block, meta, i))
                timer.add('encode_submits')
                timer.add('encode_submits_busy', int(busy))
            crcs.append(crc)

    def _queue_batch(self, data):
        """The batch route: split the whole file, then queue every
        full block's BWT as one call and any other block alone."""
        timer = stage_timer()
        with timer.stage('encode.split'):
            blocks = list(split_blocks(data, self.block_size))
        with timer.stage('encode.queue'):
            metas = [block_meta(block) for block, _ in blocks]
            full_rows = [i for i, (b, _) in enumerate(blocks)
                         if b.shape[0] == self.block_size]
            row_of = {}
            if len(full_rows) > 1:
                batch = self._worker().submit(
                    self._batch_stage, [blocks[i][0] for i in full_rows])
                row_of = {i: r for r, i in enumerate(full_rows)}
            jobs = [_BlockJob(self, block, meta, batch, row_of[i])
                    if i in row_of else self.submit(block, meta, i)
                    for i, ((block, _), meta) in enumerate(
                        zip(blocks, metas))]
        return [crc for _, crc in blocks], jobs

    def _worker(self):
        """The encoder's one worker thread, where its device work runs in
        the order it was queued."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1)
        return self._pool

    def submit(self, block, meta, index=None):
        """Queue the device work of `block` (RLE1-packed; `meta` its
        ``host.bzip2.block_meta``) on the worker thread, behind the blocks
        queued before it.  Returns its job: `bits()` waits for it and
        gives the block's header bits, payload bytes and payload bit
        count; `cancel()` drops it if it has not started.  (The JAX
        encoder's `_submit` dispatches the same work asynchronously.)"""
        return _BlockJob(self, block, meta, self._worker().submit(
            self._device_stage, block, meta, index))

    def close(self):
        """Drop the device work still queued, wait for the block that is
        running and end the worker thread."""
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def _assemble(self, crcs, jobs, output):
        timer = stage_timer()
        with timer.stage('encode.write'):
            stream = StreamWriter(self.level)
        for crc, job in zip(crcs, jobs):
            header, payload, bits = job.bits()
            with timer.stage('encode.write'):
                stream.block(crc, header, np.unpackbits(payload, count=bits))
        with timer.stage('encode.write'):
            result = stream.end().getvalue()
            if output is not None:
                output.write(result)
        timer.report()
        return result if output is None else output

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


class DeviceBWTCEncoder:
    """BWTC encoder with each full block's EOF-terminated BWT
    (``ops.block_kernels.bwt_eof_block``) on `device` ('cuda' unless the
    caller asks for 'cpu').  The codec's range coder spans every block,
    so the coding is sequential, but each block's BWT is independent:
    one worker thread runs the full blocks' BWTs on the device, in
    order, and downloads them while the codec (``host.bwtc``) codes the
    blocks before.  The short tail block takes the host transform
    (``host.bwt.bwtransform``).  Output is byte-identical to
    ``host.bwtc.BWTC.compress_file`` (and to the JAX package's
    ``BWTC.compress_file``)."""

    def __init__(self, level=9, device='cuda'):
        if not 1 <= level <= 9:
            raise ValueError('invalid level')
        self.device = checked_device(device, 'DeviceBWTCEncoder')
        self.level = level
        self.block_size = level * 100000

    def _device_bwt(self, block):
        U, pidx = bk.bwt_eof_block(
            torch.from_numpy(block.copy()).to(self.device), block.shape[0])
        return U.cpu().numpy(), int(pidx)

    def compress(self, data, output=None):
        """Compress bytes-like or uint8 `data`.  Returns the stream as a
        uint8 array, or writes it to `output` (a stream with write_byte,
        see ``host.stream``) and returns `output`.  No worker outlives
        the call: the device work still queued is dropped and the block
        that runs is waited for."""
        data = as_u8(data)
        bs = self.block_size

        # the codec's transform pool calls the hook from several threads
        # in no fixed order, so each result is keyed by a digest of its
        # block's bytes (two equal blocks share one result: same BWT)
        def block_key(a):
            return hashlib.blake2b(a, digest_size=32).digest()

        pool = ThreadPoolExecutor(1)
        futures = {}
        for b in range(len(data) // bs):
            blk = data[b * bs:(b + 1) * bs]
            key = block_key(blk)
            if key not in futures:
                futures[key] = pool.submit(self._device_bwt, blk)

        def bwt_hook(T, U, A, n, alphabet_size=256):
            fut = futures.get(block_key(T)) if n == bs else None
            if fut is None:
                return host_bwt.bwtransform(T, U, A, n, alphabet_size)
            U[:n], pidx = fut.result()
            return pidx

        token = host_bwtc._BWT_HOOK.set(bwt_hook)
        try:
            return host_bwtc.BWTC.compress_file(data, output, self.level)
        finally:
            host_bwtc._BWT_HOOK.reset(token)
            pool.shutdown(wait=True, cancel_futures=True)


def _container(magic, level, payloads, data, output):
    """The codec's container around the block streams (the host codecs'
    helper, so the bytes are theirs by construction)."""
    def guts(in_stream, out_stream, file_size, props, final_byte):
        host_bwtcp.write_container_body(out_stream, level, payloads)
    return compress_file_helper(magic, guts)(data, output, level)


def _bwtcp_tok_cap(bs):
    """Tokens a BWTC-P lane may emit on the device: every token writes at
    least one byte, so a block stream of up to bs + bs/4 + 64 bytes fits;
    a block that passes it is coded again on the host."""
    return bs + (bs >> 2) + 64


def _bwtcp_group(blocks, level, dev, first=0):
    """The per-block work of one dispatch of full blocks, on the calling
    thread: per block the card runs the EOF BWT, MTF and RLE2, and the
    host (`bwtcp.head`) codes the header on the block's fresh coder and
    hands its state over.  Returns the coder's inputs (`_bwtcp_code`):
    the headers' bytes, and the lanes' symbols, valid steps, model sizes
    and coder states on `dev`.  `first` is the first block's index in
    the file (the stages' label)."""
    timer = stage_timer()
    bs = blocks[0].shape[0]
    heads, states, Ns, rows, counts = [], [], [], [], []
    for k, b in enumerate(blocks):
        blk = torch.from_numpy(b.copy()).to(dev)
        timer.add('host_syncs')             # an upload from pageable memory
        U, pidx = bk.bwt_eof_block(blk, bs)
        with timer.stage('bwtcp.head', first + k):
            used, asize, remap = block_meta(b)
            remap = torch.from_numpy(remap).to(dev)
            out = BufferStream()
            enc = RangeCoder(out)
            enc.encode_start(0, 0)
            host_bwtcp._write_header(enc, level, bs, int(pidx), used)
            heads.append(out.get_buffer())
            states.append(enc.export_enc_state())
            Ns.append(asize + 2)              # model size asize + 1
        timer.add('host_syncs', 2)          # the remap's upload, pidx read
        dense = remap[U.to(torch.int64)]
        syms, cnt, _ = bk.rle2_encode(bk.mtf_encode(dense.to(torch.int32),
                                                    bs), bs, 0)
        rows.append(syms)
        counts.append(cnt)
    T = bs + 1
    syms = torch.stack(rows).to(torch.int32)
    valid = torch.arange(T, device=dev)[None, :] < \
        (torch.stack(counts) - 1)[:, None]     # without the EOB slot
    del rows
    Ns = torch.tensor(Ns, dtype=torch.int32, device=dev)
    states = coder_states(np.stack(states), dev)
    timer.add('host_syncs', 2)              # two uploads from pageable memory
    return heads, syms, valid, Ns, states


@functools.lru_cache(maxsize=None)
def _side_stream(index):
    """The CUDA stream of the BWTC-P coder jobs on card `index`, one for
    the process: the caching allocator keeps a stream's freed blocks for
    that stream, so a new stream each call would allocate the jobs'
    buffers anew, call after call."""
    return torch.cuda.Stream(index)


def _bwtcp_code(heads, syms, valid, Ns, states, side=None, ready=None):
    """The coder's part of one dispatch, on the encoder's worker thread:
    one launch of the fused model and coder codes every block's body as
    a lane, and `bwtcp.fetch` reads the streams back.  On the card it
    runs on the CUDA stream `side`, behind the event `ready` that the
    calling thread recorded after `_bwtcp_group`; the job holds the
    inputs until its read-backs have returned.  Returns the block
    streams, None for a block whose tokens or bytes pass their caps."""
    timer = stage_timer()
    bs = syms.shape[1] - 1
    tok_cap = _bwtcp_tok_cap(bs)
    with torch.cuda.stream(side):
        if ready is not None:
            side.wait_event(ready)
        tokens, tok_n, nbytes = dm.fenwick_code_streams(
            syms, valid, Ns, dl.MAX_N, host_bwtcp.F_PROB_MAX,
            host_bwtcp.F_PROB_INCR, states, tok_cap)
        with timer.stage('bwtcp.fetch'):
            out_cap = bs + (bs >> 1) + 4096
            byts, lens = dc.token_bytes(tokens, tok_n, nbytes, out_cap)
            del tokens
            tok_n, lens = tok_n.cpu().tolist(), lens.cpu().tolist()
            byts = byts[:, :min(max(lens), out_cap)].cpu().numpy()
            timer.add('host_syncs', 3)
            return [None if tok_n[k] > tok_cap or lens[k] > out_cap else
                    np.concatenate([heads[k], byts[k, :lens[k]]])
                    for k in range(len(heads))]


def bwtcp_compress_device(data, output=None, level=9, batch=8,
                          device='cuda'):
    """BWTC-P encode with each full block's whole body on `device`
    ('cuda' unless the caller asks for 'cpu'): EOF BWT, MTF, RLE2, the
    adaptive Fenwick model and the range coder, `batch` blocks a
    dispatch as the model's and coder's lanes, each continuing the coder
    the host started with the block's header.  Levels <= 5 (DefSum
    blocks) take the host codec, and so do the short tail block and a
    block that passes its token or byte cap.  Byte for byte
    ``host.bwtcp.BWTCP.compress_file``.  Returns the stream (uint8
    array), or writes it to `output` (a stream with write_byte) and
    returns it.  ``bwtcp_compress_device.last_stats`` counts the blocks
    of the last call by route.

    One worker thread codes the dispatches in order (`_bwtcp_code`, on
    a side stream on the card) while this thread issues the next
    dispatch's blocks and then codes the tail on the host; the jobs are
    collected in order, and an error of one is raised before anything
    is written.  No worker outlives the call."""
    timer = stage_timer()
    with timer.stage('bwtcp.split'):
        dev = checked_device(device, 'bwtcp_compress_device')
        level = host_bwtcp._level_of(level)
        data = as_u8(data)
        bs = level * 100000
        blocks = host_bwtcp.split_blocks(data, bs)
        full = [i for i, b in enumerate(blocks) if b.shape[0] == bs]
    stats = {'device_blocks': 0, 'host_blocks': 0, 'overflow_blocks': 0}
    bwtcp_compress_device.last_stats = stats
    if level <= 5:
        stats['host_blocks'] = len(blocks)
        with timer.stage('bwtcp.host_block'):
            result = host_bwtcp.BWTCP.compress_file(data, output, level)
        timer.report()
        return result
    payloads = [None] * len(blocks)
    side = (_side_stream(torch.cuda.current_device() if dev.index is None
                         else dev.index) if dev.type == 'cuda' else None)
    pool = ThreadPoolExecutor(1)
    jobs = []
    try:
        for g in range(0, len(full), batch):
            idxs = full[g:g + batch]
            with timer.stage('bwtcp.group', g // batch):
                coder_in = _bwtcp_group([blocks[i] for i in idxs], level,
                                        dev, idxs[0])
                ready = None
                if side is not None:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(dev))
                jobs.append((idxs, pool.submit(_bwtcp_code, *coder_in,
                                               side, ready)))
                del coder_in
            timer.add('coder_dispatches')
        for i, b in enumerate(blocks):
            if b.shape[0] != bs:
                stats['host_blocks'] += 1
                with timer.stage('bwtcp.host_block', i):
                    payloads[i] = host_bwtcp._encode_block(b, level)
        for g, (idxs, job) in enumerate(jobs):
            if not job.done():
                timer.add('coder_waits')
            with timer.stage('bwtcp.wait', g):
                streams = job.result()
            for i, p in zip(idxs, streams):
                payloads[i] = p
                stats['device_blocks' if p is not None
                      else 'overflow_blocks'] += 1
    finally:
        pool.shutdown(cancel_futures=True)
    for i in full:
        if payloads[i] is None:
            with timer.stage('bwtcp.host_block', i):
                payloads[i] = host_bwtcp._encode_block(blocks[i], level)
    with timer.stage('bwtcp.write'):
        result = _container(host_bwtcp.MAGIC, level, payloads, data, output)
    timer.report()
    return result


bwtcp_compress_device.last_stats = {}


def bwtcl_compress_device(data, output=None, level=9, lanes=None,
                          device='cuda'):
    """BWTC-L encode with each full block's whole body on `device`
    ('cuda' unless the caller asks for 'cpu'): EOF BWT, MTF, RLE2 and the
    `lanes` (default ``host.bwtcl.LANES``) Fenwick models and range
    coders (``ops.device_lane.encode_block_lanes``); the host writes the
    headers and the container.  The short tail block, a block of fewer
    RLE2 symbols than lanes (the format records fewer lanes for it) and
    a block that passes its caps take the host codec.  Byte for byte
    ``host.bwtcl.BWTCL.compress_file``.  Returns as
    `bwtcp_compress_device`; ``bwtcl_compress_device.last_stats`` counts
    the blocks of the last call by route.  One block at a time, on the
    calling thread."""
    timer = stage_timer()
    with timer.stage('bwtcl_enc.split'):
        dev = checked_device(device, 'bwtcl_compress_device')
        lanes = lanes or host_bwtcl.LANES
        level = host_bwtcp._level_of(level)
        data = as_u8(data)
        bs = level * 100000
        _, tok_cap, lane_cap = dl.lane_caps(bs, lanes)
        flat_cap = bs + (bs >> 1) + 4096
        blocks = host_bwtcp.split_blocks(data, bs)
    stats = {'device_blocks': 0, 'host_blocks': 0, 'overflow_blocks': 0}
    bwtcl_compress_device.last_stats = stats
    payloads = []
    for i, b in enumerate(blocks):
        route = 'host_blocks'
        if b.shape[0] == bs:
            with timer.stage('bwtcl_enc.head', i):
                used, asize, remap = block_meta(b)
                blk = torch.from_numpy(b.copy()).to(dev)
                remap = torch.from_numpy(remap).to(dev).to(torch.int64)
            timer.add('host_syncs', 2)  # uploads from pageable memory
            with timer.stage('bwtcl_enc.launch', i):
                pidx, S, lens, flat, total, max_tok = dl.encode_block_lanes(
                    blk, bs, lanes, remap, asize)
            with timer.stage('bwtcl_enc.fetch', i):
                S, total, max_tok = int(S), int(total), int(max_tok)
                lens = lens.cpu().tolist()
                timer.add('host_syncs', 4)
                if S >= lanes:              # else the format's fewer lanes
                    route = ('overflow_blocks' if max_tok > tok_cap
                             or total > flat_cap or max(lens) > lane_cap
                             else 'device_blocks')
                if route == 'device_blocks':
                    payloads.append(np.concatenate([
                        host_bwtcl.block_head(bs, int(pidx), S, lanes, used,
                                              lens),
                        flat[:total].cpu().numpy()]))
                    timer.add('host_syncs', 2)
        stats[route] += 1
        if route != 'device_blocks':
            with timer.stage('bwtcl_enc.host_block', i):
                payloads.append(host_bwtcl.encode_block(b, lanes))
    with timer.stage('bwtcl_enc.write'):
        result = _container(host_bwtcl.MAGIC, level, payloads, data, output)
    timer.report()
    return result


bwtcl_compress_device.last_stats = {}


def bwtcl_decompress_device(data, output=None, device='cuda'):
    """BWTC-L decode with each full block's body on `device` ('cuda'
    unless the caller asks for 'cpu'): the lanes' Fenwick models and range
    decoders, RLE2 and MTF undo and the inverse EOF BWT
    (``ops.device_lane.decode_block_lanes``), at any lane count; the host
    parses the container and the headers.  A short block, and a block
    whose lane streams pass the lane byte cap, take the host decoder.
    Returns the bytes (uint8 array), or writes them to `output` and
    returns it; raises ValueError on a bad magic or a block that does not
    expand to its length.  ``bwtcl_decompress_device.last_stats`` counts
    the blocks of the last call by route."""
    timer = stage_timer()
    with timer.stage('bwtcl.container'):
        dev = checked_device(device, 'bwtcl_decompress_device')
        ins = ArrayInputStream(as_u8(data))
        for ch in host_bwtcl.MAGIC:
            if ins.read_byte() != ord(ch):
                raise ValueError('bad magic')
        read_unsigned_number(ins)                     # file size + 1
        level, payloads = host_bwtcp.read_container_body(ins)
    bs = level * 100000
    stats = {'device_blocks': 0, 'host_blocks': 0, 'overflow_blocks': 0}
    bwtcl_decompress_device.last_stats = stats
    results = []
    for p in payloads:
        with timer.stage('bwtcl.header'):
            length, pidx, S, lanes, used, lane_payloads = \
                host_bwtcl.parse_block_header(p)
            lane_cap = dl.lane_caps(bs, lanes)[2]
            route = 'device_blocks'
            if length != bs:
                route = 'host_blocks'
            elif max(len(x) for x in lane_payloads) > lane_cap:
                route = 'overflow_blocks'
        if route != 'device_blocks':
            stats[route] += 1
            with timer.stage('bwtcl.host_block'):
                results.append(host_bwtcl.decode_block(p))
            continue
        with timer.stage('bwtcl.stage'):
            paymat = np.zeros((lanes, lane_cap), dtype=np.uint8)
            for l, lp in enumerate(lane_payloads):
                paymat[l, :len(lp)] = lp
            alphabet = np.flatnonzero(used)
            sym_map = np.zeros(256, dtype=np.int64)
            sym_map[:len(alphabet)] = alphabet
            paymat = torch.from_numpy(paymat).to(dev)
            sym_map = torch.from_numpy(sym_map).to(dev)
        timer.add('host_syncs', 2)  # uploads from pageable memory
        with timer.stage('bwtcl.launch'):
            out, total = dl.decode_block_lanes(paymat, bs, lanes, S, pidx,
                                               len(alphabet), sym_map)
        with timer.stage('bwtcl.wait'):
            total = int(total)
            out = out.cpu().numpy()
        timer.add('host_syncs', 2)
        if total != bs:
            raise ValueError('BWTC-L block expands to %d bytes, not %d'
                             % (total, bs))
        stats['device_blocks'] += 1
        results.append(out)
    with timer.stage('bwtcl.write'):
        o = coerce_output_stream(output)
        for r in results:
            o.stream.write(r, 0, len(r))
        result = o.retval
    timer.report()
    return result


bwtcl_decompress_device.last_stats = {}
