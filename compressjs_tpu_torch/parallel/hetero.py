"""Heterogeneous bzip2 encode: host cores and the card share one block
queue (counterpart of ``compressjs_tpu.parallel.hetero``).

bzip2 blocks are independent (they share only the rolling stream CRC
and the bit alignment, both of which the host handles), so the device
worker (``DeviceBzip2Encoder``'s block stages, several blocks in flight)
drains the BACK of the queue while host workers (the native host
pipeline: BWT, MTF and RLE2, Huffman stages) drain the FRONT in file
order.  The ordered assembly streams right behind the host workers and
waits on the device only for the file's tail blocks.  This is the
single-host form of the mesh's block split, with host cores standing in
for extra cards.

Three rules keep the card from lengthening the run:

1. **Self-calibrating claims.**  The device worker claims a block only
   while the host workers still have enough queue left to stay busy for
   the device's own expected service time (EWMAs of observed per-block
   times, safety-factored).  A slow device idles instead of hoarding
   blocks.
2. **A deep queue until calibrated.**  Until the device has finished two
   blocks it claims only while the queue holds at least
   ``min_queue_factor * host_workers`` blocks.
3. **Work stealing.**  A block the device has claimed but not finished
   may be recomputed by an idle host worker; the first result wins.
   That is scheduling: a stalled device costs at most the block it is
   running when the last block is assembled.  Then the device worker is
   stopped: its queued blocks are dropped, and the call waits only for
   the block in progress, whose error would still be raised.

An error of the device work is not hidden: it propagates to the caller,
as a host worker's does (the JAX package instead hands the device's
blocks back to the hosts and finishes without the card).  Output is
byte-identical to ``compressjs_tpu.codecs.bzip2.compress_file``.

Environment knobs, as in the JAX package: ``COMPRESSJS_TPU_NICE`` (the
host workers' niceness above the device worker's, default 2; 0 turns it
off), ``COMPRESSJS_TPU_HETERO_DEBUG`` (print each block's source and
times and the stats to stderr) and ``COMPRESSJS_TPU_TAIL_GUARD=0`` (drop
the claim->done latency term from the claim gate).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..convert import as_u8
from ..host.bzip2 import (StreamWriter, block_meta, block_size_of,
                          compress_block_bits, split_blocks)
from .pipeline import DeviceBzip2Encoder


class _Scheduler:
    """Shared queue + claim/steal bookkeeping (all under one lock).

    Blocks are FED INCREMENTALLY (feed/close): a feeder thread discovers
    blocks with the RLE1 split while the workers drain them, so the
    split is no serial prefix before any worker starts."""

    def __init__(self, n, host_workers, safety=1.3, min_queue_factor=8,
                 claimable=None):
        self._dq = deque(range(n))
        self._lock = threading.Lock()
        self._more = threading.Condition(self._lock)
        self.closed = n > 0   # pre-filled queues start closed
        self.total = n if n else None
        # device-claimable predicate (full-size blocks only: a short tail
        # block's service time would skew the device's EWMA)
        self.claimable = claimable if claimable is not None \
            else (lambda i: True)
        self.host_workers = max(1, host_workers)
        self.safety = safety
        # tail_guard=0 drops the claim->done latency term from the claim
        # gate (throughput condition only): work stealing makes a tail
        # overrun cost one duplicated block on an otherwise idle host
        # (string compare, not int(): a malformed value must not crash
        # compression over a tuning knob)
        self.tail_guard = 0 if os.environ.get(
            'COMPRESSJS_TPU_TAIL_GUARD') == '0' else 1
        self.min_queue = min_queue_factor * self.host_workers
        # EWMA service times (seconds/block); None until observed
        self.t_host = None
        self.t_dev = None
        # EWMA claim->done LATENCY (in-flight queue wait included): the
        # last claimed block completes about this long after its claim,
        # and the hosts must have that much queue left or they idle at
        # the file's tail waiting on the device
        self.t_dev_lat = None
        self.dev_done = 0
        self.dev_claimed = {}       # i -> True while the device owns i
        self.stopped = False        # every block assembled: claim no more
        self.stolen = set()
        self.stats = {'host': 0, 'device': 0, 'stolen': 0,
                      'dev_claims_denied': 0}

    def feed(self, i):
        """Feeder thread: block i discovered (appended in file order)."""
        with self._lock:
            self._dq.append(i)
            self._more.notify_all()

    def stop(self):
        """Every block is assembled: the device claims no more."""
        with self._lock:
            self.stopped = True

    def close(self, total):
        with self._lock:
            self.closed = True
            self.total = total
            self._more.notify_all()

    def pop_host(self):
        """Host work: next block in FILE ORDER (waiting on the feeder if
        it is still discovering blocks), else steal from the device's
        claimed-but-unfinished set."""
        with self._lock:
            while True:
                if self._dq:
                    return self._dq.popleft(), False
                if not self.closed:
                    self._more.wait()
                    continue
                for i in self.dev_claimed:
                    if i not in self.stolen:
                        self.stolen.add(i)
                        self.stats['stolen'] += 1
                        return i, True
                return None, False

    def try_claim_device(self):
        """Claim the LAST queued block for the device iff the hosts keep
        enough work to cover the device's expected service time (so a
        device claim can never idle a host worker before the queue would
        have drained anyway)."""
        with self._lock:
            q = len(self._dq)
            if q == 0 or self.stopped:
                return None
            if self.dev_done <= 1:
                # uncalibrated (or one warm sample that may include
                # first-use build time): only claim against a deep queue
                if q < self.min_queue:
                    self.stats['dev_claims_denied'] += 1
                    return None
            else:
                t_h = self.t_host if self.t_host is not None else 0.25
                # after this claim the hosts have q-1 blocks of runway;
                # it must cover both the device's pipelined service time
                # (throughput condition, with the safety factor) and the
                # full claim->done latency of this block (tail condition,
                # at margin 1.0: an overrun costs one stolen block)
                drain = (q - 1) * t_h / self.host_workers
                lat = self.t_dev_lat if self.t_dev_lat is not None \
                    else self.t_dev
                bound = self.safety * self.t_dev if self.tail_guard == 0 \
                    else max(self.safety * self.t_dev, lat)
                if self.t_dev is None or bound > drain:
                    self.stats['dev_claims_denied'] += 1
                    return None
            # unclaimable tails sit at the BACK (file end): skip past at
            # most a few of them to the first claimable block
            for off in range(1, min(q, 4) + 1):
                i = self._dq[-off]
                if self.claimable(i):
                    del self._dq[-off]
                    self.dev_claimed[i] = True
                    return i
            self.stats['dev_claims_denied'] += 1
            return None

    def queue_len(self):
        with self._lock:
            return len(self._dq)

    def host_finished(self, dt):
        with self._lock:
            self.stats['host'] += 1
            self.t_host = dt if self.t_host is None else \
                0.7 * self.t_host + 0.3 * dt

    _dev_last_finish = None

    def device_finished(self, i, t_claim):
        now = time.perf_counter()
        with self._lock:
            self.dev_claimed.pop(i, None)
            self.dev_done += 1
            self.stats['device'] += 1
            # service time of a pipelined server = gap since it last
            # produced (or since this block's claim if it sat idle);
            # claim->finish alone would count in-flight queue wait
            base = t_claim if self._dev_last_finish is None else \
                max(t_claim, self._dev_last_finish)
            dt = now - base
            self._dev_last_finish = now
            self.t_dev = dt if self.t_dev is None else \
                0.5 * self.t_dev + 0.5 * dt
            lat = now - t_claim
            self.t_dev_lat = lat if self.t_dev_lat is None else \
                0.5 * self.t_dev_lat + 0.5 * lat

    def device_abandoned(self, i):
        """The device gives up block i unfinished: requeue it unless a
        host worker already stole it."""
        with self._lock:
            self.dev_claimed.pop(i, None)
            if i not in self.stolen:
                self._dq.appendleft(i)


def warm_device(level=9, mode='full', device='cuda'):
    """Encode one text-like block (and a byte of the next) through
    ``DeviceBzip2Encoder`` on `device`, which builds the CUDA library and
    the native runtime before a timed run; returns the stream.  (The JAX
    package's fetch-bucket warm-up has nothing to warm here: the port
    compiles nothing per payload size.)"""
    block_size = block_size_of(level)
    words = (b'the quick brown fox jumps over the lazy dog ',
             b'pack my box with five dozen liquor jugs ',
             b'0123456789 abcdefghijklmnopqrstuvwxyz ')
    base = b''.join(words[i % 3] for i in range(64))
    reps = -(-(block_size + 4) // len(base))
    data = np.frombuffer(base * reps, dtype=np.uint8)[:block_size + 4]
    return DeviceBzip2Encoder(level, mode=mode, device=device).compress(data)


def hetero_compress_bzip2(data, output=None, level=9, host_workers=2,
                          device='cuda', device_inflight=5,
                          device_mode='full', safety=1.3,
                          min_queue_factor=8, _encoder_factory=None):
    """Encode `data` with `host_workers` host threads and a device worker
    on `device` ('cuda' unless the caller asks for 'cpu'; None runs the
    host workers alone) pulling blocks from one queue.  Returns the
    stream as bytes, or writes it to `output` (a binary file object) and
    returns `output`.  The device worker keeps up to `device_inflight`
    blocks queued on its encoder (``DeviceBzip2Encoder(level,
    mode=device_mode)``).  `safety` and `min_queue_factor` set the claim
    gate (module docstring).  An error of the device work is raised
    here.  After the call, ``hetero_compress_bzip2.last_stats`` holds the
    scheduler's counts: blocks encoded by the hosts and by the device,
    blocks stolen, claims denied.

    `_encoder_factory` is a test hook: it returns an object with the
    encoder's `submit` and `close` in place of the encoder."""
    if device is not None:
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("hetero_compress_bzip2: CUDA is not "
                               "available; pass device='cpu' to run on the "
                               "CPU, or device=None for the host alone")
    block_size = block_size_of(level)
    data = as_u8(data)
    blocks = []   # grows as the feeder splits (appends under the GIL;
    #               workers only index entries the scheduler handed out)
    sched = _Scheduler(
        0, host_workers, safety, min_queue_factor,
        claimable=lambda i: blocks[i][0].shape[0] == block_size)

    results = {}
    res_lock = threading.Lock()
    res_ready = threading.Condition(res_lock)
    debug = bool(os.environ.get('COMPRESSJS_TPU_HETERO_DEBUG'))
    events = []
    errors = []

    def guarded(work):
        """Run a thread's work; an error goes to the assembly loop, which
        raises it in the caller (one that is no Exception is raised in
        this thread too)."""
        try:
            work()
        except BaseException as e:
            with res_ready:
                errors.append(e)
                res_ready.notify_all()
            if not isinstance(e, Exception):
                raise

    def feeder():
        """The incremental RLE1 split, in the native runtime."""
        try:
            for block_and_crc in split_blocks(data, block_size):
                blocks.append(block_and_crc)
                sched.feed(len(blocks) - 1)
        finally:
            sched.close(len(blocks))
            with res_ready:              # wake the assembly loop so it
                res_ready.notify_all()   # can observe the close

    def publish(i, r, source, t0):
        with res_ready:
            fresh = i not in results
            if fresh:
                results[i] = r
            if debug:
                events.append((i, source, t0, time.perf_counter(), fresh))
            res_ready.notify_all()
        return fresh

    # Thread priority split (Linux: niceness is per thread, so
    # os.setpriority with who=0 affects the calling thread only).  The
    # device worker's work is short bursts of launches and downloads; on
    # a host whose every core runs a busy worker it wakes late.
    # Deprioritising the host workers a notch lets it preempt them.
    nice_spread = int(os.environ.get('COMPRESSJS_TPU_NICE', '2'))

    def renice(delta):
        # Linux only: elsewhere setpriority(PRIO_PROCESS, 0) renices the
        # whole interpreter, cumulatively and irreversibly
        if not nice_spread or delta == 0 or sys.platform != 'linux':
            return
        try:
            os.setpriority(os.PRIO_PROCESS, 0,
                           os.getpriority(os.PRIO_PROCESS, 0) + delta)
        except (OSError, AttributeError):
            pass

    def host_worker():
        renice(nice_spread)
        while True:
            i, was_steal = sched.pop_host()
            if i is None:
                return
            t0 = time.perf_counter()
            # the final bit array is built here, in the worker: the
            # ordered assembly loop is the serial stage
            r = compress_block_bits(blocks[i][0])
            if not was_steal:
                sched.host_finished(time.perf_counter() - t0)
            publish(i, r, 'steal' if was_steal else 'host', t0)

    def device_worker():
        enc = _encoder_factory() if _encoder_factory is not None \
            else DeviceBzip2Encoder(level, mode=device_mode, device=device)
        try:
            inflight = deque()
            while not sched.stopped:
                while len(inflight) < device_inflight:
                    i = sched.try_claim_device()
                    if i is None:
                        break
                    block = blocks[i][0]
                    inflight.append((i, enc.submit(block, block_meta(block)),
                                     time.perf_counter()))
                if inflight:
                    i, job, t_claim = inflight.popleft()
                    header, payload, bits = job.bits()
                    r = np.concatenate(
                        [header, np.unpackbits(payload, count=bits)])
                    sched.device_finished(i, t_claim)
                    publish(i, r, 'device', t_claim)
                    continue
                if sched.closed and sched.queue_len() == 0:
                    return
                # the queue has work (or the feeder is still discovering
                # blocks) but the claim gate says the hosts will drain it
                # first: wait and check again (after close the queue only
                # shrinks, so this ends)
                time.sleep(0.02)
            # every block is assembled: drop the queued device work, and
            # fetch the blocks that ran or are running, so their errors
            # are raised
            for job in [j for _, j, _ in inflight if not j.cancel()]:
                job.bits()
        finally:
            enc.close()

    def start(work):
        t = threading.Thread(target=guarded, args=(work,), daemon=True)
        t.start()
        return t

    start(feeder)
    dev_thread = None
    if device is not None and data.shape[0] > block_size:
        dev_thread = start(device_worker)
    host_threads = [start(host_worker) for _ in range(host_workers)]

    # ordered assembly while the workers run (host workers produce blocks
    # in file order, so this streams; only tail blocks wait on the device)
    stream = StreamWriter(level)
    i = 0
    try:
        while True:
            with res_ready:
                while i not in results and not (
                        sched.closed and sched.total is not None and
                        i >= sched.total):
                    if errors:
                        raise errors[0]
                    res_ready.wait()
                if i not in results:
                    break                    # past the last block
                bits = results.pop(i)
            stream.block(blocks[i][1], bits)
            i += 1
        stream.end()
    finally:
        # every block is assembled (or the call fails): stop the device
        # worker and wait for the block it is running, so that no launch
        # outlives the call and an error of that block is raised below
        sched.stop()
        if dev_thread is not None:
            dev_thread.join()
        hetero_compress_bzip2.last_stats = sched.stats
    for t in host_threads:
        t.join()
    if debug:
        t_min = min(e[2] for e in events) if events else 0.0
        for j, src, t0, t1, fresh in sorted(events, key=lambda e: e[3]):
            print('# blk %3d %-7s claim=%7.3f done=%7.3f dt=%6.3f%s'
                  % (j, src, t0 - t_min, t1 - t_min, t1 - t0,
                     '' if fresh else ' (dup)'), file=sys.stderr)
        print('# hetero stats: %s' % sched.stats, file=sys.stderr)
    # a device error raised after its blocks were stolen and assembled
    # still fails the call: the run may not succeed without the card
    with res_ready:
        if errors:
            raise errors[0]
    result = stream.out.getvalue()
    if output is None:
        return result
    output.write(result)
    return output
