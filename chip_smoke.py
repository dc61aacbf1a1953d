#!/usr/bin/env python3
"""Smoke test of compressjs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``compressjs_tpu_torch/csrc``, prints the
MTF kernels' registers and stack frames, holds each kernel equal to its
plain version on the card at main-path shapes (the MTF encode's three
launches and its start lists on sample5's first block and on uniform
symbols, the sorts' and RLE2's max-scans (``csrc/seg_scan.cu``) against
``torch.cummax`` at 899,981 and 8 x 899,981 elements, each timed beside
its byte bound and the library call, the Huffman allocator on sorted
tables and the fused table build, windowed compose, the staged selector
chase at k = 10 and at the default k on sample5's first block and on
every block of the sample5x4 decode, the walk's two kernels (stages 1
and 4, ``cz_walk_maps`` and ``cz_chunk_walk``) on sample5's first block
and on a block at the largest caps of a -9 block, each beside the whole
walk with its plain stages, the MTF undo's three launches and its start
lists on sample5's first block and on zipf indices), times each MTF
launch at 132, 528 and
all chunks and each whole MTF stage with its launches a call, times the
latency probes that floor the chase and
the allocator (one thread's chain from L2 and from shared memory, one
SM's staging rate), counts the group optimisation's launches and
syncing reads per block with the fused build and with the build it
replaced, builds the native host runtime with g++ and holds each of its
entries equal to its numpy twin on every sample5x4 block (timing both)
and its two sort pairs equal on sample5x4's first block (the two-stage
suffix sort against SA-IS, the direct rotation sort against SA-IS on
the doubled string; each sort timed),
re-encodes the in-repo bzip2 goldens at -9 through
``compress_file_device`` in every encoder split ('full', the main path;
'core', 'hybrid', 'hybrid' with one batched BWT, 'hybrid' with
self_check), each with the kernel launches its split must make, decodes
them through ``decompress_file_device``, decodes a stream whose magic
scan reports a false end magic inside a payload, checks the bytes;
then the multi-block paths: in an NCCL process group of one rank (a
FileStore, no network) ``mesh_compress_bzip2`` of sample5x4 against the
golden and ``decompress_file_mesh`` with host and device entropy, each
with the kernel launches it must make, and ``sharded_block_decode`` of
sample5x4's BWT columns; ``decompress_file_parallel`` of both goldens
and the native host block decode against its numpy twins;
``hetero_compress_bzip2`` of sample5x4 tiled three times against
``compress_file_device``'s stream, failing unless the device worker
encoded blocks.  Then the BWTC paths: the EOF-terminated BWT on the card
(``bwt_eof_block`` and its inverse) against the native ``cz_bwt_eof`` on
sample5's first 900,000 bytes, random bytes and zeros;
``DeviceBWTCEncoder`` against the host BWTC codec on sample5x4 at -9 and
sample5 at -1; in the NCCL group, ``sharded_bwt_eof`` and
``sharded_block_decode(eof=True)`` of sample5x4's full blocks, and the
context-parallel ``sharded_cyclic_suffix_sort`` of a 2^20-byte slice
against the host rotation sort; and with COMPRESSJS_TPU_BZ2_REF_TIES=1
the 'core' and 'hybrid' encodes of sample5x4 against the hosts-only
hetero encode.  Then the BWTC-P and BWTC-L formats: the Fenwick model's
encode (alone, and fused with the range coder: the paths' kernel) and
decode scans and the range coder's against their plain versions on
sample5's first -9 block as BWTC-L's 128 lanes, on the first 4,096
steps of its BWTC-P lane and on random lanes with a low max_prob, and
alone on the whole BWTC-P lane and on the 8-lane BWTC-P dispatch of
sample5x4, where the fused entry equals the unfused two in series (and
on that dispatch coded from fresh coder states, which the decode
decodes back to its symbols);
``bwtcp_compress_device`` and ``bwtcl_compress_device`` of sample5x4 at
-9 against the host codecs, ``bwtcl_decompress_device`` back, and in
the NCCL group ``mesh_compress_bwtcp``.  Then the command line
(``compressjs_tpu_torch.cli``): in this process -z -t bzip2 -9 of
sample5x4 against its golden (mtf_scan and code_lengths launched) and
-d back, -z -t bwtcp -9 (fenwick_code launched) and -z -t bwtc -9
against the host codecs' bytes, every host codec's round trip of
sample5 at level 7, and -d of two corrupt sample5 streams, which must
exit 1 with the JAX command line's stderr line; and one ``python -m
compressjs_tpu_torch.cli`` subprocess, -z -t bzip2 -9 of sample5 from
stdin to stdout against its golden.  It times the encode in each split
(wall and the card's idle share), the decode, each multi-block path,
each BWTC path and each kernel, and prints:

* the card's name and power limit, as nvidia-smi reports them;
* one JSON line ``{"kernels": [...]}`` with each kernel's launches on
  the main-path run, error against its plain version, times and bound;
* last, ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero.  Without a CUDA
card it exits non-zero before printing any result.
"""

import bz2
import contextlib
import faulthandler
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden')

# H100 SXM peaks: HBM bandwidth (NVIDIA data sheet), and the rate of
# 32-bit integer operations, which is what every kernel here does: 64
# INT32 lanes per SM x 132 SMs x 1.98 GHz (the data sheet's 67e12 is the
# FP32 rate, 128 lanes per SM)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 64 * 132 * 1.98e9


def phase(name):
    print('== %s' % name, flush=True)


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def golden(name):
    with open(os.path.join(GOLDEN, name), 'rb') as f:
        comp = f.read()
    return comp, bz2.decompress(comp)


def cuda_ms(fn, reps):
    """Mean device milliseconds of fn() over reps launches, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def cuda_ms_cold(fn, reps, dev):
    """Mean device milliseconds of one fn() launch with a cold L2: 256
    MB (five times the H100's 50 MB L2) are written between launches,
    outside the timed pair of events."""
    scrub = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    pairs = []
    fn()
    for _ in range(reps):
        scrub.fill_(len(pairs))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        pairs.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def bound(nbytes, nops):
    """(least milliseconds for the work, what sets it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def first_block_bwt(data, dev):
    """Dense-alphabet BWT of the first -9 block of `data` on the card:
    the MTF kernel's input on the main path."""
    from compressjs_tpu_torch.host.rle1 import rle1_encode
    from compressjs_tpu_torch.ops.block_kernels import bwt_block
    from compressjs_tpu_torch.host.bzip2 import block_meta
    block, _ = rle1_encode(np.frombuffer(data, np.uint8), 0, 899981)
    _, _, remap = block_meta(block)
    U, _ = bwt_block(torch.from_numpy(block).to(dev), block.shape[0])
    return torch.from_numpy(remap).to(dev)[U.long()].to(torch.int32)


def ptxas_frames(log, names):
    """{kernel name: (registers, stack frame bytes)} from nvcc's -Xptxas -v
    lines, for each entry function whose mangled name holds one of
    `names`."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = next((nm for nm in names if nm in m.group(1)), None)
            continue
        if cur is None:
            continue
        m = re.search(r'(\d+) bytes stack frame', line)
        if m:
            out.setdefault(cur, [None, None])[1] = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            out.setdefault(cur, [None, None])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def kernels_launched(fn):
    """Device kernels one call of fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith('Memcpy')
               and not e.name.startswith('Memset'))


def stage(fn, counter):
    """The whole MTF stage: device ms per call (CUDA events over 20
    calls back to back), the package's launch count for one call and the
    device kernels torch.profiler sees in one call."""
    from compressjs_tpu_torch.ops import _cuda
    ms = cuda_ms(fn, 20)
    before = _cuda.launches[counter]
    fn()
    counted = _cuda.launches[counter] - before
    return {'stage_ms': ms, 'launches_per_call': counted,
            'kernels_per_call': kernels_launched(fn)}


def occupancy(launch, n_chunks, counts=(132, 528)):
    """ms of launch(chunks) at a few chunk counts (the warps per SM grow
    with them) and at all n_chunks."""
    return {c: cuda_ms(lambda: launch(c), 20)
            for c in list(counts) + [n_chunks]}


def check_mtf(dense):
    """The three encode launches against the plain encode and the plain
    start lists on one input; returns a dict of errors and times."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import block_kernels as bk
    n = dense.shape[0]
    got = bk.mtf_encode(dense, n)
    want = bk.mtf_encode_plain(dense, n)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dense.device)
    n_chunks = -(-n // bk.CHUNK_LEN)
    n_tiles = -(-n_chunks // bk.TILE_CHUNKS)
    agg = torch.empty((n_tiles, 256), dtype=torch.int32, device=dense.device)
    pre = torch.empty_like(agg)
    out = torch.empty_like(dense)

    # the kernels alone, outside the wrapper
    def tiles(c=n_chunks):
        _cuda.check(lib.cz_mtf_encode_tiles(
            dense.data_ptr(), agg.data_ptr(), min(n, c * bk.CHUNK_LEN), c,
            stream), 'mtf_scan')

    def prefix(c=n_chunks):
        _cuda.check(lib.cz_mtf_encode_prefix(
            agg.data_ptr(), pre.data_ptr(), -(-c // bk.TILE_CHUNKS), stream),
            'mtf_scan')

    def step(c=n_chunks):
        _cuda.check(lib.cz_mtf_encode(
            dense.data_ptr(), pre.data_ptr(), out.data_ptr(),
            min(n, c * bk.CHUNK_LEN), c, stream), 'mtf_scan')

    def all_three():
        tiles()
        prefix()
        step()

    ms = cuda_ms(all_three, 20)
    # the start lists: each tile's last occurrences and their prefix
    # against the plain exclusive scan (padding counted only below n)
    last = np.full((n_tiles * bk.TILE_CHUNKS, 256), -1, dtype=np.int64)
    np.maximum.at(last, (np.arange(n) // bk.CHUNK_LEN,
                         dense.cpu().numpy()), np.arange(n))
    lists_err = max(
        int(np.abs(agg.cpu().numpy() - last.reshape(
            n_tiles, bk.TILE_CHUNKS, 256).max(1)).max()),
        int((pre.cpu().long() - bk._last_before(torch.from_numpy(
            last[:n_chunks]))[::bk.TILE_CHUNKS]).abs().max()))
    if err or lists_err or not torch.equal(out, got):
        raise AssertionError('MTF encode kernels differ from their plain '
                             'versions: max abs err %d, start lists %d'
                             % (err, lists_err))
    res = {'err': err, 'lists_err': lists_err, 'ms': ms,
           'tiles_ms': cuda_ms(tiles, 20), 'prefix_ms': cuda_ms(prefix, 20),
           'step_ms': cuda_ms(step, 20),
           'occupancy_ms': occupancy(step, n_chunks),
           'plain_ms': cuda_ms(lambda: bk.mtf_encode_plain(dense, n), 2)}
    res.update(stage(lambda: bk.mtf_encode(dense, n), 'mtf_scan'))
    # what these inputs need: symbols in and codes out once; per symbol a
    # lookup and a front write, plus one move per entry in front of it
    res['bound_ms'], res['bound_by'] = bound(
        4 * n * 2, 2 * n + int(want.long().sum()))
    return res


def check_seg_scan(dev):
    """csrc/seg_scan.cu's two entries against torch.cummax at a -9 block's
    899,981 elements and at bwt_block_batch's 8 blocks of them, on random
    flags (the sorts' group starts) and RLE2-shaped values: error, the C
    entry's device ms alone (warm, and at 899,981 with a cold L2), the
    wrapper's, the byte bound (input read once, n int64 written), the
    plain version's ms (the code a CPU tensor takes, run on the card),
    torch.cummax's alone on the same values, and the device kernels of
    one wrapper call."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import block_kernels as bk
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)
    rng = np.random.default_rng(22)
    rows = {}
    for n in (899981, 8 * 899981):
        pos = torch.arange(n, device=dev)
        flags = torch.from_numpy(rng.random(n) < 0.3).to(dev)
        seq = np.minimum(rng.zipf(1.3, n) - 1, 40)
        vals = torch.from_numpy(np.where(seq == 0, 0, np.arange(n) + 1)).to(
            dev)
        out = torch.empty(n, dtype=torch.int64, device=dev)
        agg = torch.empty(-(-n // bk.SCAN_TILE), dtype=torch.int64,
                          device=dev)
        starts = torch.where(flags, pos, 0)
        for name, x, entry, wrapper, plain, lib_in, nbytes in (
                ('group_start', flags, lib.cz_group_start, bk._seg_start,
                 lambda: torch.cummax(torch.where(flags, pos, 0), 0).values,
                 starts, 9 * n),
                ('max_scan', vals, lib.cz_max_scan, bk._max_scan,
                 lambda: torch.cummax(vals, 0).values, vals, 16 * n)):
            def launch(entry=entry, x=x):
                _cuda.check(entry(x.data_ptr(), n, out.data_ptr(),
                                  agg.data_ptr(), stream), 'seg_scan')
            want = plain()
            launch()
            err = int((out - want).abs().max())
            err = max(err, int((wrapper(x) - want).abs().max()))
            r = rows['%s n=%d' % (name, n)] = {
                'err': err, 'ms': cuda_ms(launch, 200),
                'wrapper_ms': cuda_ms(lambda: wrapper(x), 200),
                'plain_ms': cuda_ms(plain, 10),
                'library_ms': cuda_ms(lambda: torch.cummax(lib_in, 0), 10),
                'kernels_per_call': kernels_launched(lambda: wrapper(x))}
            if n == 899981:
                r['cold_l2_ms'] = cuda_ms_cold(launch, 20, dev)
            r['bound_ms'], r['bound_by'] = bound(nbytes, 0)
    bad = {k: r for k, r in rows.items()
           if r['err'] or r['kernels_per_call'] > 3}
    if bad:
        raise AssertionError('seg_scan kernels differ from torch.cummax or '
                             'launch more than 3 kernels: %s' % bad)
    return rows


def adversarial_tables():
    """(arrs, ms) that stress the allocator: Fibonacci frequencies (they
    force the relocating fill at the 20-bit limit), flat, tiny alphabets
    and random tables, all sorted as the caller sorts them."""
    from compressjs_tpu_torch.ops.device_entropy import N
    rng = np.random.default_rng(0)
    rows, ms = [], []

    def add(freqs):
        row = np.zeros(N, dtype=np.int32)
        row[:len(freqs)] = np.sort(freqs)
        rows.append(row)
        ms.append(len(freqs))

    fib = [1, 1]
    while len(fib) < 29:
        fib.append(fib[-1] + fib[-2])
    for m in (22, 25, 29):
        add(np.array(fib[:m]))
    add(np.array(fib + [1] * 200))
    for m in (1, 2, 3, 258):
        add(np.ones(m, dtype=np.int64))
    for m in (3, 17, 130, 258):
        add(rng.integers(0, 900001 // m, m))
        add(np.minimum(rng.zipf(1.3, m), 900001 // m))
    return (torch.from_numpy(np.stack(rows)),
            torch.tensor(ms, dtype=torch.int32))


def check_alloc(tables, dev):
    """cz_alloc_lengths (sorted tables, the Pallas kernel's interface) vs
    plain on every table; returns (max_abs_err, kernel ms, wrapper ms,
    plain ms, bound ms, bound_by) at the main path's B=6 shape."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import device_entropy as de
    err = 0
    for arrs, ms in tables:
        arrs = arrs.to(dev).contiguous()
        ms = ms.to(dev).contiguous()
        got = de.alloc_lengths(arrs, ms)
        want = de.alloc_lengths_plain(arrs, ms)[0]
        err = max(err, int((got.long() - want.long()).abs().max()))
    if err:
        raise AssertionError('allocator kernel differs from its plain '
                             'version: max abs err %d' % err)
    six = [t for t in tables if t[0].shape[0] == de.G]
    arrs, ms = six[0][0].to(dev), six[0][1].to(dev)
    lib = _cuda.lib()
    out = torch.empty_like(arrs)
    flags = torch.empty(de.G, dtype=torch.int32, device=dev)
    stream = _cuda.stream_handle(dev)

    def launch():  # the kernel alone: no allocation, no flag read-back
        _cuda.check(lib.cz_alloc_lengths(
            arrs.data_ptr(), ms.data_ptr(), out.data_ptr(),
            flags.data_ptr(), de.G, de.MAX_LEN, stream), 'alloc_lengths')

    ms_k = cuda_ms(launch, 50)
    if int(flags.max()) or not torch.equal(
            out, de.alloc_lengths_plain(arrs, ms)[0]):
        raise AssertionError('timed allocator launches differ')
    wrapper = cuda_ms(lambda: de.alloc_lengths(arrs, ms), 50)
    plain = cuda_ms(lambda: de.alloc_lengths_plain(arrs, ms), 5)
    # phase 1 dominates: ~16 integer operations per table slot
    b = bound(4 * (2 * arrs.numel() + 2 * ms.numel()),
              16 * int(ms.sum()))
    return err, ms_k, wrapper, plain, b[0], b[1]


def record_builds(fn):
    """Run fn() and return every (freqs, m) a table build was given."""
    from compressjs_tpu_torch.ops import device_entropy as de
    seen = []
    orig = de.code_lengths_batch

    def recorder(freqs, m, err):
        seen.append((freqs.clone(), m))
        return orig(freqs, m, err)

    de.code_lengths_batch = recorder
    try:
        fn()
    finally:
        de.code_lengths_batch = orig
    return seen


def sorted_tables(builds):
    """The sorted (arrs, ms) that each build hands its allocator."""
    from compressjs_tpu_torch.ops import device_entropy as de
    out = []
    for freqs, m in builds:
        arrs = de._sym_sorted(freqs, m)[0].to(torch.int32).contiguous()
        out.append((arrs, torch.full((freqs.shape[0],), m,
                                     dtype=torch.int32,
                                     device=freqs.device)))
    return out


def old_table_build(freqs, m, err):
    """The table build before the fused kernel: torch.sort of the keys,
    the allocator kernel with its flags read back at once, a scatter by
    symbol.  It raises on a flagged table, so `err` stays as it was."""
    from compressjs_tpu_torch.ops import device_entropy as de
    arrs, sym_of_slot, valid = de._sym_sorted(freqs, m)
    ms = torch.full((freqs.shape[0],), m, dtype=torch.int32,
                    device=freqs.device)
    return de._unsort(de.alloc_lengths(arrs.to(torch.int32).contiguous(),
                                       ms), sym_of_slot, valid)


def smem_chain_ms(steps, dev):
    """(device ms of one thread running `steps` dependent shared-memory
    loads, cz_smem_chain_probe over a random single cycle of 4,096
    int32; ms of the same chain on the host; the absolute difference of
    their end points, which must be 0)."""
    from compressjs_tpu_torch.ops import _cuda
    n = 4096
    order = np.random.default_rng(11).permutation(n)
    ring = np.empty(n, dtype=np.int32)
    ring[order] = np.roll(order, -1)
    ring_d = torch.from_numpy(ring).to(dev)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)

    def launch():
        _cuda.launches['smem_chain_probe'] += 1
        _cuda.check(lib.cz_smem_chain_probe(ring_d.data_ptr(), n, steps,
                                            out.data_ptr(), stream),
                    'smem_chain_probe')

    ms = cuda_ms(launch, 20)
    t0 = time.perf_counter()
    p = 0
    for _ in range(steps):
        p = int(ring[p])
    plain = (time.perf_counter() - t0) * 1e3
    err = abs(int(out) - p)
    if err:
        raise AssertionError('shared-memory chain probe differs from its '
                             'host chain')
    return ms, plain, err


def check_code_lengths(builds, dev):
    """The fused table build (cz_code_lengths) vs its plain version on
    every build; returns a dict of its error and times at the main path's
    B=6 shape, beside the build it replaced, and the one-thread floor of
    allocator phase 1 (2 (m - 2) dependent shared-memory steps)."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import device_entropy as de
    err = 0
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    for freqs, m in builds:
        got = de.code_lengths_batch(freqs.to(dev), m, flag)
        want, flags = de.code_lengths_plain(freqs.cpu(), m)
        err = max(err, int((got.cpu().long() - want.long()).abs().max()))
        if int(flags.max()):
            raise AssertionError('plain table build flagged a table')
        old = old_table_build(freqs.to(dev), m, flag)
        err = max(err, int((got.long() - old.long()).abs().max()))
    if err or int(flag):
        raise AssertionError('fused table build differs from its plain '
                             'version: max abs err %d, flag %d'
                             % (err, int(flag)))
    freqs, m = [(f.to(dev), m) for f, m in builds if f.shape[0] == de.G][0]
    lib = _cuda.lib()
    lens = torch.empty_like(freqs)
    stream = _cuda.stream_handle(dev)

    def launch():  # the kernel alone
        _cuda.check(lib.cz_code_lengths(freqs.data_ptr(), m,
                                        lens.data_ptr(), flag.data_ptr(),
                                        de.G, de.MAX_LEN, stream),
                    'code_lengths')

    k_ms = cuda_ms(launch, 50)
    if int(flag) or not torch.equal(lens, de.code_lengths_plain(
            freqs.cpu(), m)[0].to(dev)):
        raise AssertionError('timed fused table builds differ')
    wrapper = cuda_ms(lambda: de.code_lengths_batch(freqs, m, flag), 50)
    plain = cuda_ms(lambda: de.code_lengths_plain(freqs.cpu(), m), 5)
    old = cuda_ms(lambda: old_table_build(freqs, m, flag), 50)
    # a sort's m log m compares and the allocator's ~16 operations per
    # slot, per table; frequencies in, lengths out
    ops = de.G * (m * max(1, int(np.ceil(np.log2(max(m, 2))))) + 16 * m)
    b_ms, b_by = bound(4 * 2 * freqs.numel() + 4, ops)
    steps = 2 * (m - 2)
    floor = smem_chain_ms(steps, dev)[0]
    return {'err': err, 'ms': k_ms, 'wrapper_ms': wrapper, 'plain_ms': plain,
            'old_build_ms': old, 'bound_ms': b_ms, 'bound_by': b_by,
            'm': m, 'phase1_steps': steps, 'latency_floor_ms': floor,
            'floor_ns_per_step': (floor - smem_chain_ms(0, dev)[0]) * 1e6 /
            max(steps, 1)}


def group_opt_counts(args, build, dev):
    """One block's optimize_groups_dev with `build` as its table build:
    device kernels launched (all, and by one table build alone), host
    syncs (every one that torch.cuda's sync debug mode reports, each
    under the innermost line of the port on its call stack) and mean wall
    ms of 5 runs."""
    import collections
    import traceback
    import warnings
    from torch.profiler import ProfilerActivity, profile
    from compressjs_tpu_torch.ops import device_entropy as de
    orig = de.code_lengths_batch
    de.code_lengths_batch = build
    try:
        de.optimize_groups_dev(*args)   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            de.optimize_groups_dev(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5 * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            de.optimize_groups_dev(*args)
            torch.cuda.synchronize()
        sources = collections.Counter()

        def show(message, category, filename, lineno, *rest):
            # torch's one-time notice that the debug mode is a prototype
            # is no sync: only its per-sync warning counts
            if 'called a synchronizing CUDA operation' not in str(message):
                return
            port = [f for f in traceback.extract_stack()
                    if os.sep + 'compressjs_tpu_torch' + os.sep
                    in f.filename]
            where = port[-1] if port else None
            key = ('%s:%d' % (os.path.basename(where.filename), where.lineno)
                   if where else 'outside the port')
            if where is None or where.filename != filename:
                key += ' (in %s:%d)' % (os.path.relpath(
                    filename, os.path.dirname(os.path.dirname(
                        torch.__file__))), lineno)
            sources[key] += 1

        with warnings.catch_warnings():
            warnings.simplefilter('always')
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode('warn')
            try:
                de.optimize_groups_dev(*args)
            finally:
                torch.cuda.set_sync_debug_mode('default')
        freqs, m = record_builds(lambda: de.optimize_groups_dev(*args))[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof_b:
            build(freqs, m, torch.zeros(1, dtype=torch.int32, device=dev))
            torch.cuda.synchronize()
    finally:
        de.code_lengths_batch = orig
    n_builds = len(record_builds(lambda: de.optimize_groups_dev(*args)))

    def kernels(p):
        return sum(1 for e in p.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith('Memcpy')
                   and not e.name.startswith('Memset'))

    return {'launches': kernels(prof), 'syncs': sum(sources.values()),
            'sync_sources': dict(sources),
            'launches_per_build': kernels(prof_b), 'builds': n_builds,
            'wall_ms': wall}


def record_group_opt_args(fn):
    """Run fn() and return the arguments of its first optimize_groups_dev
    call (the first block's)."""
    from compressjs_tpu_torch.ops import device_entropy as de
    seen = []
    orig = de.optimize_groups_dev

    def recorder(syms, count, n_chunks, freq, m):
        if not seen:
            seen.append((syms.clone(), count, n_chunks, freq.clone(), m))
        return orig(syms, count, n_chunks, freq, m)

    de.optimize_groups_dev = recorder
    try:
        fn()
    finally:
        de.optimize_groups_dev = orig
    return seen[0]


def first_block_walk(comp, dev):
    """(the arguments of `huffman_walk_dev` for the first block of a -9
    stream on the card, the stream's dbuf_size)."""
    from compressjs_tpu_torch.host.bzip2_parse import _parse_candidates
    from compressjs_tpu_torch.parallel.decode import _walk_inputs
    data = np.frombuffer(comp, np.uint8)
    dbuf_size, _, cands, _ = _parse_candidates(data)
    return _walk_inputs(data, cands[0], cands[1], dbuf_size,
                        dev)['walk'], dbuf_size


def first_block_maps(walk, k):
    """The walk of a block up to its chase at composition power k: (nxt,
    the (a, b, blo, bhi) of every composition `_power_k` makes, F = nxt^k,
    the selectors up to n_selectors, chase steps per selector).  These
    are the compose and chase kernels' inputs on the main path."""
    from compressjs_tpu_torch.ops import device_huffman as dh
    payload, bit0, nbits_cap, _, limits, _, _, mins, sel, n_sel = walk[:10]
    _, _, nxt = dh._next_maps(payload, bit0, nbits_cap, limits, mins)
    calls = []
    orig = dh.compose_windowed

    def recorder(a, b, blo, bhi):
        calls.append((a, b, blo, bhi))
        return orig(a, b, blo, bhi)

    dh.compose_windowed = recorder
    try:
        F = dh._power_k(nxt, k)
    finally:
        dh.compose_windowed = orig
    return nxt, calls, F, sel[:n_sel].contiguous(), dh.GROUP_SIZE // k


def first_block_mtf_indices(walk, dbuf_size):
    """The MTF-undo kernel's input on the main path: the first block's
    RLE2-decoded indices over the whole dbuf_size capacity (zero past the
    block's total), as `bwt_column` passes them."""
    from compressjs_tpu_torch.ops import device_huffman as dh
    syms, count, _ = dh.huffman_walk_dev(*walk)
    idx, total = dh.rle2_decode(syms, dbuf_size, count)
    return idx, int(total)


def check_mtf_undo(idx, n):
    """The three MTF-undo launches against the plain decode and the plain
    start lists on one input; returns a dict of errors and times."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import block_decode as bd
    got = bd.mtf_decode(idx, n)
    want = bd.mtf_decode_plain(idx, n)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    lib = _cuda.lib()
    stream = _cuda.stream_handle(idx.device)
    n_chunks = -(-n // bd.CHUNK_LEN)
    n_tiles = -(-n_chunks // bd.TILE_CHUNKS)
    perm = torch.empty((n_chunks, bd.WIDTH), dtype=torch.uint8,
                       device=idx.device)
    agg = torch.empty((n_tiles, bd.WIDTH), dtype=torch.uint8,
                      device=idx.device)
    lists = torch.empty_like(agg)
    out = torch.empty(n, dtype=torch.int32, device=idx.device)

    # the kernels alone, outside the wrapper
    def launch_perm(c=n_chunks):
        _cuda.check(lib.cz_mtf_undo_perm(
            idx.data_ptr(), perm.data_ptr(), agg.data_ptr(),
            min(n, c * bd.CHUNK_LEN), c, stream), 'mtf_undo')

    def launch_prefix(c=n_chunks):
        _cuda.check(lib.cz_mtf_undo_prefix(
            agg.data_ptr(), lists.data_ptr(), -(-c // bd.TILE_CHUNKS),
            stream), 'mtf_undo')

    def launch_decode(c=n_chunks):
        _cuda.check(lib.cz_mtf_undo_decode(
            idx.data_ptr(), perm.data_ptr(), lists.data_ptr(),
            out.data_ptr(), min(n, c * bd.CHUNK_LEN), c, stream),
            'mtf_undo')

    def all_three():
        launch_perm()
        launch_prefix()
        launch_decode()

    ms = cuda_ms(all_three, 20)
    _, pperm = bd._chunk_perms(idx, n)
    lists_err = max(
        int((perm.long() - pperm.long()).abs().max()),
        int((lists.long() - bd._start_lists(pperm)[::bd.TILE_CHUNKS].long())
            .abs().max()))
    if err or lists_err or not torch.equal(out, got):
        raise AssertionError('MTF-undo kernels differ from their plain '
                             'versions (n %d): max abs err %d, start lists %d'
                             % (n, err, lists_err))
    res = {'err': err, 'lists_err': lists_err, 'ms': ms,
           'perm_ms': cuda_ms(launch_perm, 20),
           'prefix_ms': cuda_ms(launch_prefix, 20),
           'decode_ms': cuda_ms(launch_decode, 20),
           'occupancy_perm_ms': occupancy(launch_perm, n_chunks),
           'occupancy_ms': occupancy(launch_decode, n_chunks),
           'plain_ms': cuda_ms(lambda: bd.mtf_decode_plain(idx, n), 1)}
    res.update(stage(lambda: bd.mtf_decode(idx, n), 'mtf_undo'))
    # the function's traffic: int32 indices read once, int32 values
    # written once; per index a lookup and a front write, and one move per
    # position in front of it
    front = int(idx[:n].long().clamp(0, bd.WIDTH).sum())
    res['bound_ms'], res['bound_by'] = bound(8 * n, 2 * n + front)
    return res


def check_compose(calls, dev):
    """Kernel vs plain on every main-path composition and on random maps
    whose jumps leave the window on both sides; returns (max_abs_err,
    kernel ms, wrapper ms, plain ms, bound ms, bound_by, library ms,
    kernel ms with a cold L2), each the mean over the main-path
    compositions."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import compose as cm
    G, cap = calls[0][0].shape
    rng = np.random.default_rng(99)
    pos = np.arange(cap)[None, :]
    rand_a = torch.from_numpy(rng.integers(0, cap, (G, cap)).astype(
        np.int32)).to(dev)
    rand_b = torch.from_numpy(np.clip(
        pos + rng.integers(-100, 400, (G, cap)), 0, cap - 1).astype(
            np.int32)).to(dev)
    err = 0
    for a, b, blo, bhi in calls + [(rand_a, rand_b, 2, 40),
                                   (rand_a, rand_b, 33, 635)]:
        got = cm.compose_windowed(a, b, blo, bhi)
        want = cm.compose_windowed_plain(a, b, blo, bhi)
        err = max(err, int((got.long() - want.long()).abs().max()))
    if err:
        raise AssertionError('compose kernel differs from its plain '
                             'version: max abs err %d' % err)
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)
    sums = np.zeros(6)
    b_by = 'bytes'
    for a, b, blo, bhi in calls:
        out = torch.empty_like(a)

        def launch():  # the kernel alone, outside the wrapper
            _cuda.check(lib.cz_compose_windowed(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), G, cap, blo,
                bhi, stream), 'compose_windowed')

        k_ms = cuda_ms(launch, 20)
        if not torch.equal(out, cm.compose_windowed_plain(a, b, blo, bhi)):
            raise AssertionError('timed compose launches differ')
        cold = cuda_ms_cold(launch, 20, dev)
        w_ms = cuda_ms(lambda: cm.compose_windowed(a, b, blo, bhi), 20)
        p_ms = cuda_ms(lambda: cm.compose_windowed_plain(a, b, blo, bhi),
                       5)
        # the library yardstick: one torch.gather on the padded map
        p = torch.arange(cap, device=dev)
        idx = p + (b.long() - p).clamp(blo, bhi)
        a_pad = torch.cat([a, a[:, -1:].expand(G, bhi + 1)], 1)
        l_ms = cuda_ms(lambda: torch.gather(a_pad, 1, idx), 20)
        # each distinct input read once, c written once (a squaring reads
        # one map as both a and b); a few integer operations per element
        maps = 2 if a.data_ptr() == b.data_ptr() else 3
        c_b_ms, c_b_by = bound(maps * 4 * G * cap, 8 * G * cap)
        b_by = c_b_by if c_b_by == 'operations' else b_by
        print('  window [%d, %d]: kernel %.4f ms (cold L2 %.4f), wrapper '
              '%.4f ms, plain %.3f ms, torch.gather %.4f ms, bound %.5f ms '
              '(%d maps, %s)' % (blo, bhi, k_ms, cold, w_ms, p_ms, l_ms,
                                 c_b_ms, maps, c_b_by))
        sums += [k_ms, w_ms, p_ms, c_b_ms, l_ms, cold]
    k_ms, w_ms, p_ms, c_b_ms, l_ms, cold = sums / len(calls)
    return err, k_ms, w_ms, p_ms, c_b_ms, b_by, l_ms, cold


def adversarial_builds():
    """(freqs (6, N), m) in symbol order for the fused table build:
    Fibonacci rows (repeated past 29 symbols: they force the 20-bit
    limit), flat, zipf and random rows, for small and full alphabets."""
    from compressjs_tpu_torch.ops.device_entropy import N
    rng = np.random.default_rng(5)
    fib = [1, 1]
    while len(fib) < 29:
        fib.append(fib[-1] + fib[-2])
    out = []
    for m in (3, 4, 29, 130, 258):
        rows = np.zeros((6, N), dtype=np.int32)
        rows[0, :m] = rng.permutation(np.resize(fib[:min(m, 29)], m))
        rows[1, :m] = 5
        rows[2, :m] = np.minimum(rng.zipf(1.3, m), 900001 // m)
        rows[3, :m] = rng.integers(0, 900001 // m, m)
        rows[4, :m] = rng.integers(0, 3, m)
        rows[5, :m] = rng.permutation(np.arange(m)) * 3000
        out.append((torch.from_numpy(rows), m))
    return out


def stage_rate(dev):
    """One SM's TMA streaming rate into shared memory, bytes per ms:
    cz_stage_probe moves every window of a (6, 2^20) int32 F (25 MB, in
    L2 after the first pass) through the chase's ring with no chain.
    Returns (bytes per ms, bytes per pass, ms per pass, checksum error)."""
    from compressjs_tpu_torch.ops import _cuda
    G, cap = 6, 1 << 20
    F = torch.arange(G * cap, dtype=torch.int32, device=dev).view(G, cap)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)

    def launch():
        _cuda.launches['stage_probe'] += 1
        _cuda.check(lib.cz_stage_probe(F.data_ptr(), G, cap,
                                       stats.data_ptr(), stream),
                    'stage_probe')

    ms = cuda_ms(launch, 10)
    nbytes, acc = stats.tolist()
    # the probe XORs the first element of every staged window
    first = np.arange(0, cap, 2048, dtype=np.int64)
    want = int(np.bitwise_xor.reduce(first.astype(np.int32)))
    err = abs(int(np.int32(acc)) - want)
    if err or nbytes != G * cap * 4:
        raise AssertionError('stage probe: %d bytes, checksum %d vs %d'
                             % (nbytes, acc, want))
    plain = cuda_ms(lambda: np.bitwise_xor.reduce(
        F[0, ::2048].cpu().numpy()), 2)
    return nbytes / ms, nbytes, ms, err, plain


_RINGS = {}   # the L2 probe's random cycle, made once per size


def check_chase(F, sel, sub, dev, rate):
    """The staged chase kernel vs plain on one main-path chase, beside
    the one-thread L2 chase it replaced (cz_chase_probe on the same
    input); returns a dict of errors, times, floors and what it staged.
    rate: one SM's staging rate, bytes per ms (`stage_rate`)."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import device_huffman as dh
    got = dh.selector_chase(F, sel, sub)
    want = dh.selector_chase_plain(F, sel, sub)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError('chase kernel differs from its plain version: '
                             'max abs err %d' % err)
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)
    out = torch.empty_like(sel)
    old = torch.empty_like(sel)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    G, cap = F.shape
    n = sel.shape[0]

    def launch():  # the kernel alone, outside the wrapper
        _cuda.check(lib.cz_selector_chase(
            F.data_ptr(), sel.data_ptr(), out.data_ptr(), G, cap, n, sub,
            stats.data_ptr(), stream), 'selector_chase')

    def launch_old():  # the one-thread L2 chase the staged kernel replaced
        _cuda.launches['chase_probe'] += 1
        _cuda.check(lib.cz_chase_probe(
            F.data_ptr(), sel.data_ptr(), old.data_ptr(), G, cap, n, sub,
            stream), 'chase_probe')

    ms = cuda_ms(launch, 10)
    old_ms = cuda_ms(launch_old, 5)
    old_err = int((old.long() - want.long()).abs().max())
    if not torch.equal(out, want) or old_err:
        raise AssertionError('timed chase launches differ')
    staged, global_loads, window, stages = stats.tolist()
    wrapper = cuda_ms(lambda: dh.selector_chase(F, sel, sub), 10)
    plain = cuda_ms(lambda: dh.selector_chase_plain(F, sel, sub), 1)
    # the entries of F the chain reads, the selectors, the starts; a
    # multiply-add, two compares per step
    steps = n * sub
    b_ms, b_by = bound(4 * (steps + 2 * n), 4 * steps)
    # the L2 latency floor: the old kernel's chain over a random single
    # cycle of F's size held in L2 (one row, every selector 0, so each
    # step is p <- ring[p])
    if _RINGS.get('n') != G * cap:
        order = np.random.default_rng(7).permutation(G * cap)
        ring = np.empty(G * cap, dtype=np.int32)
        ring[order] = np.roll(order, -1)
        _RINGS.update(n=G * cap, ring=torch.from_numpy(ring).to(dev))
    ring = _RINGS['ring']
    zeros = torch.zeros_like(sel)
    probe = torch.empty_like(sel)

    def chase_ring():
        _cuda.launches['chase_probe'] += 1
        _cuda.check(lib.cz_chase_probe(
            ring.data_ptr(), zeros.data_ptr(), probe.data_ptr(), 1,
            G * cap, n, sub, stream), 'chase_probe')

    ring.sum()  # pull the ring into L2
    lat_ms = cuda_ms(chase_ring, 5)
    if not torch.equal(probe, dh.selector_chase_plain(
            ring.view(1, G * cap), zeros, sub)):
        raise AssertionError('latency probe differs from its plain chase')
    smem_ms, smem_plain, smem_err = smem_chain_ms(steps, dev)
    # positions staged: staged bytes over 4 B a row-entry, per row
    span = int(want[-1]) + 1
    return {'err': err, 'ms': ms, 'wrapper_ms': wrapper, 'plain_ms': plain,
            'old_ms': old_ms, 'old_err': old_err, 'bound_ms': b_ms,
            'bound_by': b_by, 'steps': steps, 'l2_floor_ms': lat_ms,
            'l2_ns_per_load': lat_ms * 1e6 / steps,
            'smem_floor_ms': smem_ms, 'smem_plain_ms': smem_plain,
            'smem_err': smem_err,
            'stream_floor_ms': staged / rate,
            'staged_bytes': staged, 'global_loads': global_loads,
            'window': window, 'stages': stages,
            'rows_per_position': staged / 4 / max(span, 1)}


def max_caps_walk(dev):
    """The arguments of `huffman_walk_dev` for a block at the largest caps
    a -9 block reaches, nbits_cap 2^22 and s_cap 32,768, with six tables:
    the first block of bz2 -9 of a million seeded random letters over 22,
    whose MTF symbols barely run."""
    rng = np.random.default_rng(22)
    data = rng.choice(np.frombuffer(b'abcdefghijklmnopqrstuv', np.uint8),
                      1000000).tobytes()
    return first_block_walk(bz2.compress(data, 9), dev)[0]


def host_ms(fn, reps):
    """Mean host milliseconds to issue fn() (no synchronisation inside
    the timed loop), after one warm call; the card is drained first."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def check_walk(walk, dev, l2_ns):
    """Both walk kernels (csrc/huffman_walk.cu) vs their plain versions
    on one block's walk, whole outputs; each timed alone, in its wrapper
    and as its plain version, beside its bound; then the whole walk with
    the kernels and with the plain stages 1 and 4 it had before them
    (device ms, host ms to issue, device kernels a call).
    l2_ns: one dependent load's latency from L2 (`check_chase`)."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import device_huffman as dh
    payload, bit0, cap, s_cap, limits, bases, perms, mins, sel, n_sel = \
        walk[:10]
    G = limits.shape[0]
    sel = sel[:s_cap].contiguous()
    val, nxt = dh.walk_maps(payload, bit0, cap, limits, mins)
    want_val, _, want_nxt = dh._next_maps(payload, bit0, cap, limits, mins)
    maps_err = max(int((val.long() - want_val.long()).abs().max()),
                   int((nxt.long() - want_nxt.long()).abs().max()))
    starts = dh.selector_chase(dh._power_k(nxt, dh.POWER_K_DEFAULT),
                               sel[:n_sel].contiguous(), 1)
    syms, ends = dh.chunk_walk(val, sel, starts, limits, bases, perms, mins)
    want_s, want_e = dh.chunk_walk_plain(val, sel, starts, limits, bases,
                                         perms, mins)
    walk_err = max(int((syms.long() - want_s.long()).abs().max()),
                   int((ends - want_e).abs().max()))
    if maps_err or walk_err:
        raise AssertionError('walk kernels differ from their plain '
                             'versions: max abs err %d, %d'
                             % (maps_err, walk_err))
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)
    v_out, n_out = torch.empty_like(val), torch.empty_like(nxt)
    s_out, e_out = torch.empty_like(syms), torch.empty_like(ends)

    def launch_maps():  # the kernels alone, outside their wrappers
        _cuda.check(lib.cz_walk_maps(
            payload.data_ptr(), payload.shape[0], bit0, cap,
            limits.data_ptr(), mins.data_ptr(), G, v_out.data_ptr(),
            n_out.data_ptr(), stream), 'walk_maps')

    def launch_walk():
        _cuda.check(lib.cz_chunk_walk(
            val.data_ptr(), sel.data_ptr(), starts.data_ptr(),
            starts.shape[0], limits.data_ptr(), bases.data_ptr(),
            perms.data_ptr(), mins.data_ptr(), G, cap, s_cap,
            s_out.data_ptr(), e_out.data_ptr(), stream), 'chunk_walk')

    r = {'cap': cap, 's_cap': s_cap, 'n_selectors': n_sel, 'groups': G,
         'maps_err': maps_err, 'walk_err': walk_err}
    r['maps_ms'] = cuda_ms(launch_maps, 20)
    r['walk_ms'] = cuda_ms(launch_walk, 20)
    if not (torch.equal(v_out, val) and torch.equal(n_out, nxt)
            and torch.equal(s_out, syms) and torch.equal(e_out, ends)):
        raise AssertionError('timed walk launches differ')
    r['maps_wrapper_ms'] = cuda_ms(
        lambda: dh.walk_maps(payload, bit0, cap, limits, mins), 20)
    r['walk_wrapper_ms'] = cuda_ms(
        lambda: dh.chunk_walk(val, sel, starts, limits, bases, perms,
                              mins), 20)
    r['maps_plain_ms'] = cuda_ms(
        lambda: dh._next_maps(payload, bit0, cap, limits, mins), 3)
    r['walk_plain_ms'] = cuda_ms(
        lambda: dh.chunk_walk_plain(val, sel, starts, limits, bases, perms,
                                    mins), 3)
    # stage 1 reads the payload and writes val and nxt; its arithmetic, a
    # compare and a select per length and group, is a floor of this
    # design, not of the work
    r['maps_bound_ms'], r['maps_bound_by'] = bound(
        payload.shape[0] + 4 * (1 + G) * cap, 0)
    r['maps_alu_floor_ms'] = 2 * 20 * G * cap / PEAK_OPS_PER_S * 1e3
    # stage 4 reads each visited window, the selectors and starts, and
    # writes each symbol (4 B) and end (8 B); its chain of 50 dependent
    # loads from L2 floors it
    r['walk_bound_ms'], r['walk_bound_by'] = bound(
        16 * 50 * s_cap + 4 * (s_cap + n_sel), 0)
    r['walk_chain_floor_ms'] = 50 * l2_ns / 1e6

    def plain_stages():  # the walk as it was: stages 1 and 4 plain
        v, _, nx = dh._next_maps(payload, bit0, cap, limits, mins)
        st = dh.selector_chase(dh._power_k(nx, dh.POWER_K_DEFAULT),
                               sel[:n_sel].contiguous(), 1)
        sy, en = dh.chunk_walk_plain(v, sel, st, limits, bases, perms, mins)
        valid = torch.arange(s_cap * 50, device=dev) < n_sel * 50
        count = torch.argmax(((sy == walk[10]) & valid).to(torch.int32))
        return sy, count, en[count.view(1)][0] + bit0

    def kernels():
        return dh.huffman_walk_dev(*walk)

    got, want = kernels(), plain_stages()
    if not (torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
            and int(got[2]) == int(want[2])):
        raise AssertionError('the walk differs from its plain stages')
    for name, fn in (('whole', kernels), ('whole_plain', plain_stages)):
        r[name + '_ms'] = cuda_ms(fn, 5)
        r[name + '_host_ms'] = host_ms(fn, 5)
        r[name + '_kernels'] = kernels_launched(fn)
    return r


def decode_chases(comp):
    """Run one decode of `comp` and return each block's chase input (F,
    selectors, steps per selector)."""
    import compressjs_tpu_torch as cz
    from compressjs_tpu_torch.ops import device_huffman as dh
    seen = []
    orig = dh.selector_chase

    def recorder(F, sel, sub):
        seen.append((F.clone(), sel.clone(), sub))
        return orig(F, sel, sub)

    dh.selector_chase = recorder
    try:
        cz.decompress_file_device(comp, device='cuda')
    finally:
        dh.selector_chase = orig
    return seen


def timed(fn, *args):
    """(fn(*args), wall seconds)."""
    t0 = time.perf_counter()
    r = fn(*args)
    return r, time.perf_counter() - t0


def check_host_runtime(data):
    """Each native entry of the host runtime against its numpy twin on
    every -9 block of `data`; returns {entry: dict of per-block ms, calls
    and the JAX function it counts as}.  The plain cyclic BWT (numpy
    prefix doubling, seconds a block) runs on the first block only."""
    from compressjs_tpu_torch.host import bwt, mtf_rle2 as mr, rle1
    from compressjs_tpu_torch.host import huffman_stages as hs
    data = np.frombuffer(data, np.uint8)
    t = {}

    def add(name, ms, plain_ms):
        e = t.setdefault(name, {'ms': 0.0, 'plain_ms': 0.0, 'calls': 0,
                                'plain_calls': 0})
        e['ms'] += ms
        e['calls'] += 1
        if plain_ms is not None:
            e['plain_ms'] += plain_ms
            e['plain_calls'] += 1

    start = 0
    blocks = []
    while start < data.shape[0]:
        (b, used), sec = timed(rle1.rle1_encode, data, start, 899981)
        (pb, pused), psec = timed(rle1.rle1_encode_plain, data, start, 899981)
        if used != pused or not np.array_equal(b, pb):
            raise AssertionError('native RLE1 differs from its twin at %d'
                                 % start)
        add('cz_rle1_encode', sec * 1e3, psec * 1e3)
        blocks.append(b)
        start += used
    for i, b in enumerate(blocks):
        n = b.shape[0]
        U = np.zeros(n, np.uint8)
        pidx, sec = timed(bwt.bwtransform2, b, U, n)
        plain_ms = None
        if i == 0:
            Up = np.zeros(n, np.uint8)
            pp, psec = timed(bwt.bwtransform2_plain, b, Up, n)
            if pp != pidx or not np.array_equal(U, Up):
                raise AssertionError('native BWT differs from its twin')
            plain_ms = psec * 1e3
        add('cz_bwt_cyclic', sec * 1e3, plain_ms)
        al = np.flatnonzero(np.bincount(b, minlength=256)).astype(np.uint8)
        (syms, freq), sec = timed(mr.mtf_rle2, U, al, len(al))
        (ps, pf), psec = timed(mr.mtf_rle2_plain, U, al, len(al))
        if not (np.array_equal(syms, ps) and np.array_equal(freq, pf)):
            raise AssertionError('native MTF+RLE2 differs from its twin')
        add('cz_mtf_rle2', sec * 1e3, psec * 1e3)
        m = len(al) + 2
        (lens, sel), sec = timed(hs.optimize_groups, syms, m, freq, False)
        (pl, ps_), psec = timed(hs.optimize_groups_plain, syms, m, freq,
                                False)
        if not (np.array_equal(lens, pl) and np.array_equal(sel, ps_)):
            raise AssertionError('native group optimisation differs from '
                                 'its twin')
        add('optimize_groups', sec * 1e3, psec * 1e3)
        g = lens.shape[0]
        for name, fn, twin, args in [
                ('cz_huff_code_lengths', hs.code_lengths_from_freqs,
                 hs.code_lengths_plain, (freq, m)),
                ('cz_group_costs', hs.group_costs, hs.group_costs_plain,
                 (lens, syms)),
                ('cz_chunk_freqs', hs.chunk_freqs, hs.chunk_freqs_plain,
                 (syms, sel, g, m)),
                ('cz_selector_mtf', hs.selector_mtf_bits,
                 hs.selector_mtf_bits_plain, (sel, g))]:
            got, sec = timed(fn, *args)
            want, psec = timed(twin, *args)
            if not np.array_equal(got, want):
                raise AssertionError('%s differs from its twin' % name)
            add(name, sec * 1e3, psec * 1e3)
        codes = np.stack([hs.canonical_codes(row) for row in lens])
        got, sec = timed(hs.payload_bytes, syms, sel, lens, codes)
        want, psec = timed(hs.payload_bytes_plain, syms, sel, lens, codes)
        if got[1] != want[1] or not np.array_equal(got[0], want[0]):
            raise AssertionError('native payload pack differs from its twin')
        add('cz_payload_pack', sec * 1e3, psec * 1e3)
    jax_of = {
        'cz_rle1_encode': 'ops/rle.py:43 rle1_encode (native :1412)',
        'cz_bwt_cyclic': 'ops/bwt.py:221 bwtransform2 (native :861)',
        'cz_mtf_rle2': 'codecs/bzip2.py:81 mtf_rle2 (native :1229)',
        'optimize_groups': 'ops/huffman_stages.py:204 optimize_groups',
        'cz_huff_code_lengths': 'ops/huffman_stages.py:36 '
                                'code_lengths_from_freqs (native :813)',
        'cz_group_costs': 'ops/huffman_stages.py:88 group_costs '
                          '(native :1267)',
        'cz_chunk_freqs': 'ops/huffman_stages.py:110 chunk_freqs '
                          '(native :1285)',
        'cz_selector_mtf': 'ops/huffman_stages.py:326 selector_mtf_bits '
                           '(native :829)',
        'cz_payload_pack': 'ops/huffman_stages.py:294 payload_bytes '
                           '(native :1301)'}
    out = {}
    for name, e in t.items():
        out[name] = {'jax': jax_of[name], 'calls': e['calls'],
                     'ms_per_call': e['ms'] / e['calls'],
                     'plain_ms_per_call': e['plain_ms'] / e['plain_calls'],
                     'plain_calls': e['plain_calls']}
    return out, len(blocks), data.shape[0]


def check_native_sorts(data, reps=2):
    """The native runtime's two sort pairs on the first -9 block of
    `data`: the two-stage suffix sort against plain SA-IS, and the direct
    rotation sort (the cyclic BWT) against SA-IS on the doubled string.
    Each pair must agree; returns (block bytes, {entry: least ms of
    `reps` calls})."""
    from compressjs_tpu_torch import native
    from compressjs_tpu_torch.host import rle1
    block, _ = rle1.rle1_encode(np.frombuffer(data, np.uint8), 0, 899981)
    ms, out = {}, {}
    for name in ('suffix_sort', 'suffix_sort_sais', 'bwt_cyclic',
                 'bwt_cyclic_ref'):
        best = None
        for _ in range(reps):
            out[name], sec = timed(getattr(native, name), block)
            best = sec if best is None else min(best, sec)
        ms[name] = best * 1e3
    if not np.array_equal(out['suffix_sort'], out['suffix_sort_sais']):
        raise AssertionError('suffix_sort differs from suffix_sort_sais')
    (u1, p1), (u2, p2) = out['bwt_cyclic'], out['bwt_cyclic_ref']
    if p1 != p2 or not np.array_equal(u1, u2):
        raise AssertionError('bwt_cyclic differs from bwt_cyclic_ref')
    return block.shape[0], ms


def check_host_decode(comp, want):
    """The native host block decode (``host/bzip2_decode.py``) on every
    block of the bzip2 stream `comp`: the whole-block parse and symbol
    decode, the inverse BWT and the RLE1 undo, each timed, and the bytes
    checked against `want` and each block CRC; the first block also goes
    through each numpy twin (the Python header parse and symbol loop, the
    numpy LF orbit, the run loop of the RLE1 undo), which must agree.
    Returns {entry: {'ms_per_call', 'calls', 'plain_ms'}}."""
    from compressjs_tpu_torch import native
    from compressjs_tpu_torch.host import bwt, rle1
    from compressjs_tpu_torch.host import bzip2_decode as hd
    from compressjs_tpu_torch.host import bzip2_parse as bp
    from compressjs_tpu_torch.host.bits import WHOLEPI
    from compressjs_tpu_torch.host.crc32 import crc32_bzip2
    comp = np.frombuffer(comp, np.uint8)
    r = bp._BitReader(comp)
    dbuf_size = bp._start(r)
    t = {name: {'ms': 0.0, 'calls': 0, 'plain_ms': None} for name in (
        'cz_bz2_block_full', 'cz_inverse_bwt', 'cz_rle1_decode')}

    def run(name, fn, twin, *args):
        got, sec = timed(fn, *args)
        t[name]['ms'] += sec * 1e3
        t[name]['calls'] += 1
        if twin is not None:
            ref, psec = timed(twin, *args)
            same = all(np.array_equal(a, b) for a, b in zip(got, ref)) \
                if isinstance(got, tuple) else np.array_equal(got, ref)
            if not same:
                raise AssertionError('%s differs from its twin' % name)
            t[name]['plain_ms'] = psec * 1e3
        return got

    def block_full_plain(data, pos, size):
        rr = bp._BitReader(data)
        rr.seek_bit(pos)
        optr, s2b, sel, groups = bp._parse_block_header(rr, size)
        dbuf = hd.decode_symbols_plain(rr, s2b, sel, groups, size)
        return dbuf, optr, rr.pos

    pieces = []
    while r.read_bits(48) == WHOLEPI:
        crc = r.read_bits(32)
        first = not pieces
        res = run('cz_bz2_block_full', native.bz2_block_full,
                  block_full_plain if first else None, comp, r.pos,
                  dbuf_size)
        dbuf, optr, r.pos = res
        packed = run('cz_inverse_bwt', bwt.inverse_bwt,
                     bwt.inverse_bwt_plain if first else None, dbuf, optr)
        out = run('cz_rle1_decode', rle1.rle1_decode,
                  rle1.rle1_decode_plain if first else None, packed)
        if crc32_bzip2(out) != crc:
            raise AssertionError('host block decode: bad block CRC')
        pieces.append(out.tobytes())
    if b''.join(pieces) != want:
        raise AssertionError('host block decode differs from bz2')
    return {name: {'ms_per_call': e['ms'] / e['calls'], 'calls': e['calls'],
                   'plain_ms_first_block': e['plain_ms']}
            for name, e in t.items()}


def run_counted(fn, *args, **kw):
    """(fn(...), its wall seconds, the kernel launches it made), the
    counts set to 0 just before and read just after, the card synced."""
    from compressjs_tpu_torch.ops import _cuda
    torch.cuda.synchronize()
    for name in _cuda.launches:
        _cuda.launches[name] = 0
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, dict(_cuda.launches)


def mesh_phase(cz, s5x4, s5x4_comp, enc_launches, dec_launches, extra=()):
    """Phase "mesh (NCCL, 1 rank)": one NCCL process group of this
    process alone (a FileStore in a temporary directory: no network),
    `mesh_compress_bzip2` of sample5x4 against the golden with the main
    encode's launches, `decompress_file_mesh` with host and with device
    entropy (the latter with the main decode's launches),
    `sharded_block_decode` of sample5x4's full-size blocks' BWT columns,
    `sharded_block_encode` of those blocks (its int16 symbols through the
    NCCL all-gather) against the native host BWT, MTF and RLE2, then one
    warm timed call of each path, then each (phase name, fn(mesh)) of
    `extra` in the same group.  Returns (launches by path, timings, the
    extra phases' results)."""
    import tempfile
    import torch.distributed as dist
    from compressjs_tpu_torch.host.bwt import bwtransform2
    from compressjs_tpu_torch.host.mtf_rle2 import mtf_rle2
    from compressjs_tpu_torch.parallel import mesh as pm
    from compressjs_tpu_torch.host.bzip2 import split_blocks
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    torch.cuda.set_device(0)
    paths, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group('nccl', store=dist.FileStore(
            os.path.join(tmp, 'store'), 1), rank=0, world_size=1)
        try:
            mesh = cz.make_mesh('cuda')
            print('  %r, backend %s' % (mesh, dist.get_backend()))
            out, wall, got = run_counted(cz.mesh_compress_bzip2, mesh, s5x4,
                                         level=9)
            paths['mesh_compress_bzip2'] = got
            print('  mesh_compress_bzip2: %d -> %d bytes, %.3f s, launches '
                  '%s' % (len(s5x4), len(out), wall, got))
            if out != s5x4_comp:
                raise AssertionError('mesh encode differs from the golden')
            if got['mtf_scan'] != enc_launches['mtf_scan'] or \
                    got['code_lengths'] != enc_launches['code_lengths']:
                raise AssertionError('mesh encode launched %s, the main '
                                     'encode %s' % (got, enc_launches))
            for entropy in ('host', 'device'):
                name = 'decompress_file_mesh_' + entropy
                out, wall, got = run_counted(
                    cz.decompress_file_mesh, s5x4_comp, mesh=mesh,
                    entropy=entropy)
                paths[name] = got
                print('  %s: %.3f s, launches %s' % (name, wall, got))
                if out != s5x4:
                    raise AssertionError('%s differs from bz2' % name)
                want = dec_launches if entropy == 'device' else \
                    {k: 0 for k in got}
                for k in ('compose_windowed', 'selector_chase', 'mtf_undo'):
                    if got[k] != want[k]:
                        raise AssertionError('%s launched %s, not %s'
                                             % (name, got, want))
            blocks = [b for b, _ in split_blocks(
                np.frombuffer(s5x4, np.uint8), 899981)
                if b.shape[0] == 899981]
            Us = np.zeros((len(blocks), 899981), np.uint8)
            pidxs = [bwtransform2(b, Us[i], 899981)
                     for i, b in enumerate(blocks)]
            inv, wall, _ = run_counted(pm.sharded_block_decode, mesh, Us,
                                       pidxs)
            if not np.array_equal(inv.cpu().numpy(), np.stack(blocks)):
                raise AssertionError('sharded_block_decode differs from '
                                     'the blocks')
            print('  sharded_block_decode of %d BWT columns of 899981 '
                  'bytes: %.3f s, equal to the blocks' % (len(blocks), wall))
            enc, wall, got = run_counted(pm.sharded_block_encode, mesh,
                                         *pm.prepare_blocks(blocks))
            paths['sharded_block_encode'] = got
            pidx, syms, count, freq, _ = (t.cpu().numpy() for t in enc)
            for i, b in enumerate(blocks):
                alphabet = np.flatnonzero(np.bincount(b, minlength=256))
                hs, hf = mtf_rle2(Us[i], alphabet.astype(np.uint8),
                                  len(alphabet))
                if pidx[i] != pidxs[i] or count[i] != len(hs) or \
                        not np.array_equal(syms[i, :len(hs)], hs) or \
                        not np.array_equal(freq[i, :len(hf)], hf) or \
                        freq[i, len(hf):].any():
                    raise AssertionError('sharded_block_encode of block %d '
                                         'differs from the host encode' % i)
            if got['mtf_scan'] < len(blocks):
                raise AssertionError('sharded_block_encode launched %s'
                                     % got)
            print('  sharded_block_encode of the same %d blocks: %.3f s, '
                  'syms %s, equal to the host BWT, MTF and RLE2; launches '
                  '%s' % (len(blocks), wall, syms.dtype, got))
            # one warm call of each path
            for name, fn, args, kw, want in [
                    ('mesh_compress_bzip2', cz.mesh_compress_bzip2,
                     (mesh, s5x4), {'level': 9}, s5x4_comp),
                    ('decompress_file_mesh_host', cz.decompress_file_mesh,
                     (s5x4_comp,), {'mesh': mesh, 'entropy': 'host'}, s5x4),
                    ('decompress_file_mesh_device', cz.decompress_file_mesh,
                     (s5x4_comp,), {'mesh': mesh, 'entropy': 'device'},
                     s5x4)]:
                out, wall, _ = run_counted(fn, *args, **kw)
                if out != want:
                    raise AssertionError('timed %s differs' % name)
                times[name] = wall
            results = {}
            for name, fn in extra:
                phase(name)
                results[name] = fn(mesh)
        finally:
            dist.destroy_process_group()
    return paths, times, results


def hetero_phase(cz, s5x4):
    """Phase "hetero": sample5x4 tiled three times (29 -9 blocks), its
    stream from `compress_file_device` as the reference, then
    `hetero_compress_bzip2` with two host workers and the device worker,
    which must equal it and must have encoded blocks on the card.
    Returns (input, reference stream, launches, last_stats).  First
    `warm_device`, the warm-up a caller makes before a timed run."""
    from compressjs_tpu_torch.parallel import hetero
    warm = hetero.warm_device(level=9, device='cuda')
    if len(bz2.decompress(warm)) != 899981 + 4:
        raise AssertionError('warm_device stream does not decode')
    data = s5x4 * 3
    ref = cz.compress_file_device(data, level=9, device='cuda')
    if bz2.decompress(ref) != data:
        raise AssertionError('the tiled input does not round-trip')
    out, wall, got = run_counted(cz.hetero_compress_bzip2, data, level=9,
                                 host_workers=2, device='cuda')
    stats = dict(cz.hetero_compress_bzip2.last_stats)
    print('  %d bytes -> %d bytes in %.3f s, last_stats %s, launches %s'
          % (len(data), len(out), wall, stats, got))
    if out != ref:
        raise AssertionError('hetero stream differs from '
                             'compress_file_device\'s')
    if stats['device'] <= 0 or got['mtf_scan'] <= 0 \
            or got['code_lengths'] <= 0:
        raise AssertionError('the device worker encoded no block: %s %s'
                             % (stats, got))
    return data, ref, got, stats


def eof_bwt_phase(s5):
    """Phase "EOF BWT (card vs native host)": ``bwt_eof_block`` on the
    card against ``cz_bwt_eof`` (U and pidx) on sample5's first 900,000
    bytes, 900,000 random bytes and 900,000 zeros, and
    ``inverse_bwt_eof_block`` on the card back to the block; each side's
    ms per block (the card's: wall with the card synced, the sort's
    rounds read their tie count on the host) and the card's kernels per
    block (torch.profiler).  Returns {input: numbers}."""
    from compressjs_tpu_torch import native
    from compressjs_tpu_torch.ops import block_decode as bd
    from compressjs_tpu_torch.ops import block_kernels as bk
    n = 900000
    rng = np.random.default_rng(11)
    out = {}
    for name, block in (
            ('sample5', np.frombuffer(s5[:n], np.uint8)),
            ('random', rng.integers(0, 256, n).astype(np.uint8)),
            ('zeros', np.zeros(n, np.uint8))):
        t = torch.from_numpy(block.copy()).cuda()

        def fwd():
            return bk.bwt_eof_block(t, n)

        U, pidx = fwd()
        Un, pn = native.bwt_eof(block)
        if int(pidx) != pn or not np.array_equal(U.cpu().numpy(), Un):
            raise AssertionError('bwt_eof_block of %s differs from '
                                 'cz_bwt_eof' % name)
        Ud = torch.from_numpy(Un).cuda()

        def inv():
            return bd.inverse_bwt_eof_block(Ud, n, pn)

        if not np.array_equal(inv().cpu().numpy(), block):
            raise AssertionError('inverse_bwt_eof_block of %s differs'
                                 % name)
        (_, card_s), (_, host_s) = timed_sync(fwd, 3), \
            timed_sync(lambda: native.bwt_eof(block), 3)
        (_, inv_s), (_, host_inv_s) = timed_sync(inv, 3), \
            timed_sync(lambda: native.inverse_bwt_eof(Un, pn), 3)
        out[name] = {
            'card_ms': card_s * 1e3, 'native_ms': host_s * 1e3,
            'card_kernels': kernels_launched(fwd),
            'inverse_card_ms': inv_s * 1e3,
            'inverse_native_ms': host_inv_s * 1e3,
            'inverse_card_kernels': kernels_launched(inv), 'pidx': pn}
        print('  %s: U and pidx %d equal to cz_bwt_eof, inverse equal to '
              'the block; forward: card %.3f ms (%d kernels), native %.3f '
              'ms; inverse: card %.3f ms (%d kernels), native %.3f ms'
              % (name, pn, out[name]['card_ms'], out[name]['card_kernels'],
                 out[name]['native_ms'], out[name]['inverse_card_ms'],
                 out[name]['inverse_card_kernels'],
                 out[name]['inverse_native_ms']))
    return out


def timed_sync(fn, reps):
    """(fn()'s result, mean wall s of `reps` calls after one warm-up,
    the card synced around each)."""
    out = fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def bwtc_phase(cz, s5, s5x4):
    """Phase "DeviceBWTCEncoder": sample5x4 at -9 (9 full blocks and a
    tail) and sample5 at -1 through ``DeviceBWTCEncoder`` on the card,
    each equal to the host codec ``host.bwtc.BWTC.compress_file`` and
    decoded back by ``BWTC.decompress_file``; both walls in this call,
    and the card's idle share over a profiled device encode."""
    from torch.profiler import ProfilerActivity, profile
    from compressjs_tpu_torch.host.bwtc import BWTC
    out = {}
    for name, data, level in (('sample5x4', s5x4, 9), ('sample5', s5, 1)):
        enc = cz.DeviceBWTCEncoder(level, device='cuda')
        got, dev_s, launches = run_counted(enc.compress, data)
        want, host_s = timed(lambda: bytes(BWTC.compress_file(data, None,
                                                              level)))
        if bytes(got) != want:
            raise AssertionError('DeviceBWTCEncoder of %s differs from the '
                                 'host codec' % name)
        if bytes(BWTC.decompress_file(got)) != data:
            raise AssertionError('BWTC stream of %s does not decode' % name)
        _, dev_s2 = timed(lambda: enc.compress(data))
        _, host_s2 = timed(lambda: BWTC.compress_file(data, None, level))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            enc.compress(data)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        busy = busy_ms(prof.events())
        out[name] = {'bytes_in': len(data), 'bytes_out': len(got),
                     'level': level, 'device_wall_s': [dev_s, dev_s2],
                     'host_wall_s': [host_s, host_s2],
                     'profiled_wall_s': pwall, 'busy_ms': busy,
                     'idle_share': 1 - busy / (pwall * 1e3),
                     'launches': launches}
        print('  %s -%d: %d -> %d bytes, equal to the host codec, decodes; '
              'DeviceBWTCEncoder %.4f s, %.4f s; host BWTC %.4f s, %.4f s; '
              'profiled %.4f s, card busy %.3f ms, idle share %.4f; '
              'package launches %s'
              % (name, level, len(data), len(got), dev_s, dev_s2, host_s,
                 host_s2, pwall, busy, out[name]['idle_share'], launches))
    return out


def mesh_eof_phase(mesh, s5x4):
    """Phase "mesh EOF (NCCL, 1 rank)": ``sharded_bwt_eof`` of sample5x4's
    full BWTC -9 blocks equal to their native transforms
    (``cz_bwt_eof``), and ``sharded_block_decode(eof=True)`` of its
    output equal to the blocks.  Returns the walls."""
    from compressjs_tpu_torch import native
    from compressjs_tpu_torch.parallel import mesh as pm
    n = 900000
    full = [np.frombuffer(s5x4[i * n:(i + 1) * n], np.uint8)
            for i in range(len(s5x4) // n)]
    host_bwts = [native.bwt_eof(b) for b in full]
    blocks = np.stack(full)
    (U, pidx), fwd_s, _ = run_counted(pm.sharded_bwt_eof, mesh, blocks)
    if pidx.cpu().tolist() != [p for _, p in host_bwts] or \
            not np.array_equal(U.cpu().numpy(),
                               np.stack([u for u, _ in host_bwts])):
        raise AssertionError('sharded_bwt_eof differs from cz_bwt_eof')
    inv, inv_s, _ = run_counted(pm.sharded_block_decode, mesh, U, pidx,
                                eof=True)
    if not np.array_equal(inv.cpu().numpy(), blocks):
        raise AssertionError('sharded_block_decode(eof=True) differs from '
                             'the blocks')
    print('  sharded_bwt_eof of %d blocks of %d bytes: %.3f s, equal to '
          'cz_bwt_eof; sharded_block_decode(eof=True): %.3f s, equal to '
          'the blocks' % (len(full), blocks.shape[1], fwd_s, inv_s))
    return {'sharded_bwt_eof_s': fwd_s, 'sharded_block_decode_eof_s': inv_s}


def cp_sort_phase(mesh, s5x4):
    """Phase "CP rotation sort (NCCL, 1 rank)": ``sharded_cyclic_suffix_
    sort`` of a 2^20-byte slice of sample5x4 (every exchange a local
    copy at one rank) against ``host.bwt.cyclic_suffix_array``."""
    from compressjs_tpu_torch.host.bwt import cyclic_suffix_array
    from compressjs_tpu_torch.parallel.sharded_sort import \
        sharded_cyclic_suffix_sort
    block = np.frombuffer(s5x4[:1 << 20], np.uint8)
    order, wall, _ = run_counted(sharded_cyclic_suffix_sort, mesh, block)
    want, host_s = timed(lambda: cyclic_suffix_array(block, block.shape[0]))
    if not np.array_equal(order.cpu().numpy(), want):
        raise AssertionError('sharded_cyclic_suffix_sort differs from '
                             'cyclic_suffix_array')
    _, wall2, _ = run_counted(sharded_cyclic_suffix_sort, mesh, block)
    print('  %d bytes: %.3f s, %.3f s, equal to cyclic_suffix_array '
          '(numpy, %.3f s)' % (block.shape[0], wall, wall2, host_s))
    return {'cp_sort_s': [wall, wall2], 'cyclic_suffix_array_s': host_s}


def ref_ties_phase(cz, s5x4):
    """Phase "reference ties": with COMPRESSJS_TPU_BZ2_REF_TIES=1 the
    'core' and 'hybrid' encodes of sample5x4 equal the hosts-only hetero
    encode (the host Huffman stage's reference grouping), which differs
    from the golden's default grouping."""
    os.environ['COMPRESSJS_TPU_BZ2_REF_TIES'] = '1'
    try:
        want = cz.hetero_compress_bzip2(s5x4, level=9, device=None)
        sizes = {'hetero_hosts_only': len(want)}
        for mode in ('core', 'hybrid'):
            got = cz.compress_file_device(s5x4, level=9, mode=mode,
                                          device='cuda')
            if got != want:
                raise AssertionError('%s with reference ties differs from '
                                     'the hosts-only hetero encode' % mode)
            sizes[mode] = len(got)
    finally:
        del os.environ['COMPRESSJS_TPU_BZ2_REF_TIES']
    if bz2.decompress(want) != s5x4:
        raise AssertionError('reference-ties stream does not decode')
    print('  core, hybrid and hetero (hosts only) give the same %d bytes '
          '(%s)' % (len(want), sizes))
    return sizes


def bwtcp_lane(block, dev):
    """One 900,000-byte block as ``bwtcp_compress_device`` gives it to the
    scan kernels, built on the card as the path builds it: (symbols
    (900,001,) int32, valid (900,001,) bool, N, the coder state (5,)
    int64 the host leaves after the block's header), with its RLE2
    count and used alphabet's size."""
    from compressjs_tpu_torch.host import bwtcp as hbwtcp
    from compressjs_tpu_torch.host.range_coder import RangeCoder
    from compressjs_tpu_torch.host.stream import BufferStream
    from compressjs_tpu_torch.ops import block_kernels as bk
    from compressjs_tpu_torch.host.bzip2 import block_meta
    bs = block.shape[0]
    used, asize, remap = block_meta(block)
    U, pidx = bk.bwt_eof_block(torch.from_numpy(block.copy()).to(dev), bs)
    dense = torch.from_numpy(remap).to(dev)[U.long()].to(torch.int32)
    syms, cnt, _ = bk.rle2_encode(bk.mtf_encode(dense, bs), bs, 0)
    S = int(cnt) - 1
    out = BufferStream()
    enc = RangeCoder(out)
    enc.encode_start(0, 0)
    hbwtcp._write_header(enc, 9, bs, int(pidx), used)
    return (syms.to(torch.int32), torch.arange(bs + 1, device=dev) < S,
            asize + 2, torch.from_numpy(enc.export_enc_state()).to(dev),
            S, asize)


def scan_inputs(s5, dev):
    """sample5's first 900,000 bytes as the two BWTC paths give them to
    the scan kernels, built on the card as the paths build them: the
    BWTC-L lanes (128, 7,032) and the BWTC-P lane (1, 900,001) with the
    coder state the host leaves after the block's header.  Returns
    {'L': (syms, valid, Ns), 'P': (syms, valid, Ns, init)}."""
    from compressjs_tpu_torch.ops import device_lane as dl
    bs, lanes = 900000, 128
    syms, pvalid, N, state, S, asize = bwtcp_lane(
        np.frombuffer(s5[:bs], np.uint8), dev)
    T = dl.lane_caps(bs, lanes)[0]
    padded = torch.zeros(T * lanes, dtype=torch.int32, device=dev)
    padded[:bs + 1] = syms
    lane_l = (padded.view(T, lanes).T.contiguous(),
              dl._lane_valid(T, lanes, S, dev),
              torch.full((lanes,), N, dtype=torch.int32, device=dev))
    lane_p = (syms[None, :], pvalid[None, :],
              torch.tensor([N], dtype=torch.int32, device=dev),
              state[None, :])
    return {'L': lane_l, 'P': lane_p, 'S': S, 'asize': asize}


def dispatch_inputs(s5x4, dev, n=8):
    """The first `n` full -9 blocks of sample5x4 as one BWTC-P dispatch
    gives them to the scan kernels: (syms, valid, Ns, init), (n,
    900,001) lanes."""
    lanes = [bwtcp_lane(np.frombuffer(s5x4[k * 900000:(k + 1) * 900000],
                                      np.uint8), dev) for k in range(n)]
    return (torch.stack([x[0] for x in lanes]),
            torch.stack([x[1] for x in lanes]),
            torch.tensor([x[2] for x in lanes], dtype=torch.int32,
                         device=dev),
            torch.stack([x[3] for x in lanes]))


def check_scans(syms, valid, Ns, max_prob, init, tok_cap, dev, reps,
                smem_ns, plain=True, decode=True):
    """The scan kernels on one input against their plain versions on the
    same tensors on the card (where `plain`): the encode's triples, the
    coder's tokens, counts and byte counts, the fused model and coder
    (``fenwick_code``) against the plain encode -> coder composition,
    and (where `decode`) the decode of the coder's bytes (from the free
    byte's state, rows cut at the longest lane: the EOF byte).  On every
    input the fused entry equals the two unfused kernels in series.  Then
    each kernel alone (its C entry, outputs allocated once) and each
    wrapper by CUDA events over `reps` launches, each plain version's
    wall once, and the bounds.  Returns a dict."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import device_coder as dc
    from compressjs_tpu_torch.ops import device_model as dm
    L, T = syms.shape
    max_n, incr = 258, 0x100
    res = {'lanes': L, 'steps': T, 'valid_steps': int(valid.sum())}
    model_args = (syms, valid, Ns, max_n, max_prob, incr)
    enc = dm.fenwick_encode_streams(*model_args)
    tok = dc.batched_range_encode(*enc, None, None, tok_cap,
                                  init_state=init)
    fused = dm.fenwick_code_streams(*model_args, init, tok_cap)
    res['code_vs_series_err'] = max_err(fused, tok)
    if res['code_vs_series_err']:
        raise AssertionError('fenwick_code differs from fenwick_encode -> '
                             'range_encode on %d x %d' % (L, T))
    byts, lens = dc.token_bytes(*tok, 3 * T + 64)
    byts = byts[:, :int(lens.max())].contiguous()
    st = torch.stack(dc.dec_start_state(byts, torch.ones(
        L, dtype=torch.int64, device=dev)), 1)
    if decode:
        dec = dm.fenwick_decode_streams(byts, st, Ns, max_n, max_prob, incr,
                                        valid)
    if plain:
        enc_p, res['encode_plain_ms'] = timed_card(
            lambda: dm.fenwick_encode_streams_plain(*model_args))
        # the plain coder on the kernel's triples, which equal the plain
        # encode's: the plain composition, the fused entry's plain version
        tok_p, res['coder_plain_ms'] = timed_card(
            lambda: dc.batched_range_encode_plain(*enc, init, tok_cap))
        res['code_plain_ms'] = res['encode_plain_ms'] + res['coder_plain_ms']
        dec_p, res['decode_plain_ms'] = timed_card(
            lambda: dm.fenwick_decode_streams_plain(byts, st, Ns, max_n,
                                                    max_prob, incr, valid))
        res['encode_err'] = max_err(enc, enc_p)
        res['coder_err'] = max_err(tok, tok_p)
        res['code_err'] = max_err(fused, tok_p)
        res['decode_err'] = max_err((dec[0],) + dec[1],
                                    (dec_p[0],) + dec_p[1])
        if max(res['encode_err'], res['coder_err'], res['code_err'],
               res['decode_err']):
            raise AssertionError('scan kernels differ from their plain '
                                 'versions on %d x %d: %s' % (L, T, res))
    # the stream decodes to its symbols where its coder started fresh
    # (init is then encode_start's)
    if decode and bool((init[:, 1] == 1 << 31).all() and
                       (init[:, 0] == 0).all()):
        res['round_trip'] = bool(torch.equal(dec[0][valid], syms[valid]))
        if not res['round_trip']:
            raise AssertionError('scan kernels: %d x %d lanes do not decode '
                                 'to their symbols' % (L, T))
    # the kernels alone
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)
    s32, v8, n32 = (syms.to(torch.int32).contiguous(),
                    valid.to(torch.uint8).contiguous(),
                    Ns.to(torch.int32).contiguous())
    sy, lt, tot, vo = (torch.empty_like(x) for x in enc)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    tokens = torch.zeros((L, tok_cap, 3), dtype=torch.int32, device=dev)
    tok_n = torch.empty(L, dtype=torch.int32, device=dev)
    nbytes = torch.empty(L, dtype=torch.int64, device=dev)
    ev8 = enc[3].to(torch.uint8).contiguous()
    st0 = torch.stack(dm._dec_states(st), 1).contiguous()
    st1 = st0.clone()
    out = torch.empty((L, T), dtype=torch.int32, device=dev)
    init = init.contiguous()

    def k_enc():
        _cuda.check(lib.cz_fenwick_encode(
            s32.data_ptr(), v8.data_ptr(), n32.data_ptr(), L, T, max_n,
            max_prob, incr, sy.data_ptr(), lt.data_ptr(), tot.data_ptr(),
            vo.data_ptr(), err.data_ptr(), stream), 'fenwick_encode')

    def k_coder():
        _cuda.check(lib.cz_range_encode(
            enc[0].data_ptr(), enc[1].data_ptr(), enc[2].data_ptr(),
            ev8.data_ptr(), init.data_ptr(), L, 2 * T, tokens.data_ptr(),
            tok_cap, tok_n.data_ptr(), nbytes.data_ptr(), stream),
            'range_encode')

    def k_code():
        _cuda.check(lib.cz_fenwick_code(
            s32.data_ptr(), v8.data_ptr(), n32.data_ptr(), L, T, max_n,
            max_prob, incr, init.data_ptr(), tokens.data_ptr(), tok_cap,
            tok_n.data_ptr(), nbytes.data_ptr(), err.data_ptr(), stream),
            'fenwick_code')

    def k_dec():
        st1.copy_(st0)
        _cuda.check(lib.cz_fenwick_decode(
            byts.data_ptr(), byts.shape[1], st1.data_ptr(), n32.data_ptr(),
            v8.data_ptr(), L, T, max_n, max_prob, incr, out.data_ptr(),
            err.data_ptr(), stream), 'fenwick_decode')

    res['encode_ms'] = cuda_ms(k_enc, reps)
    res['coder_ms'] = cuda_ms(k_coder, reps)
    res['code_ms'] = cuda_ms(k_code, reps)
    if decode:
        res['decode_ms'] = cuda_ms(k_dec, reps)
    if int(err):
        raise AssertionError('a scan kernel flagged its input')
    # the wrappers (their allocations and, but for the coder's, the read
    # of the error flag)
    res['encode_wrapper_ms'] = cuda_ms(
        lambda: dm.fenwick_encode_streams(*model_args), reps)
    res['coder_wrapper_ms'] = cuda_ms(
        lambda: dc.batched_range_encode(*enc, None, None, tok_cap,
                                        init_state=init), reps)
    res['code_wrapper_ms'] = cuda_ms(
        lambda: dm.fenwick_code_streams(*model_args, init, tok_cap), reps)
    if decode:
        res['decode_wrapper_ms'] = cuda_ms(
            lambda: dm.fenwick_decode_streams(byts, st, Ns, max_n, max_prob,
                                              incr, valid), reps)
    # bounds: the bytes the outputs need, in and out once at the HBM
    # rate; integer operations (per valid symbol a walk of `levels`
    # read-add-write steps of ~4 operations; per valid triple ~12 coder
    # operations) at the INT32 rate; and two latency floors of the
    # longest lane: the per-level chain of one thread walking the tree
    # (one dependent shared-memory step, smem_ns from
    # cz_smem_chain_probe, per tree level per symbol), and the coder's
    # chain (one such step per valid triple), which nothing in the fused
    # work splits.  The model alone writes every slot, masked ones too,
    # so it reads every symbol; the coder's tokens and the fused entry's
    # depend only on the valid bytes and the valid steps' symbols or
    # triples (4 or 12 bytes each), and each lane's state, counts and
    # size (the coder 40 + 4 + 8 bytes, the fused entry 4 more)
    levels = int(Ns.max()).bit_length()
    n_valid, n_trip = int(valid.sum()), int(enc[3].sum())
    lane_valid = int(valid.sum(1).max())
    lane_trip = int(enc[3].sum(1).max())
    n_tok = int(tok[1].clamp(max=tok_cap).sum())
    res['encode_bound_ms'], res['encode_bound_by'] = bound(
        L * T * 5 + L * 2 * T * 13, n_valid * levels * 4)
    res['coder_bound_ms'], res['coder_bound_by'] = bound(
        L * 2 * T + n_trip * 12 + L * 52 + n_tok * 12, n_trip * 12)
    res['code_bound_ms'], res['code_bound_by'] = bound(
        L * T + n_valid * 4 + L * 56 + n_tok * 12,
        n_valid * levels * 4 + n_trip * 12)
    res['decode_bound_ms'], res['decode_bound_by'] = bound(
        int(lens.sum()) + L * T * 5, n_valid * levels * 5)
    res['encode_chain_floor_ms'] = lane_valid * levels * smem_ns * 1e-6
    res['coder_chain_floor_ms'] = lane_trip * smem_ns * 1e-6
    res['code_chain_floor_ms'] = res['coder_chain_floor_ms']
    res['code_level_chain_floor_ms'] = res['encode_chain_floor_ms']
    res['decode_chain_floor_ms'] = lane_valid * levels * smem_ns * 1e-6
    # the decode's own design floor: a sub-decode (a valid triple) takes
    # ceil(levels / k) shared-memory rounds, k the tree levels a descent
    # round of the build takes
    k = int(lib.cz_fenwick_decode_levels())
    res['decode_levels_per_round'] = k
    res['decode_round_floor_ms'] = lane_trip * -(-levels // k) * smem_ns * \
        1e-6
    res['tokens'] = n_tok
    res['bytes'] = int(lens.sum())
    return res


def max_err(got, want):
    """Largest absolute difference over pairs of integer tensors."""
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def timed_card(fn):
    """(fn(), its wall ms with the card synced around it)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def scan_phase(s5, s5x4, dev, smem_ns):
    """Phase "Fenwick/coder kernels vs plain versions": the scan kernels
    (the model, the coder, the two fused, the decode) against their plain
    versions on sample5's first -9 block as BWTC-L's 128 lanes (every
    step), on the first 4,096 steps of that block's BWTC-P lane (the
    plain versions cannot walk its 900,001 steps inside the smoke's time
    limit), and on 128 random lanes with max_prob 0x400 (escapes and
    rescales); then the kernels on the whole BWTC-P lane, where they
    decode what they coded, and on the 8-lane BWTC-P dispatch of
    sample5x4's first 8 blocks with the host's header states, the main
    path's shapes, where the fused entry equals the unfused two in
    series, and on that dispatch from fresh coder states, where the
    decode gives its symbols back."""
    from compressjs_tpu_torch.ops import device_coder as dc
    from compressjs_tpu_torch.ops import device_lane as dl
    inp = scan_inputs(s5, dev)
    out = {'asize': inp['asize'], 'S': inp['S']}
    lsyms, lvalid, lNs = inp['L']
    zeros = torch.zeros(lsyms.shape[0], dtype=torch.int64, device=dev)
    out['bwtcl_lanes'] = check_scans(
        lsyms, lvalid, lNs, 0xFF00, dc.encoder_states(zeros, zeros),
        dl.lane_caps(900000, 128)[1], dev, 20, smem_ns)
    psyms, pvalid, pNs, pinit = inp['P']
    n = 4096
    out['bwtcp_lane_4096'] = check_scans(
        psyms[:, :n].contiguous(), pvalid[:, :n].contiguous(), pNs, 0xFF00,
        pinit, 2 * n + 8, dev, 20, smem_ns)
    rng = np.random.default_rng(77)
    L, T = 128, 1000
    sizes = rng.integers(1, 257, L)
    rsyms = np.minimum(rng.zipf(1.2, (L, T)) - 1, sizes[:, None] - 1)
    rvalid = np.arange(T)[None, :] < rng.integers(T // 2, T + 1, L)[:, None]
    zeros = torch.zeros(L, dtype=torch.int64, device=dev)
    out['random_0x400'] = check_scans(
        torch.from_numpy(rsyms.astype(np.int32)).to(dev),
        torch.from_numpy(rvalid).to(dev),
        torch.from_numpy((sizes + 1).astype(np.int32)).to(dev), 0x400,
        dc.encoder_states(zeros, zeros), 2 * T + 8, dev, 20, smem_ns)
    # the whole lane from a fresh coder, so that its decode is of a real
    # stream: the kernels against each other (encode -> code -> decode
    # gives the symbols back); its block stream is held to the host
    # codec's in "BWTC-P on the card"
    tok_cap = 900000 + (900000 >> 2) + 64
    zeros = torch.zeros(1, dtype=torch.int64, device=dev)
    out['bwtcp_lane_full'] = check_scans(
        psyms.contiguous(), pvalid.contiguous(), pNs, 0xFF00,
        dc.encoder_states(zeros, zeros), tok_cap, dev, 3, smem_ns,
        plain=False)
    dsyms, dvalid, dNs, dinit = dispatch_inputs(s5x4, dev)
    out['bwtcp_dispatch_8'] = check_scans(
        dsyms, dvalid, dNs, 0xFF00, dinit, tok_cap, dev, 3, smem_ns,
        plain=False, decode=False)
    # the same lanes from fresh coders, so that the decode has a real
    # stream to decode (8 lanes on 8 SMs: about one lane's time)
    zeros = torch.zeros(dsyms.shape[0], dtype=torch.int64, device=dev)
    out['bwtcp_dispatch_8_fresh'] = check_scans(
        dsyms, dvalid, dNs, 0xFF00, dc.encoder_states(zeros, zeros),
        tok_cap, dev, 3, smem_ns, plain=False)
    for name, r in out.items():
        if not isinstance(r, dict):
            continue
        print('  %s (%d x %d, %d valid steps): encode %.4f ms (wrapper '
              '%.4f, plain %s), coder %.4f ms (wrapper %.4f, plain %s), '
              'fused %.4f ms (wrapper %.4f, plain %s), decode %s '
              '(wrapper %s, plain %s); bounds %.5f / %.5f / %.5f ms / %s; '
              'per-level chain floor %.4f ms, coder chain floor %.4f ms, '
              'decode round floor %s (%d levels a round)'
              % (name, r['lanes'], r['steps'], r['valid_steps'],
                 r['encode_ms'], r['encode_wrapper_ms'],
                 _ms(r.get('encode_plain_ms')), r['coder_ms'],
                 r['coder_wrapper_ms'], _ms(r.get('coder_plain_ms')),
                 r['code_ms'], r['code_wrapper_ms'],
                 _ms(r.get('code_plain_ms')), _ms(r.get('decode_ms'), 4),
                 _ms(r.get('decode_wrapper_ms'), 4),
                 _ms(r.get('decode_plain_ms')), r['encode_bound_ms'],
                 r['coder_bound_ms'], r['code_bound_ms'],
                 _ms(r['decode_bound_ms'] if 'decode_ms' in r else None,
                     5), r['encode_chain_floor_ms'],
                 r['coder_chain_floor_ms'],
                 _ms(r['decode_round_floor_ms'] if 'decode_ms' in r
                     else None, 4), r['decode_levels_per_round']))
    print('  the plain versions walk every step of the BWTC-L lanes and of '
          'the random lanes, and the first 4,096 of the BWTC-P lane\'s '
          '900,001 (all of them would outlast the smoke\'s time limit); '
          'on every input the fused entry equals fenwick_encode -> '
          'range_encode')
    return out


def _ms(x, digits=1):
    return 'not run' if x is None else '%.*f ms' % (digits, x)


def bwtcp_phase(cz, s5x4):
    """Phase "BWTC-P on the card": ``bwtcp_compress_device`` of sample5x4
    at -9 against the host codec ``BWTCP.compress_file`` (in this call),
    decoded back by the host decoder; walls, the card's busy ms and idle
    share over a profiled run, the kernels' launches and the routes'
    block counts (overflow_blocks among them)."""
    from compressjs_tpu_torch.host.bwtcp import BWTCP
    from compressjs_tpu_torch.parallel import pipeline as pl
    got, dev_s, launches = run_counted(cz.bwtcp_compress_device, s5x4,
                                       level=9)
    stats = dict(pl.bwtcp_compress_device.last_stats)
    want, host_s = timed(lambda: bytes(BWTCP.compress_file(s5x4, None, 9)))
    if bytes(got) != want:
        raise AssertionError('bwtcp_compress_device differs from the host '
                             'codec')
    if bytes(BWTCP.decompress_file(got)) != s5x4:
        raise AssertionError('BWTC-P stream does not decode')
    n_full = len(s5x4) // 900000
    if stats['device_blocks'] + stats['overflow_blocks'] != n_full or \
            launches['fenwick_code'] < 1 or launches['fenwick_encode'] or \
            launches['range_encode'] or launches['mtf_scan'] != 3 * n_full:
        raise AssertionError('BWTC-P path: launches %s, stats %s'
                             % (launches, stats))
    _, dev_s2 = timed(lambda: cz.bwtcp_compress_device(s5x4, level=9))
    _, host_s2 = timed(lambda: BWTCP.compress_file(s5x4, None, 9))
    pwall, busy = profiled(lambda: cz.bwtcp_compress_device(s5x4, level=9))
    out = {'bytes_in': len(s5x4), 'bytes_out': len(got),
           'device_wall_s': [dev_s, dev_s2], 'host_wall_s': [host_s, host_s2],
           'profiled_wall_s': pwall, 'busy_ms': busy,
           'idle_share': 1 - busy / (pwall * 1e3), 'launches': launches,
           'stats': stats}
    print('  sample5x4 -9: %d -> %d bytes, equal to the host codec, decodes; '
          'card path %.4f s, %.4f s; host BWTCP %.4f s, %.4f s; profiled '
          '%.4f s, card busy %.3f ms, idle share %.4f; launches %s; blocks '
          '%s' % (len(s5x4), len(got), dev_s, dev_s2, host_s, host_s2, pwall,
                  busy, out['idle_share'], launches, stats))
    return out


def profiled(fn):
    """(wall s, the card's busy ms) of one fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    return pwall, busy_ms(prof.events())


def bwtcl_phase(cz, s5x4):
    """Phase "BWTC-L on the card": ``bwtcl_compress_device`` of sample5x4
    at -9 against the host codec ``BWTCL.compress_file``, and
    ``bwtcl_decompress_device`` of it and of the host's stream back to
    sample5x4; walls against the host codec's in this call, busy ms and
    idle share of each direction, the launches of each."""
    from compressjs_tpu_torch.host.bwtcl import BWTCL
    from compressjs_tpu_torch.parallel import pipeline as pl
    got, enc_s, enc_launches = run_counted(cz.bwtcl_compress_device, s5x4,
                                           level=9)
    enc_stats = dict(pl.bwtcl_compress_device.last_stats)
    want, host_enc_s = timed(lambda: bytes(BWTCL.compress_file(s5x4, None,
                                                               9)))
    if bytes(got) != want:
        raise AssertionError('bwtcl_compress_device differs from the host '
                             'codec')
    back, dec_s, dec_launches = run_counted(cz.bwtcl_decompress_device, got)
    dec_stats = dict(pl.bwtcl_decompress_device.last_stats)
    if bytes(back) != s5x4 or bytes(cz.bwtcl_decompress_device(want)) != \
            s5x4:
        raise AssertionError('bwtcl_decompress_device does not return '
                             'sample5x4')
    host_back, host_dec_s = timed(lambda: BWTCL.decompress_file(want))
    if bytes(host_back) != s5x4:
        raise AssertionError('host BWTC-L decode differs')
    n_full = len(s5x4) // 900000
    if enc_launches['fenwick_code'] != enc_stats['device_blocks'] or \
            enc_launches['fenwick_encode'] or enc_launches['range_encode'] or \
            enc_launches['mtf_scan'] != 3 * n_full or \
            dec_launches['fenwick_decode'] != dec_stats['device_blocks'] or \
            dec_launches['mtf_undo'] != 3 * dec_stats['device_blocks'] or \
            not dec_stats['device_blocks']:
        raise AssertionError('BWTC-L paths: launches %s / %s, stats %s / %s'
                             % (enc_launches, dec_launches, enc_stats,
                                dec_stats))
    _, enc_s2 = timed(lambda: cz.bwtcl_compress_device(s5x4, level=9))
    _, host_enc_s2 = timed(lambda: BWTCL.compress_file(s5x4, None, 9))
    _, dec_s2 = timed(lambda: cz.bwtcl_decompress_device(got))
    _, host_dec_s2 = timed(lambda: BWTCL.decompress_file(want))
    enc_pwall, enc_busy = profiled(
        lambda: cz.bwtcl_compress_device(s5x4, level=9))
    dec_pwall, dec_busy = profiled(lambda: cz.bwtcl_decompress_device(got))
    out = {'bytes_in': len(s5x4), 'bytes_out': len(got),
           'encode_wall_s': [enc_s, enc_s2],
           'host_encode_wall_s': [host_enc_s, host_enc_s2],
           'decode_wall_s': [dec_s, dec_s2],
           'host_decode_wall_s': [host_dec_s, host_dec_s2],
           'encode_profiled_wall_s': enc_pwall, 'encode_busy_ms': enc_busy,
           'encode_idle_share': 1 - enc_busy / (enc_pwall * 1e3),
           'decode_profiled_wall_s': dec_pwall, 'decode_busy_ms': dec_busy,
           'decode_idle_share': 1 - dec_busy / (dec_pwall * 1e3),
           'encode_launches': enc_launches, 'decode_launches': dec_launches,
           'encode_stats': enc_stats, 'decode_stats': dec_stats}
    print('  sample5x4 -9: %d -> %d bytes, equal to the host codec; decodes '
          '(card and host streams); encode: card %.4f s, %.4f s, host %.4f '
          's, %.4f s, busy %.3f ms, idle share %.4f; decode: card %.4f s, '
          '%.4f s, host %.4f s, %.4f s, busy %.3f ms, idle share %.4f'
          % (len(s5x4), len(got), enc_s, enc_s2, host_enc_s, host_enc_s2,
             enc_busy, out['encode_idle_share'], dec_s, dec_s2, host_dec_s,
             host_dec_s2, dec_busy, out['decode_idle_share']))
    print('  launches: encode %s, decode %s; blocks: encode %s, decode %s'
          % (enc_launches, dec_launches, enc_stats, dec_stats))
    return out


def mesh_bwtcp_phase(cz, mesh, s5x4):
    """Phase "mesh BWTC-P (NCCL, 1 rank)": ``mesh_compress_bwtcp`` of
    sample5x4 at -9 equal to the host codec's bytes."""
    from compressjs_tpu_torch.host.bwtcp import BWTCP
    got, wall, launches = run_counted(cz.mesh_compress_bwtcp, mesh, s5x4,
                                      level=9)
    want = bytes(BWTCP.compress_file(s5x4, None, 9))
    if bytes(got) != want:
        raise AssertionError('mesh_compress_bwtcp differs from the host '
                             'codec')
    _, wall2, _ = run_counted(cz.mesh_compress_bwtcp, mesh, s5x4, level=9)
    print('  mesh_compress_bwtcp of sample5x4 -9: %d bytes, equal to the '
          'host codec; %.3f s, %.3f s; launches %s'
          % (len(got), wall, wall2, launches))
    return {'wall_s': [wall, wall2], 'launches': launches}


def busy_ms(events):
    """Union of the card's kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


# the encoder configurations the smoke drives: the main path, 'full',
# first, then the other two splits and the batched BWT
ENCODE_MODES = [('full', {'mode': 'full'}), ('core', {'mode': 'core'}),
                ('hybrid', {'mode': 'hybrid'}),
                ('hybrid_batch', {'mode': 'hybrid', 'batch': True})]


def mode_timing(cz, data, want, kw):
    """(wall s of one warm encode, its profiled wall s, the card's busy
    ms in the profiled run, its idle share)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    out, wall = timed(lambda: cz.compress_file_device(data, level=9, **kw))
    torch.cuda.synchronize()
    if out != want:
        raise AssertionError('timed encode differs from the golden: %s' % kw)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cz.compress_file_device(data, level=9, **kw)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    busy = busy_ms(prof.events())
    return wall, pwall, busy, 1 - busy / (pwall * 1e3)


# the host codecs the command line runs on every device, at their
# default level (7): (dispatch key, class name)
CLI_HOST_CODECS = (('lzp3', 'Lzp3'), ('lzjb', 'Lzjb'), ('lzjbr', 'LzjbR'),
                   ('ppm', 'PPM'), ('dmc', 'Dmc'), ('simple', 'Simple'),
                   ('defsum', 'DefSumModel'), ('fenwick', 'FenwickModel'),
                   ('mtf', 'MTFModel'), ('context1', 'Context1Model'),
                   ('no', 'NoModel'), ('huff', 'Huffman'))


def cli_phase(cz, s5, s5_comp, s5x4, s5x4_comp, card):
    """Phase "CLI on the card": ``compressjs_tpu_torch.cli.main`` in this
    process on files in a temporary directory -- -z -t bzip2 -9 of
    sample5x4 against its golden with mtf_scan and code_lengths launched,
    -d back; -z -t bwtcp -9 (fenwick_code launched) and -z -t bwtc -9
    against the host codecs' bytes; every host codec round trip on
    sample5 at level 7 -- and one ``python -m compressjs_tpu_torch.cli``
    subprocess (-z -t bzip2 -9 of sample5 through stdin and stdout,
    against its golden).  Returns each call's wall, MB/s and launches,
    and the launches of the card routes by path."""
    import tempfile
    from compressjs_tpu_torch import cli

    res, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        def path(name):
            return os.path.join(tmp, name)

        def call(label, argv, nbytes):
            code, wall, counts = run_counted(cli.main, argv)
            if code != 0:
                raise AssertionError('cli %s exited %s' % (argv, code))
            res[label] = {'wall_s': wall, 'mb_s': nbytes / wall / 1e6,
                          'launches': {k: v for k, v in counts.items()
                                       if v}}
            print('  %-28s wall %.4f s (%.3f MB/s of input); launches %s; '
                  '%s' % (label, wall, nbytes / wall / 1e6,
                          res[label]['launches'], card), flush=True)
            return counts

        def read(name):
            with open(path(name), 'rb') as f:
                return f.read()

        for name, data in (('s5', s5), ('s5x4', s5x4)):
            with open(path(name), 'wb') as f:
                f.write(data)
        n = len(s5x4)
        c = call('-z -t bzip2 -9', ['-z', '-t', 'bzip2', '-9', path('s5x4'),
                                    path('s5x4.bz2')], n)
        if read('s5x4.bz2') != s5x4_comp:
            raise AssertionError('cli bzip2 -9 encode differs from golden')
        if not (c['mtf_scan'] > 0 and c['code_lengths'] > 0):
            raise AssertionError('cli bzip2 encode launched no mtf_scan or '
                                 'code_lengths: %s' % c)
        launches['cli_bzip2'] = c
        call('-d -t bzip2', ['-d', '-t', 'bzip2', path('s5x4.bz2'),
                             path('s5x4.out')], n)
        if read('s5x4.out') != s5x4:
            raise AssertionError('cli bzip2 decode differs')
        c = call('-z -t bwtcp -9', ['-z', '-t', 'bwtcp', '-9', path('s5x4'),
                                    path('s5x4.bwtp')], n)
        if c['fenwick_code'] == 0:
            raise AssertionError('cli bwtcp encode launched no fenwick_code')
        launches['cli_bwtcp'] = c
        if read('s5x4.bwtp') != bytes(cz.BWTCP.compress_file(s5x4, None, 9)):
            raise AssertionError('cli bwtcp encode differs from host BWTCP')
        launches['cli_bwtc'] = call(
            '-z -t bwtc -9', ['-z', '-t', 'bwtc', '-9', path('s5x4'),
                              path('s5x4.bwtc')], n)
        if read('s5x4.bwtc') != bytes(cz.BWTC.compress_file(s5x4, None, 9)):
            raise AssertionError('cli bwtc encode differs from host BWTC')
        call('-d -t bwtcp', ['-d', '-t', 'bwtcp', path('s5x4.bwtp'),
                             path('s5x4.bwtp.out')], n)
        if read('s5x4.bwtp.out') != s5x4:
            raise AssertionError('cli bwtcp decode differs')
        for key, name in CLI_HOST_CODECS:
            c = call('-z -t %s' % key, ['-z', '-t', key, path('s5'),
                                        path('s5.' + key)], len(s5))
            if any(c.values()):
                raise AssertionError('host codec %s launched a kernel'
                                     % key)
            call('-d -t %s' % key, ['-d', '-t', key, path('s5.' + key),
                                    path('s5.' + key + '.out')], len(s5))
            if read('s5.' + key + '.out') != s5:
                raise AssertionError('cli %s round trip differs' % key)
            res['-z -t %s' % key]['ratio'] = \
                os.path.getsize(path('s5.' + key)) / len(s5)
        # corrupt streams: the JAX command line's stderr line and exit 1
        # (its texts, which tests/test_torch_cli.py holds the port to)
        for label, bad, want in (
                ('bad block magic', s5_comp[:4] + bytes([s5_comp[4] ^ 0xFF])
                 + s5_comp[5:], 'error: Not bzip data\n'),
                ('truncated in half', s5_comp[:len(s5_comp) // 2],
                 'error: Data error\n')):
            with open(path('bad.bz2'), 'wb') as f:
                f.write(bad)
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                code = cli.main(['-d', '-t', 'bzip2', path('bad.bz2'),
                                 path('bad.out')])
            if code != 1 or err.getvalue() != want:
                raise AssertionError('cli -d of a corrupt stream (%s): exit '
                                     '%r, stderr %r, not 1 and %r'
                                     % (label, code, err.getvalue(), want))
            print('  -d -t bzip2 of sample5 with a %s: exit 1, stderr %r '
                  '(the JAX CLI\'s)' % (label, want), flush=True)
        env = dict(os.environ, PYTHONPATH=ROOT)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'compressjs_tpu_torch.cli', '-z', '-t',
             'bzip2', '-9'], input=s5, capture_output=True, env=env,
            cwd=ROOT, timeout=300)
        wall = time.perf_counter() - t0
        if proc.returncode != 0 or proc.stdout != s5_comp:
            raise AssertionError('python -m compressjs_tpu_torch.cli -z -t '
                                 'bzip2 -9 (stdin to stdout) failed: rc %d, '
                                 '%s' % (proc.returncode, proc.stderr[-2000:]))
        res['python -m cli -z -t bzip2 -9 (stdin, stdout)'] = {
            'wall_s': wall, 'mb_s': len(s5) / wall / 1e6}
        print('  python -m compressjs_tpu_torch.cli -z -t bzip2 -9 < sample5: '
              'wall %.4f s with the interpreter, torch import and kernel '
              'build reuse (%.3f MB/s); equals the golden; %s'
              % (wall, len(s5) / wall / 1e6, card), flush=True)
    return res, launches


def main():
    t_start = time.perf_counter()
    # a hang anywhere prints every thread's stack and exits non-zero
    # inside the smoke's 1200 s limit
    faulthandler.dump_traceback_later(1100, exit=True)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import compressjs_tpu_torch as cz
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.host.bzip2 import split_blocks
    dev = torch.device('cuda')

    phase('card')
    card = card_line()
    print(card, flush=True)
    print('torch %s, CUDA %s, %s' % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    phase('build')
    _cuda.lib()
    print('build %.2f s -> %s' % (_cuda.build_info['seconds'],
                                  _cuda.build_info['path']))
    for line in _cuda.build_info['log'].splitlines():
        if 'ptxas' in line or 'stack frame' in line:
            print('  ' + line.strip())
    frames = ptxas_frames(_cuda.build_info['log'], (
        'mtf_tiles_kernel', 'mtf_prefix_kernel', 'mtf_encode_kernel',
        'mtf_undo_perm_kernel', 'mtf_undo_prefix_kernel',
        'mtf_undo_decode_kernel'))
    print('  MTF kernels (registers, stack frame bytes): %s' % frames)

    s5_comp, s5 = golden('sample5_bzip2_9.bz2')
    s5x4_comp, s5x4 = golden('sample5x4_bzip2_9.bz2')

    phase('native host runtime')
    from compressjs_tpu_torch import native
    native.lib()
    print('  build %.2f s -> %s; %s; host CPU %s, -march=native is %s'
          % (native.build_info['seconds'], native.build_info['path'],
             native.build_info['compiler'], native.build_info['cpu'],
             native.build_info['march']))
    host_rt, n_host_blocks, n_host_bytes = check_host_runtime(s5x4)
    for name, e in host_rt.items():
        print('  %-20s native %.4f ms x %d, numpy twin %.4f ms x %d '
              '(equal); JAX %s' % (name, e['ms_per_call'], e['calls'],
                                   e['plain_ms_per_call'], e['plain_calls'],
                                   e['jax']))
    print('  RLE1 split of sample5x4 (%d B, %d blocks): native %.4f s, '
          'numpy twin %.4f s'
          % (n_host_bytes, n_host_blocks,
             host_rt['cz_rle1_encode']['ms_per_call'] * n_host_blocks / 1e3,
             host_rt['cz_rle1_encode']['plain_ms_per_call']
             * n_host_blocks / 1e3))
    print('  host runtime: ' + json.dumps({
        'cpu': native.build_info['cpu'], 'march': native.build_info['march'],
        'entries': host_rt}))
    sort_n, sort_ms = check_native_sorts(s5x4)
    print('  native sorts on the first block of sample5x4 (%d B), least of '
          '2 calls, each pair equal: %s'
          % (sort_n, ', '.join('%s %.2f ms' % kv for kv in sort_ms.items())))

    phase('MTF encode kernels vs plain versions')
    rng = np.random.default_rng(1234)
    mtf_real = check_mtf(first_block_bwt(s5, dev))
    mtf_rand = check_mtf(torch.from_numpy(
        rng.integers(0, 256, 899981).astype(np.int32)).to(dev))
    for name, r in (('sample5 block', mtf_real), ('uniform random', mtf_rand)):
        print('  %s: three launches %.4f ms (tiles %.4f, prefix %.4f, '
              'encode %.4f); stage %.4f ms, %d launches a call (%d device '
              'kernels); plain %.3f ms; bound %.5f ms (%s); encode kernel '
              'by chunks %s' % (name, r['ms'], r['tiles_ms'], r['prefix_ms'],
                                r['step_ms'], r['stage_ms'],
                                r['launches_per_call'], r['kernels_per_call'],
                                r['plain_ms'], r['bound_ms'], r['bound_by'],
                                r['occupancy_ms']))

    phase('seg scan kernels vs torch.cummax')
    seg = check_seg_scan(dev)
    for name, r in seg.items():
        print('  %s: kernel %.4f ms (cold L2 %s), wrapper %.4f ms, %d device '
              'kernels a call; bound %.5f ms (%s); plain %.4f ms; '
              'torch.cummax %.4f ms'
              % (name, r['ms'], '%.4f ms' % r['cold_l2_ms']
                 if 'cold_l2_ms' in r else '-', r['wrapper_ms'],
                 r['kernels_per_call'], r['bound_ms'], r['bound_by'],
                 r['plain_ms'], r['library_ms']))
    seg_main = seg['group_start n=899981']

    phase('allocator kernels vs plain versions')
    builds = record_builds(
        lambda: cz.compress_file_device(s5, level=9, device='cuda'))
    n_s5_builds = len(builds)
    builds += adversarial_builds()
    tables = sorted_tables(builds) + [adversarial_tables()]
    alloc = check_alloc(tables, dev)
    print('  cz_alloc_lengths (sorted tables), %d launches of tables: '
          'kernel %.4f ms, wrapper %.4f ms, plain %.3f ms, bound %.6f ms '
          '(%s)' % ((len(tables),) + alloc[1:]))
    build = check_code_lengths(builds, dev)
    print('  cz_code_lengths (whole table build), %d builds (%d from the '
          'sample5 encode): kernel %.4f ms, wrapper %.4f ms, plain %.3f ms, '
          'bound %.6f ms (%s); the build it replaced (torch.sort + '
          'cz_alloc_lengths + its flag read + scatter) %.4f ms'
          % (len(builds), n_s5_builds, build['ms'], build['wrapper_ms'],
             build['plain_ms'], build['bound_ms'], build['bound_by'],
             build['old_build_ms']))
    print('  one-thread latency floor of phase 1 at m = %d: %d dependent '
          'shared-memory steps in %.4f ms (%.2f ns a step)'
          % (build['m'], build['phase1_steps'], build['latency_floor_ms'],
             build['floor_ns_per_step']))
    go_args = record_group_opt_args(
        lambda: cz.compress_file_device(s5x4[:899981], level=9,
                                        device='cuda'))
    from compressjs_tpu_torch.ops import device_entropy as de
    go_new = group_opt_counts(go_args, de.code_lengths_batch, dev)
    go_old = group_opt_counts(go_args, old_table_build, dev)
    for name, c in (('fused build', go_new), ('build it replaced', go_old)):
        print('  group optimisation of sample5x4\'s first block, %s: %d '
              'table builds, %d device launches (%d per build), %d host '
              'syncs (%s), %.3f ms wall'
              % (name, c['builds'], c['launches'], c['launches_per_build'],
                 c['syncs'], c['sync_sources'], c['wall_ms']))

    phase('compose kernel vs plain version')
    from compressjs_tpu_torch.ops.device_huffman import POWER_K_DEFAULT
    walk, dbuf_size = first_block_walk(s5_comp, dev)
    nxt, calls, F, sel, sub = first_block_maps(walk, POWER_K_DEFAULT)
    print('  sample5 first block: maps %s, k = %d, %d compositions, '
          'windows %s' % (tuple(nxt.shape), POWER_K_DEFAULT, len(calls),
                          [c[2:] for c in calls]))
    comp = check_compose(calls, dev)
    n_compose = len(calls)
    print('  mean of the main-path launches: kernel %.4f ms, wrapper '
          '%.4f ms, plain %.3f ms, bound %.5f ms (%s), torch.gather %.4f '
          'ms, kernel with a cold L2 %.4f ms' % comp[1:])

    phase('chase kernel vs plain version')
    rate, st_bytes, st_ms, st_err, st_plain = stage_rate(dev)
    print('  one SM\'s TMA staging rate: %d bytes in %.4f ms = %.1f GB/s'
          % (st_bytes, st_ms, rate / 1e6))
    chases = {}
    for k in sorted({10, POWER_K_DEFAULT}):
        _, _, F_k, sel_k, sub_k = first_block_maps(walk, k)
        c = chases[k] = check_chase(F_k, sel_k, sub_k, dev, rate)
        print('  sample5 first block, k = %d: %d selectors x %d steps: '
              'staged kernel %.4f ms (wrapper %.4f ms) beside the '
              'one-thread L2 chase it replaced %.4f ms; plain %.3f ms; '
              'bound %.6f ms (%s)'
              % (k, sel_k.shape[0], sub_k, c['ms'], c['wrapper_ms'],
                 c['old_ms'], c['plain_ms'], c['bound_ms'], c['bound_by']))
        print('    floors: staged bytes %.4f ms (%d B at one SM\'s rate), '
              'shared-memory chain %.4f ms (%d dependent loads), L2 chain '
              '%.4f ms (%.1f ns a load); window %d positions, %d stages, '
              '%.2f rows staged per position, %d global loads'
              % (c['stream_floor_ms'], c['staged_bytes'],
                 c['smem_floor_ms'], c['steps'], c['l2_floor_ms'],
                 c['l2_ns_per_load'], c['window'], c['stages'],
                 c['rows_per_position'], c['global_loads']))
        del F_k
    chase = chases[POWER_K_DEFAULT]
    del nxt, calls, F
    dec_chase = {'ms': 0.0, 'old_ms': 0.0, 'stream_floor_ms': 0.0,
                 'smem_floor_ms': 0.0, 'staged_bytes': 0, 'steps': 0,
                 'blocks': 0}
    for F_b, sel_b, sub_b in decode_chases(s5x4_comp):
        c = check_chase(F_b, sel_b, sub_b, dev, rate)
        for key in ('ms', 'old_ms', 'stream_floor_ms', 'smem_floor_ms',
                    'staged_bytes', 'steps'):
            dec_chase[key] += c[key]
        dec_chase['blocks'] += 1
        del F_b
    print('  sample5x4 decode, %d chases: staged kernel %.4f ms beside the '
          'old kernel\'s %.4f ms; floors: staged bytes %.4f ms (%d B), '
          'shared-memory chain %.4f ms (%d steps)'
          % (dec_chase['blocks'], dec_chase['ms'], dec_chase['old_ms'],
             dec_chase['stream_floor_ms'], dec_chase['staged_bytes'],
             dec_chase['smem_floor_ms'], dec_chase['steps']))

    phase('walk kernels vs plain versions')
    walk_rows = {}
    for name, w in (('sample5 block 0', walk),
                    ('max caps', max_caps_walk(dev))):
        r = walk_rows[name] = check_walk(w, dev, chase['l2_ns_per_load'])
        print('  %s (cap %d, s_cap %d, %d selectors, G %d): cz_walk_maps '
              'kernel %.4f ms, wrapper %.4f ms, plain %.3f ms, bound %.5f '
              'ms (%s), its arithmetic %.5f ms; cz_chunk_walk kernel %.4f '
              'ms, wrapper %.4f ms, plain %.3f ms, bound %.5f ms (%s), L2 '
              'chain floor %.5f ms'
              % (name, r['cap'], r['s_cap'], r['n_selectors'], r['groups'],
                 r['maps_ms'], r['maps_wrapper_ms'], r['maps_plain_ms'],
                 r['maps_bound_ms'], r['maps_bound_by'],
                 r['maps_alu_floor_ms'], r['walk_ms'], r['walk_wrapper_ms'],
                 r['walk_plain_ms'], r['walk_bound_ms'],
                 r['walk_bound_by'], r['walk_chain_floor_ms']))
        print('    whole walk: kernels %.4f ms on the card, %.4f ms to '
              'issue, %d device kernels; plain stages 1 and 4 %.4f ms, '
              '%.4f ms to issue, %d device kernels'
              % (r['whole_ms'], r['whole_host_ms'], r['whole_kernels'],
                 r['whole_plain_ms'], r['whole_plain_host_ms'],
                 r['whole_plain_kernels']))
    walk_main = walk_rows['max caps']

    phase('MTF-undo kernels vs plain versions')
    idx, total = first_block_mtf_indices(walk, dbuf_size)
    undo_real = check_mtf_undo(idx, dbuf_size)
    rand = np.minimum(rng.zipf(1.3, 899981) - 1, 255).astype(np.int32)
    rand[3::97] = 256
    undo_rand = check_mtf_undo(torch.from_numpy(rand).to(dev), 899977)
    for name, r in (('sample5 block (%d of %d indices in use)'
                     % (total, dbuf_size), undo_real),
                    ('zipf, ragged, planted 256s', undo_rand)):
        print('  %s: three launches %.4f ms (permutations %.4f, prefix '
              '%.4f, decode %.4f); stage %.4f ms, %d launches a call (%d '
              'device kernels); plain %.3f ms; bound %.5f ms (%s); by '
              'chunks: permutations %s, decode %s'
              % (name, r['ms'], r['perm_ms'], r['prefix_ms'], r['decode_ms'],
                 r['stage_ms'], r['launches_per_call'], r['kernels_per_call'],
                 r['plain_ms'], r['bound_ms'], r['bound_by'],
                 r['occupancy_perm_ms'], r['occupancy_ms']))
    for r in (mtf_real, mtf_rand, undo_real, undo_rand):
        if r['launches_per_call'] > 3 or r['kernels_per_call'] > 3:
            raise AssertionError('an MTF stage launched more than 3 '
                                 'kernels: %s' % r)
    del walk, idx

    phase('Fenwick/coder kernels vs plain versions')
    # one dependent shared-memory load, from the chase phase's probe
    smem_ns = chase['smem_floor_ms'] * 1e6 / chase['steps']
    scans = scan_phase(s5, s5x4, dev, smem_ns)

    phase('main path: sample5x4 -9 encode')
    for name in _cuda.launches:
        _cuda.launches[name] = 0
    out = cz.compress_file_device(s5x4, level=9, device='cuda')
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    n_blocks = len(list(split_blocks(np.frombuffer(s5x4, np.uint8),
                                     899981)))
    print('  %d bytes -> %d bytes, %d blocks, launches %s'
          % (len(s5x4), len(out), n_blocks, launches))
    if out != s5x4_comp:
        raise AssertionError('sample5x4 encode differs from the golden')
    if bz2.decompress(out) != s5x4:
        raise AssertionError('sample5x4 encode does not round-trip')
    if launches['mtf_scan'] != 3 * n_blocks or \
            launches['code_lengths'] < n_blocks or \
            launches['seg_scan'] < 2 * n_blocks:
        raise AssertionError('main path skipped a kernel: %s' % launches)

    phase('encode modes')
    # each split and the batched BWT, each on its own counts; 'core'
    # runs the MTF kernel and builds its tables on the host, 'hybrid'
    # runs only the torch sort and BWT on the card
    mode_launches = {'full': launches}
    runs = ENCODE_MODES[1:] + [('hybrid_self_check',
                                {'mode': 'hybrid', 'self_check': True})]
    for name, kw in runs:
        for k in _cuda.launches:
            _cuda.launches[k] = 0
        enc = cz.DeviceBzip2Encoder(9, device='cuda', **kw)
        out = enc.compress(s5x4)
        torch.cuda.synchronize()
        got = mode_launches[name] = dict(_cuda.launches)
        print('  %s: %d bytes -> %d bytes, launches %s'
              % (name, len(s5x4), len(out), got))
        if out != s5x4_comp:
            raise AssertionError('%s encode differs from the golden' % name)
        want_mtf = 3 * n_blocks if kw['mode'] == 'core' else 0
        if got['mtf_scan'] != want_mtf or got['code_lengths'] \
                or got['alloc_lengths']:
            raise AssertionError('%s encode launched %s, not %d mtf_scan '
                                 'and no table build' % (name, got,
                                                         want_mtf))

    phase('main path: sample5x4 -9 decode')
    from compressjs_tpu_torch.host.bzip2_parse import _parse_candidates
    for name in _cuda.launches:
        _cuda.launches[name] = 0
    out = cz.decompress_file_device(s5x4_comp, device='cuda')
    torch.cuda.synchronize()
    dec_launches = dict(_cuda.launches)
    n_dec = len(_parse_candidates(np.frombuffer(s5x4_comp, np.uint8))[2])
    print('  %d bytes -> %d bytes, %d blocks, launches %s'
          % (len(s5x4_comp), len(out), n_dec, dec_launches))
    if out != s5x4:
        raise AssertionError('sample5x4 decode differs from bz2')
    if dec_launches['compose_windowed'] != n_compose * n_dec \
            or dec_launches['selector_chase'] != n_dec \
            or dec_launches['walk_maps'] != n_dec \
            or dec_launches['chunk_walk'] != n_dec \
            or dec_launches['mtf_undo'] != 3 * n_dec:
        raise AssertionError('decode skipped a kernel: %s' % dec_launches)

    phase('more inputs')
    if cz.decompress_file_device(s5_comp, device='cuda') != s5:
        raise AssertionError('sample5 decode differs from bz2')
    out = cz.compress_file_device(s5, level=9, device='cuda')
    if out != s5_comp or bz2.decompress(out) != s5:
        raise AssertionError('sample5 encode differs from the golden')
    for name, data in [
            ('random', rng.integers(0, 256, 900000).astype(
                np.uint8).tobytes()),
            ('periodic', (b'abcabd' * 150000))]:
        out = cz.compress_file_device(data, level=9, device='cuda')
        if bz2.decompress(out) != data:
            raise AssertionError('%s input does not round-trip' % name)
        if cz.decompress_file_device(bz2.compress(data, 9)) != data:
            raise AssertionError('%s input: bz2 stream decodes wrong'
                                 % name)
        print('  %s: %d -> %d bytes, round-trips; its bz2 -9 stream '
              'decodes' % (name, len(data), len(out)))

    phase('false end magic inside a payload')
    # a 3-block level-1 stream whose magic scan also reports an end hit
    # and a block hit 5,000 bits into block 0's payload, as a payload
    # holding those bit patterns would
    from compressjs_tpu_torch.host import bzip2_parse as bp
    data = rng.choice(np.frombuffer(b'abcd', np.uint8), 250000).tobytes()
    c1 = bz2.compress(data, 1)
    scan = bp._scan_magic
    blocks = scan(np.frombuffer(c1, np.uint8), bp.MAGIC_BYTES)
    if len(blocks) != 3:
        raise AssertionError('the stream has %d blocks, not 3' % len(blocks))
    false_hit = np.asarray([int(blocks[0]) + 5000], dtype=np.int64)

    def planted(buf, pattern):
        return np.sort(np.concatenate([scan(buf, pattern), false_hit]))

    bp._scan_magic = planted
    try:
        for name in _cuda.launches:
            _cuda.launches[name] = 0
        out = cz.decompress_file_device(c1, device='cuda')
        torch.cuda.synchronize()
        c1_launches = dict(_cuda.launches)
    finally:
        bp._scan_magic = scan
    print('  %d bytes -> %d bytes, false hits at bit %d, launches %s'
          % (len(c1), len(out), false_hit[0], c1_launches))
    if out != data:
        raise AssertionError('stream with a false end magic decodes wrong')
    if c1_launches['selector_chase'] < 3 or c1_launches['mtf_undo'] < 9 \
            or c1_launches['walk_maps'] < 3 or c1_launches['chunk_walk'] < 3:
        raise AssertionError('false-magic decode skipped a kernel: %s'
                             % c1_launches)

    phase('mesh (NCCL, 1 rank)')
    mesh_launches, new_times, mesh_extra = mesh_phase(
        cz, s5x4, s5x4_comp, launches, dec_launches, extra=[
            ('mesh EOF (NCCL, 1 rank)', lambda m: mesh_eof_phase(m, s5x4)),
            ('CP rotation sort (NCCL, 1 rank)',
             lambda m: cp_sort_phase(m, s5x4)),
            ('mesh BWTC-P (NCCL, 1 rank)',
             lambda m: mesh_bwtcp_phase(cz, m, s5x4))])

    phase('parallel host decode')
    from compressjs_tpu_torch.parallel.decode import block_index
    from compressjs_tpu_torch.host.bzip2 import split_blocks
    for name, stream, want in (('sample5', s5_comp, s5),
                               ('sample5x4', s5x4_comp, s5x4)):
        # the golden's streams hold no false block magic
        starts = block_index(stream)
        n_blocks = len(list(split_blocks(np.frombuffer(want, np.uint8),
                                         899981)))
        if len(starts) != n_blocks or starts[0] != 32:
            raise AssertionError('block_index of %s: %s' % (name, starts))
        out, wall, got = run_counted(cz.decompress_file_parallel, stream)
        if out != want:
            raise AssertionError('decompress_file_parallel of %s differs '
                                 'from bz2' % name)
        print('  %s: %d -> %d bytes in %.3f s, launches %s; block_index '
              'finds its %d blocks' % (name, len(stream), len(out), wall,
                                       got, len(starts)))
    host_dec = check_host_decode(s5x4_comp, s5x4)
    for name, e in host_dec.items():
        print('  %-18s native %.4f ms x %d; numpy twin on the first block '
              '%.4f ms (equal)' % (name, e['ms_per_call'], e['calls'],
                                   e['plain_ms_first_block']))

    phase('hetero')
    het_data, het_ref, het_launches, het_stats = hetero_phase(cz, s5x4)

    phase('EOF BWT (card vs native host)')
    eof_bwt = eof_bwt_phase(s5)

    phase('DeviceBWTCEncoder')
    bwtc = bwtc_phase(cz, s5, s5x4)

    phase('BWTC-P on the card')
    bwtcp = bwtcp_phase(cz, s5x4)

    phase('BWTC-L on the card')
    bwtcl = bwtcl_phase(cz, s5x4)

    phase('reference ties')
    ref_ties = ref_ties_phase(cz, s5x4)

    phase('CLI on the card')
    cli_res, cli_launches = cli_phase(cz, s5, s5_comp, s5x4, s5x4_comp, card)

    phase('timing')
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    t0.record()
    out = cz.compress_file_device(s5x4, level=9, device='cuda')
    t1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    if out != s5x4_comp:
        raise AssertionError('timed sample5x4 encode differs')
    print('  sample5x4 -9 encode: wall %.3f s (%.3f MB/s), CUDA events '
          '%.3f s' % (wall, len(s5x4) / wall / 1e6,
                      t0.elapsed_time(t1) / 1e3))
    mode_times = {}
    for name, kw in ENCODE_MODES:
        wall, pwall, busy, idle = mode_timing(cz, s5x4, s5x4_comp, kw)
        mode_times[name] = {'wall_s': wall, 'mb_s': len(s5x4) / wall / 1e6,
                            'profiled_wall_s': pwall, 'busy_ms': busy,
                            'idle_share': idle}
        print('  sample5x4 -9 encode, %s: wall %.4f s (%.4f MB/s); '
              'profiled %.4f s, card busy %.3f ms, idle share %.4f; %s'
              % (name, wall, len(s5x4) / wall / 1e6, pwall, busy, idle,
                 card))
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    t0.record()
    out = cz.decompress_file_device(s5x4_comp, device='cuda')
    t1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    if out != s5x4:
        raise AssertionError('timed sample5x4 decode differs')
    print('  sample5x4 -9 decode: wall %.3f s (%.3f MB/s of output), CUDA '
          'events %.3f s' % (wall, len(s5x4) / wall / 1e6,
                             t0.elapsed_time(t1) / 1e3))

    # the new paths, one warm call each (the mesh's were timed in its
    # phase, inside its process group)
    host_cpu = native.build_info['cpu']
    out, new_times['decompress_file_parallel'], _ = run_counted(
        cz.decompress_file_parallel, s5x4_comp)
    if out != s5x4:
        raise AssertionError('timed decompress_file_parallel differs')
    out, het_dev_wall, _ = run_counted(cz.compress_file_device, het_data,
                                       level=9, device='cuda')
    if out != het_ref:
        raise AssertionError('timed compress_file_device of the tiled '
                             'input differs')
    out, new_times['hetero_compress_bzip2'], _ = run_counted(
        cz.hetero_compress_bzip2, het_data, level=9, host_workers=2,
        device='cuda')
    if out != het_ref:
        raise AssertionError('timed hetero encode differs')
    het_timed_stats = dict(cz.hetero_compress_bzip2.last_stats)
    for name, wall in new_times.items():
        nbytes = len(het_data) if name.startswith('hetero') else len(s5x4)
        print('  %s: wall %.4f s (%.3f MB/s of uncompressed bytes); %s; '
              'host CPU %s' % (name, wall, nbytes / wall / 1e6, card,
                               host_cpu))
    print('  compress_file_device of the same %d bytes in this call: wall '
          '%.4f s (%.3f MB/s); hetero last_stats %s'
          % (len(het_data), het_dev_wall, len(het_data) / het_dev_wall / 1e6,
             het_timed_stats))
    new_times['compress_file_device_tiled'] = het_dev_wall

    # every path driven with the counts set to 0 just before it: the main
    # encode and decode and the new paths
    path_launches = dict(
        mesh_launches, compress_file_device=launches,
        decompress_file_device=dec_launches,
        hetero_compress_bzip2=het_launches,
        bwtcp_compress_device=bwtcp['launches'],
        bwtcl_compress_device=bwtcl['encode_launches'],
        bwtcl_decompress_device=bwtcl['decode_launches'],
        mesh_compress_bwtcp=mesh_extra['mesh BWTC-P (NCCL, 1 rank)'][
            'launches'], **cli_launches)

    def total(name):
        return sum(p[name] for p in path_launches.values())

    def by_path(name):
        return {k: p[name] for k, p in path_launches.items() if p[name]}

    # the probes are no kernel of any path: their counts, read from the
    # paths' runs, show that none launched one
    def probe_launches(name):
        return total(name)

    kernels = [
        {'name': 'mtf_scan', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/mtf_scan.cu',
         'replaces': 'compressjs_tpu/ops/pallas_kernels.py:51 (with the '
                     'start tables of jax_kernels.py:365)',
         'launches': total('mtf_scan'),
         'launches_by_path': by_path('mtf_scan'),
         'launches_by_mode': {k: v['mtf_scan']
                              for k, v in mode_launches.items()},
         'max_abs_err': max(mtf_real['err'], mtf_rand['err'],
                            mtf_real['lists_err'], mtf_rand['lists_err']),
         # the three launches of one stage, back to back
         'ms': mtf_real['ms'], 'plain_ms': mtf_real['plain_ms'],
         'bound_ms': mtf_real['bound_ms'], 'bound_by': mtf_real['bound_by'],
         'library_ms': None, 'stage_ms': mtf_real['stage_ms'],
         'launches_per_call': mtf_real['launches_per_call'],
         'tiles_ms': mtf_real['tiles_ms'], 'prefix_ms': mtf_real['prefix_ms'],
         'encode_ms': mtf_real['step_ms'],
         'encode_ms_by_chunks': mtf_real['occupancy_ms'],
         'uniform_ms': mtf_rand['ms'], 'uniform_encode_ms': mtf_rand['step_ms'],
         'ptxas': {k: v for k, v in frames.items() if 'undo' not in k}},
        {'name': 'seg_scan', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/seg_scan.cu',
         'replaces': 'none: torch.cummax (the JAX package\'s '
                     'lax.associative_scan, jax_kernels.py _seg_start and '
                     'rle2_encode)',
         'launches': total('seg_scan'),
         'launches_by_path': by_path('seg_scan'),
         'max_abs_err': max(r['err'] for r in seg.values()),
         # cz_group_start at a -9 block: the sorts' call, 1 + rounds a block
         'ms': seg_main['ms'], 'plain_ms': seg_main['plain_ms'],
         'bound_ms': seg_main['bound_ms'], 'bound_by': seg_main['bound_by'],
         'library_ms': seg_main['library_ms'],
         'wrapper_ms': seg_main['wrapper_ms'],
         'cold_l2_ms': seg_main['cold_l2_ms'],
         'kernels_per_call': seg_main['kernels_per_call'], 'rows': seg},
        {'name': 'code_lengths', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/alloc_lengths.cu',
         'replaces': 'compressjs_tpu/ops/device_entropy.py:238 (with the '
                     'sort and scatter of code_lengths_batch :438)',
         'launches': total('code_lengths'),
         'launches_by_path': by_path('code_lengths'),
         'launches_by_mode': {k: v['code_lengths']
                              for k, v in mode_launches.items()},
         'max_abs_err': build['err'], 'ms': build['ms'],
         'plain_ms': build['plain_ms'], 'bound_ms': build['bound_ms'],
         'bound_by': build['bound_by'], 'library_ms': None,
         'wrapper_ms': build['wrapper_ms'],
         'replaced_build_ms': build['old_build_ms'],
         'latency_floor_ms': build['latency_floor_ms'],
         'group_opt_block': {'fused': go_new, 'replaced': go_old}},
        {'name': 'alloc_lengths', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/alloc_lengths.cu',
         'replaces': 'compressjs_tpu/ops/device_entropy.py:238',
         'launches': total('alloc_lengths'), 'main_path': False,
         'max_abs_err': alloc[0], 'ms': alloc[1], 'plain_ms': alloc[3],
         'bound_ms': alloc[4], 'bound_by': alloc[5], 'library_ms': None,
         'wrapper_ms': alloc[2]},
        {'name': 'compose_windowed', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/compose_windowed.cu',
         'replaces': 'compressjs_tpu/ops/pallas_compose.py:61',
         'launches': total('compose_windowed'),
         'launches_by_path': by_path('compose_windowed'),
         'max_abs_err': comp[0], 'ms': comp[1], 'plain_ms': comp[3],
         'bound_ms': comp[4], 'bound_by': comp[5], 'library_ms': comp[6],
         'cold_l2_ms': comp[7]},
        {'name': 'selector_chase', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/selector_chase.cu',
         'replaces': 'compressjs_tpu/ops/device_huffman.py:291 (lax.scan, '
                     'no TPU kernel)',
         'launches': total('selector_chase'),
         'launches_by_path': by_path('selector_chase'),
         'max_abs_err': max(c['err'] for c in chases.values()),
         'ms': chase['ms'], 'plain_ms': chase['plain_ms'],
         'bound_ms': chase['bound_ms'], 'bound_by': chase['bound_by'],
         'library_ms': None, 'wrapper_ms': chase['wrapper_ms'],
         'power_k': POWER_K_DEFAULT,
         # a chain of dependent loads fed by staged windows: its floors
         'stream_floor_ms': chase['stream_floor_ms'],
         'smem_chain_floor_ms': chase['smem_floor_ms'],
         'staged_bytes': chase['staged_bytes'],
         'window': chase['window'], 'stages': chase['stages'],
         'rows_per_position': chase['rows_per_position'],
         'global_loads': chase['global_loads'],
         'replaced_kernel_ms': chase['old_ms'],
         'k10_ms': chases[10]['ms'], 'k10_replaced_ms': chases[10]['old_ms'],
         's5x4_decode_ms': dec_chase['ms'],
         's5x4_decode_replaced_ms': dec_chase['old_ms']},
        {'name': 'walk_maps', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/huffman_walk.cu',
         'replaces': 'compressjs_tpu/ops/device_huffman.py:61 and :85 '
                     '(_window_vals, _group_lengths; no TPU kernel)',
         'launches': total('walk_maps'),
         'launches_by_path': by_path('walk_maps'),
         'max_abs_err': max(r['maps_err'] for r in walk_rows.values()),
         'ms': walk_main['maps_ms'], 'plain_ms': walk_main['maps_plain_ms'],
         'bound_ms': walk_main['maps_bound_ms'],
         'bound_by': walk_main['maps_bound_by'], 'library_ms': None,
         'wrapper_ms': walk_main['maps_wrapper_ms'],
         'alu_floor_ms': walk_main['maps_alu_floor_ms'],
         'shape': [walk_main['groups'], walk_main['cap']],
         'sample5_ms': walk_rows['sample5 block 0']['maps_ms']},
        {'name': 'chunk_walk', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/huffman_walk.cu',
         'replaces': 'compressjs_tpu/ops/device_huffman.py:313-329 '
                     '(lax.scan, no TPU kernel)',
         'launches': total('chunk_walk'),
         'launches_by_path': by_path('chunk_walk'),
         'max_abs_err': max(r['walk_err'] for r in walk_rows.values()),
         'ms': walk_main['walk_ms'], 'plain_ms': walk_main['walk_plain_ms'],
         'bound_ms': walk_main['walk_bound_ms'],
         'bound_by': walk_main['walk_bound_by'], 'library_ms': None,
         'wrapper_ms': walk_main['walk_wrapper_ms'],
         'chain_floor_ms': walk_main['walk_chain_floor_ms'],
         'shape': [walk_main['s_cap'], 50],
         'sample5_ms': walk_rows['sample5 block 0']['walk_ms'],
         'whole_walk': walk_rows},
        {'name': 'chase_probe', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/probes.cu',
         'replaces': 'compressjs_tpu/ops/device_huffman.py:291 (lax.scan, '
                     'no TPU kernel); the chase kernel before it was staged',
         'launches': probe_launches('chase_probe'), 'main_path': False,
         'max_abs_err': chase['old_err'], 'ms': chase['old_ms'],
         'plain_ms': chase['plain_ms'], 'bound_ms': chase['bound_ms'],
         'bound_by': chase['bound_by'], 'library_ms': None,
         # over a random cycle of F's size in L2: one load's latency
         'l2_latency_floor_ms': chase['l2_floor_ms'],
         'ns_per_dependent_load': chase['l2_ns_per_load']},
        {'name': 'smem_chain_probe', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/probes.cu',
         'replaces': 'none (a latency probe)',
         'launches': probe_launches('smem_chain_probe'), 'main_path': False,
         'max_abs_err': max(c['smem_err'] for c in chases.values()),
         'ms': chase['smem_floor_ms'], 'plain_ms': chase['smem_plain_ms'],
         'bound_ms': bound(4 * 4096 + 4, chase['steps'])[0],
         'bound_by': bound(4 * 4096 + 4, chase['steps'])[1],
         'library_ms': None, 'steps': chase['steps']},
        {'name': 'stage_probe', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/selector_chase.cu',
         'replaces': 'none (a staging-rate probe)',
         'launches': probe_launches('stage_probe'), 'main_path': False,
         'max_abs_err': st_err, 'ms': st_ms,
         'plain_ms': st_plain, 'bound_ms': bound(st_bytes, 0)[0],
         'bound_by': 'bytes', 'library_ms': None,
         'bytes_per_s': rate * 1e3},
        {'name': 'mtf_undo', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/mtf_undo.cu',
         'replaces': 'compressjs_tpu/ops/jax_kernels.py:617 (lax.scan, '
                     'no TPU kernel)',
         'launches': total('mtf_undo'),
         'launches_by_path': by_path('mtf_undo'),
         'max_abs_err': max(undo_real['err'], undo_rand['err'],
                            undo_real['lists_err'], undo_rand['lists_err']),
         # the three launches of one stage, back to back
         'ms': undo_real['ms'], 'plain_ms': undo_real['plain_ms'],
         'bound_ms': undo_real['bound_ms'], 'bound_by': undo_real['bound_by'],
         'library_ms': None, 'stage_ms': undo_real['stage_ms'],
         'launches_per_call': undo_real['launches_per_call'],
         'perm_ms': undo_real['perm_ms'], 'prefix_ms': undo_real['prefix_ms'],
         'decode_ms': undo_real['decode_ms'],
         'decode_ms_by_chunks': undo_real['occupancy_ms'],
         'perm_ms_by_chunks': undo_real['occupancy_perm_ms'],
         'zipf_ms': undo_rand['ms'],
         'ptxas': {k: v for k, v in frames.items() if 'undo' in k}},
    ]
    # the scan kernels: times, plain times and bounds at BWTC-L's 128
    # lanes of sample5's first -9 block (every step through the plain
    # versions too), and the kernels alone on its whole BWTC-P lane and on
    # the 8-lane dispatch of sample5x4 (the decode's from fresh coder
    # states); the two unfused encode kernels are on no path since the
    # fused entry took their place
    checked = [scans[k] for k in ('bwtcl_lanes', 'bwtcp_lane_4096',
                                  'random_0x400')]
    lanes_l, lane_p = scans['bwtcl_lanes'], scans['bwtcp_lane_full']
    disp = scans['bwtcp_dispatch_8']
    encode_src = 'compressjs_tpu_torch/csrc/fenwick_encode.cu'
    for name, key, source, replaces in (
            ('fenwick_code', 'code', encode_src,
             'compressjs_tpu/ops/device_model.py:211 with '
             'device_coder.py:63 (lax.scans :276 and :108, no TPU kernel)'),
            ('fenwick_encode', 'encode', encode_src,
             'compressjs_tpu/ops/device_model.py:211 (lax.scan :276, no '
             'TPU kernel)'),
            ('range_encode', 'coder', encode_src,
             'compressjs_tpu/ops/device_coder.py:63 (lax.scan :108, no TPU '
             'kernel)'),
            ('fenwick_decode', 'decode',
             'compressjs_tpu_torch/csrc/fenwick_decode.cu',
             'compressjs_tpu/ops/device_model.py:118 (lax.scan :206, with '
             'device_coder.py:142-195; no TPU kernel)')):
        entry = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'launches': total(name),
            'launches_by_path': by_path(name),
            'max_abs_err': max(r[key + '_err'] for r in checked),
            'ms': lanes_l[key + '_ms'], 'plain_ms': lanes_l[key + '_plain_ms'],
            'bound_ms': lanes_l[key + '_bound_ms'],
            'bound_by': lanes_l[key + '_bound_by'], 'library_ms': None,
            'wrapper_ms': lanes_l[key + '_wrapper_ms'],
            'chain_floor_ms': lanes_l[key + '_chain_floor_ms'],
            'bwtcp_lane_ms': lane_p[key + '_ms'],
            'bwtcp_lane_wrapper_ms': lane_p[key + '_wrapper_ms'],
            'bwtcp_lane_bound_ms': lane_p[key + '_bound_ms'],
            'bwtcp_lane_chain_floor_ms': lane_p[key + '_chain_floor_ms'],
            'bwtcp_lane_4096_ms': scans['bwtcp_lane_4096'][key + '_ms'],
            'random_0x400_ms': scans['random_0x400'][key + '_ms']}
        d = scans['bwtcp_dispatch_8_fresh'] if key == 'decode' else disp
        entry.update(
            bwtcp_dispatch_8_ms=d[key + '_ms'],
            bwtcp_dispatch_8_wrapper_ms=d[key + '_wrapper_ms'],
            bwtcp_dispatch_8_bound_ms=d[key + '_bound_ms'],
            bwtcp_dispatch_8_chain_floor_ms=d[key + '_chain_floor_ms'])
        if key == 'decode':
            entry.update(
                levels_per_round=lanes_l['decode_levels_per_round'],
                round_floor_ms=lanes_l['decode_round_floor_ms'],
                bwtcp_lane_round_floor_ms=lane_p['decode_round_floor_ms'],
                bwtcp_dispatch_8_round_floor_ms=d['decode_round_floor_ms'])
        if key == 'code':
            entry.update(
                max_abs_err_vs_series=max(
                    r['code_vs_series_err'] for r in scans.values()
                    if isinstance(r, dict)),
                level_chain_floor_ms=lanes_l['code_level_chain_floor_ms'],
                bwtcp_lane_level_chain_floor_ms=lane_p[
                    'code_level_chain_floor_ms'])
        if key in ('encode', 'coder'):
            entry['main_path'] = False
        kernels.append(entry)
    print('encode modes: ' + json.dumps(mode_times))
    print('new paths: ' + json.dumps({
        'wall_s': new_times, 'hetero_last_stats': het_timed_stats,
        'hetero_check_stats': het_stats, 'host_decode': host_dec,
        'host_cpu': host_cpu}))
    print('BWTC paths: ' + json.dumps({
        'eof_bwt_per_block': eof_bwt, 'device_bwtc_encoder': bwtc,
        'mesh_eof': mesh_extra['mesh EOF (NCCL, 1 rank)'],
        'cp_sort': mesh_extra['CP rotation sort (NCCL, 1 rank)'],
        'ref_ties_bytes': ref_ties, 'card': card, 'host_cpu': host_cpu}))
    print('BWTC-P/L paths: ' + json.dumps({
        'scan_kernels': scans, 'bwtcp_compress_device': bwtcp,
        'bwtcl': bwtcl,
        'mesh_compress_bwtcp': mesh_extra['mesh BWTC-P (NCCL, 1 rank)'],
        'card': card, 'host_cpu': host_cpu}))
    print('CLI paths: ' + json.dumps({'calls': cli_res, 'card': card,
                                      'host_cpu': host_cpu}))
    print('smoke total %.1f s' % (time.perf_counter() - t_start))
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
