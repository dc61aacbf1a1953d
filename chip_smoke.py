#!/usr/bin/env python3
"""Smoke test of compressjs_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``compressjs_tpu_torch/csrc``, holds each
kernel equal to its plain version on the card at main-path shapes (MTF
scan, Huffman allocator, windowed compose, the selector chase at k = 10
and at the default k, MTF undo), re-encodes the in-repo bzip2 goldens at
-9 through ``compress_file_device`` and decodes them through
``decompress_file_device``, decodes a stream whose magic scan reports a
false end magic inside a payload, checks the bytes, times the encode,
the decode and each kernel, and prints:

* the card's name and power limit, as nvidia-smi reports them;
* one JSON line ``{"kernels": [...]}`` with each kernel's launches on
  the main-path run, error against its plain version, times and bound;
* last, ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero.  Without a CUDA
card it exits non-zero before printing any result.
"""

import bz2
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, 'tests', 'golden')

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor
# vector rate, used for the kernels' 32-bit integer operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


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
    from compressjs_tpu_torch.parallel.pipeline import _block_meta
    block, _ = rle1_encode(np.frombuffer(data, np.uint8), 0, 899981)
    _, _, remap = _block_meta(block)
    U, _ = bwt_block(torch.from_numpy(block).to(dev), block.shape[0])
    return torch.from_numpy(remap).to(dev)[U.long()].to(torch.int32)


def check_mtf(dense, width):
    """Kernel vs plain on one input; returns (max_abs_err, kernel ms,
    wrapper ms, plain ms, bound ms, bound_by)."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops.block_kernels import (
        _chunk_start_positions, _pad_chunks, mtf_scan, mtf_scan_plain)
    n = dense.shape[0]
    starts = _chunk_start_positions(_pad_chunks(dense, n), width)
    got = mtf_scan(dense, starts)
    want = mtf_scan_plain(dense, starts)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError('MTF kernel differs from its plain version '
                             '(width %d): max abs err %d' % (width, err))
    lib = _cuda.lib()
    out = torch.empty_like(dense)
    stream = _cuda.stream_handle(dense.device)

    def launch():  # the kernel alone, outside the wrapper
        _cuda.check(lib.cz_mtf_scan(dense.data_ptr(), starts.data_ptr(),
                                    out.data_ptr(), n, starts.shape[0],
                                    width, stream), 'mtf_scan')

    ms = cuda_ms(launch, 20)
    if not torch.equal(out, got):
        raise AssertionError('timed MTF launches differ')
    wrapper = cuda_ms(lambda: mtf_scan(dense, starts), 20)
    plain = cuda_ms(lambda: mtf_scan_plain(dense, starts), 2)
    # what these inputs need: per symbol a table lookup and a clear, plus
    # one bump for each of the j = code entries that sit in front of it
    b = bound(4 * n * 2 + 4 * starts.numel(),
              2 * n + int(want.long().sum()))
    return err, ms, wrapper, plain, b[0], b[1]


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
    """Kernel vs plain on every table; returns (max_abs_err, kernel ms,
    wrapper ms, plain ms, bound ms, bound_by) at the main path's B=6
    shape."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import device_entropy as de
    err = 0
    for arrs, ms in tables:
        arrs = arrs.to(dev).contiguous()
        ms = ms.to(dev).contiguous()
        got = de.alloc_lengths(arrs, ms)
        want = de.alloc_lengths_plain(arrs, ms)
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
            out, de.alloc_lengths_plain(arrs, ms)):
        raise AssertionError('timed allocator launches differ')
    wrapper = cuda_ms(lambda: de.alloc_lengths(arrs, ms), 50)
    plain = cuda_ms(lambda: de.alloc_lengths_plain(arrs, ms), 5)
    # phase 1 dominates: ~16 integer operations per table slot
    b = bound(4 * (2 * arrs.numel() + 2 * ms.numel()),
              16 * int(ms.sum()))
    return err, ms_k, wrapper, plain, b[0], b[1]


def record_tables(fn):
    """Run fn() and return every (arrs, ms) the allocator was given."""
    from compressjs_tpu_torch.ops import device_entropy as de
    seen = []
    orig = de.alloc_lengths

    def recorder(arrs, ms):
        seen.append((arrs.clone(), ms.clone()))
        return orig(arrs, ms)

    de.alloc_lengths = recorder
    try:
        fn()
    finally:
        de.alloc_lengths = orig
    return seen


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
    """Kernel vs plain on one input; returns (max_abs_err, kernel ms of
    both launches, of the permutation launch, of the decode launch,
    wrapper ms, plain ms, bound ms, bound_by)."""
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import block_decode as bd
    got = bd.mtf_decode(idx, n)
    want = bd.mtf_decode_plain(idx, n)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError('MTF-undo kernel differs from its plain '
                             'version (n %d): max abs err %d' % (n, err))
    lib = _cuda.lib()
    stream = _cuda.stream_handle(idx.device)
    n_chunks = -(-n // bd.CHUNK_LEN)
    perm = torch.empty((n_chunks, bd.WIDTH), dtype=torch.uint8,
                       device=idx.device)
    out = torch.empty(n, dtype=torch.int32, device=idx.device)

    def launch_perm():  # the kernels alone, outside the wrapper
        _cuda.check(lib.cz_mtf_undo_perm(idx.data_ptr(), perm.data_ptr(),
                                         n, n_chunks, stream), 'mtf_undo')

    launch_perm()
    lists = bd._start_lists(perm)

    def launch_decode():
        _cuda.check(lib.cz_mtf_undo_decode(
            idx.data_ptr(), lists.data_ptr(), out.data_ptr(), n, n_chunks,
            stream), 'mtf_undo')

    def launch_both():
        launch_perm()
        launch_decode()

    ms = cuda_ms(launch_both, 20)
    if not torch.equal(out, got):
        raise AssertionError('timed MTF-undo launches differ')
    perm_ms = cuda_ms(launch_perm, 20)
    decode_ms = cuda_ms(launch_decode, 20)
    wrapper = cuda_ms(lambda: bd.mtf_decode(idx, n), 20)
    plain = cuda_ms(lambda: bd.mtf_decode_plain(idx, n), 1)
    # the function's traffic: int32 indices read once, int32 values
    # written once (the permutations and start lists between the two
    # launches belong to this split, not to the function); per index and
    # launch a lookup and a front write, and one move per position in
    # front of it
    front = int(idx[:n].long().clamp(0, bd.WIDTH).sum())
    b = bound(8 * n, 2 * (2 * n + front))
    return err, ms, perm_ms, decode_ms, wrapper, plain, b[0], b[1]


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


def check_chase(F, sel, sub, dev):
    """Kernel vs plain on the main-path chase; returns (max_abs_err,
    kernel ms, wrapper ms, plain ms, bound ms, bound_by, latency bound
    ms, ns per dependent load)."""
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
    G, cap = F.shape

    def launch():  # the kernel alone, outside the wrapper
        _cuda.check(lib.cz_selector_chase(
            F.data_ptr(), sel.data_ptr(), out.data_ptr(), G, cap,
            sel.shape[0], sub, stream), 'selector_chase')

    ms = cuda_ms(launch, 5)
    if not torch.equal(out, want):
        raise AssertionError('timed chase launches differ')
    wrapper = cuda_ms(lambda: dh.selector_chase(F, sel, sub), 5)
    plain = cuda_ms(lambda: dh.selector_chase_plain(F, sel, sub), 1)
    # the entries of F the chain reads, the selectors, the starts; a
    # multiply-add, two compares per step
    steps = sel.shape[0] * sub
    b_ms, b_by = bound(4 * (steps + 2 * sel.shape[0]), 4 * steps)
    # what bounds the chain is the latency of its dependent loads: time
    # one thread's pointer chase at the same step count over an array of
    # F's size, a random single cycle held in L2 (the same kernel with
    # one row and every selector 0, so each step is p <- ring[p])
    n = G * cap
    order = np.random.default_rng(7).permutation(n)
    ring = np.empty(n, dtype=np.int32)
    ring[order] = np.roll(order, -1)
    ring = torch.from_numpy(ring).to(dev)
    zeros = torch.zeros_like(sel)
    probe = torch.empty_like(sel)

    def chase_ring():
        _cuda.check(lib.cz_selector_chase(
            ring.data_ptr(), zeros.data_ptr(), probe.data_ptr(), 1, n,
            sel.shape[0], sub, stream), 'selector_chase')

    ring.sum()  # pull the ring into L2
    lat_ms = cuda_ms(chase_ring, 5)
    if not torch.equal(probe, dh.selector_chase_plain(ring.view(1, n),
                                                      zeros, sub)):
        raise AssertionError('latency probe differs from its plain chase')
    return err, ms, wrapper, plain, b_ms, b_by, lat_ms, \
        lat_ms * 1e6 / steps


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
    from compressjs_tpu_torch.parallel.pipeline import _split_blocks
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

    s5_comp, s5 = golden('sample5_bzip2_9.bz2')
    s5x4_comp, s5x4 = golden('sample5x4_bzip2_9.bz2')

    phase('MTF kernel vs plain version')
    rng = np.random.default_rng(1234)
    mtf_real = check_mtf(first_block_bwt(s5, dev), 256)
    mtf_rand = check_mtf(torch.from_numpy(
        rng.integers(0, 256, 899981).astype(np.int32)).to(dev), 256)
    print('  sample5 block: kernel %.4f ms, wrapper %.4f ms, plain %.3f ms, '
          'bound %.5f ms (%s)' % mtf_real[1:])
    print('  random block:  kernel %.4f ms, wrapper %.4f ms, plain %.3f ms, '
          'bound %.5f ms (%s)' % mtf_rand[1:])

    phase('allocator kernel vs plain version')
    tables = record_tables(
        lambda: cz.compress_file_device(s5, level=9, device='cuda'))
    tables.append(adversarial_tables())
    alloc = check_alloc(tables, dev)
    print('  %d launches of tables: kernel %.4f ms, wrapper %.4f ms, '
          'plain %.3f ms, bound %.6f ms (%s)' % ((len(tables),) + alloc[1:]))

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
    chases = {}
    for k in sorted({10, POWER_K_DEFAULT}):
        _, _, F_k, sel_k, sub_k = first_block_maps(walk, k)
        chases[k] = check_chase(F_k, sel_k, sub_k, dev)
        print('  k = %d: %d selectors x %d steps = %d steps: kernel %.4f '
              'ms, wrapper %.4f ms, plain %.3f ms, bound %.6f ms (%s); '
              'one-thread chase of a random ring of F\'s size at the same '
              'steps %.4f ms (%.1f ns per dependent load)'
              % ((k, sel_k.shape[0], sub_k, sel_k.shape[0] * sub_k)
                 + chases[k][1:]))
        del F_k
    chase = chases[POWER_K_DEFAULT]
    del nxt, calls, F

    phase('MTF-undo kernel vs plain version')
    idx, total = first_block_mtf_indices(walk, dbuf_size)
    undo_real = check_mtf_undo(idx, dbuf_size)
    rand = np.minimum(rng.zipf(1.3, 899981) - 1, 255).astype(np.int32)
    rand[3::97] = 256
    undo_rand = check_mtf_undo(torch.from_numpy(rand).to(dev), 899977)
    print('  sample5 block (%d of %d indices in use): kernel %.4f ms '
          '(permutations %.4f, decode %.4f), wrapper %.4f ms, plain %.3f '
          'ms, bound %.5f ms (%s)' % ((total, dbuf_size) + undo_real[1:]))
    print('  random, ragged, planted 256s: kernel %.4f ms (permutations '
          '%.4f, decode %.4f), wrapper %.4f ms, plain %.3f ms, bound %.5f '
          'ms (%s)' % undo_rand[1:])
    del walk, idx

    phase('main path: sample5x4 -9 encode')
    for name in _cuda.launches:
        _cuda.launches[name] = 0
    out = cz.compress_file_device(s5x4, level=9, device='cuda')
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    n_blocks = len(_split_blocks(np.frombuffer(s5x4, np.uint8), 899981))
    print('  %d bytes -> %d bytes, %d blocks, launches %s'
          % (len(s5x4), len(out), n_blocks, launches))
    if out != s5x4_comp:
        raise AssertionError('sample5x4 encode differs from the golden')
    if bz2.decompress(out) != s5x4:
        raise AssertionError('sample5x4 encode does not round-trip')
    if launches['mtf_scan'] != n_blocks or \
            launches['alloc_lengths'] < n_blocks:
        raise AssertionError('main path skipped a kernel: %s' % launches)

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
            or dec_launches['mtf_undo'] != 2 * n_dec:
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
    if c1_launches['selector_chase'] < 3 or c1_launches['mtf_undo'] < 6:
        raise AssertionError('false-magic decode skipped a kernel: %s'
                             % c1_launches)

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

    kernels = [
        {'name': 'mtf_scan', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/mtf_scan.cu',
         'replaces': 'compressjs_tpu/ops/pallas_kernels.py:51',
         'launches': launches['mtf_scan'],
         'max_abs_err': max(mtf_real[0], mtf_rand[0]),
         'ms': mtf_real[1], 'plain_ms': mtf_real[3],
         'bound_ms': mtf_real[4], 'bound_by': mtf_real[5],
         'library_ms': None},
        {'name': 'alloc_lengths', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/alloc_lengths.cu',
         'replaces': 'compressjs_tpu/ops/device_entropy.py:238',
         'launches': launches['alloc_lengths'],
         'max_abs_err': alloc[0], 'ms': alloc[1], 'plain_ms': alloc[3],
         'bound_ms': alloc[4], 'bound_by': alloc[5], 'library_ms': None},
        {'name': 'compose_windowed', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/compose_windowed.cu',
         'replaces': 'compressjs_tpu/ops/pallas_compose.py:61',
         'launches': dec_launches['compose_windowed'],
         'max_abs_err': comp[0], 'ms': comp[1], 'plain_ms': comp[3],
         'bound_ms': comp[4], 'bound_by': comp[5], 'library_ms': comp[6],
         'cold_l2_ms': comp[7]},
        {'name': 'selector_chase', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/selector_chase.cu',
         'replaces': 'compressjs_tpu/ops/device_huffman.py:291 (lax.scan, '
                     'no TPU kernel)',
         'launches': dec_launches['selector_chase'],
         'max_abs_err': max(c[0] for c in chases.values()),
         'ms': chase[1], 'plain_ms': chase[3],
         'bound_ms': chase[4], 'bound_by': chase[5], 'library_ms': None,
         # a chain of dependent loads: its floor is their latency
         'latency_bound_ms': chase[6], 'ns_per_dependent_load': chase[7],
         'power_k': POWER_K_DEFAULT, 'k10_ms': chases[10][1],
         'k10_latency_bound_ms': chases[10][6]},
        {'name': 'mtf_undo', 'route': 'cuda',
         'source': 'compressjs_tpu_torch/csrc/mtf_undo.cu',
         'replaces': 'compressjs_tpu/ops/jax_kernels.py:617 (lax.scan, '
                     'no TPU kernel)',
         'launches': dec_launches['mtf_undo'],
         'max_abs_err': max(undo_real[0], undo_rand[0]),
         # both launches of one call (permutations, then decode)
         'ms': undo_real[1], 'plain_ms': undo_real[5],
         'bound_ms': undo_real[6], 'bound_by': undo_real[7],
         'library_ms': None, 'perm_ms': undo_real[2],
         'decode_ms': undo_real[3], 'wrapper_ms': undo_real[4]},
    ]
    print('smoke total %.1f s' % (time.perf_counter() - t_start))
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
