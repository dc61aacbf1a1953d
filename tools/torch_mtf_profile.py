#!/usr/bin/env python3
"""The MTF stages of compressjs_tpu_torch on one CUDA card.

    python3 tools/torch_mtf_profile.py [--root DIR] [--label NAME]
                                       [--out PATH] [--sass PATH] [--phases]

--root names the tree whose package is loaded (default: this checkout),
so that one call can measure two trees in turns; the tree's own
``_cuda`` builds its kernels.  Inputs, made on the card: the dense BWT
of sample5's first -9 block (the encode's MTF input, 899,981 symbols)
and its MTF indices padded with zeros to the block capacity of 900,000
(the decode's MTF-undo input, as the walk hands it over), and the random
inputs of chip_smoke.py (uniform symbols; zipf(1.3) indices with a
planted 256 every 97th).  Prints:

* the ptxas lines (registers, stack frame) of the MTF kernels;
* each MTF kernel's time through its C entry point on the first 1, 4,
  16, 132, 528 and all 1,758 chunks of sample5's block.  The kernels of
  before the redesign run 4 chunks (warps) a block, so up to 528 chunks
  put at most 4 warps on an SM and all of them 13-16; the redesigned ones
  run 16 a block, so 1, 4 and 16 chunks put 1, 4 and 16 warps on one SM.
  A time that grows with the warps per SM is set by the issue rate, a
  flat one by the chain of dependent steps;
* each kernel's time at full size on the random inputs;
* the whole encode and decode MTF stages (``mtf_encode``,
  ``mtf_decode``, start lists included): device ms per call between CUDA
  events over 20 calls, wall ms per synchronised call, and the device
  kernels one call launches (``torch.profiler``);
* the SM clock that ``nvidia-smi`` reads while the decode kernel runs.

Every output is checked against the plain version once.  Prints one
JSON object last, with the card's name and power limit, and also writes
it to --out when given; --sass writes the MTF kernels' SASS
(``cuobjdump``).  --phases (redesigned tree only) also builds the kernels
with CZ_MTF_PROFILE=1 and prints each launch's cycles per chunk by phase
(mean, the slowest chunk's), and the cycles per step of each pass.
"""

import argparse
import bz2
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = 899981
CAP = 900000
CHUNK = 512   # the MTF chunk length of both directions, in every tree


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps):
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


def wall_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def kernels_per_call(fn):
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


def sm_clock_while(fn, seconds=1.0):
    """SM clocks (MHz) that nvidia-smi reads while fn() runs back to
    back for about `seconds`."""
    p = subprocess.Popen(['nvidia-smi', '--query-gpu=clocks.sm',
                          '--format=csv,noheader,nounits', '-lms', '100'],
                         stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        p.terminate()
        out, _ = p.communicate()
    return [int(x) for x in out.split() if x.strip().isdigit()]


def sample5_inputs(dev):
    """(dense BWT of sample5's first block, int32 on dev)."""
    from compressjs_tpu_torch.host.rle1 import rle1_encode
    from compressjs_tpu_torch.ops.block_kernels import bwt_block
    from compressjs_tpu_torch.host.bzip2 import block_meta
    with open(os.path.join(HERE, 'tests', 'golden', 'sample5_bzip2_9.bz2'),
              'rb') as f:
        data = bz2.decompress(f.read())
    block, _ = rle1_encode(np.frombuffer(data, np.uint8), 0, BLOCK)
    _, _, remap = block_meta(block)
    U, _ = bwt_block(torch.from_numpy(block).to(dev), block.shape[0])
    return torch.from_numpy(remap).to(dev)[U.long()].to(torch.int32)


class Old:
    """The MTF entry points before the redesign: cz_mtf_scan from start
    position tables; cz_mtf_undo_perm and cz_mtf_undo_decode with the
    composition scan between them."""

    def __init__(self, lib, bk, bd):
        self.lib, self.bk, self.bd = lib, bk, bd

    def encode_launches(self, dense):
        bk, lib = self.bk, self.lib
        n = dense.shape[0]
        starts = bk._chunk_start_positions(bk._pad_chunks(dense, n), 256)
        out = torch.empty_like(dense)

        def step(c):
            m = min(c * CHUNK, n)
            return lambda: lib.cz_mtf_scan(
                dense.data_ptr(), starts.data_ptr(), out.data_ptr(), m, c,
                256, self.stream)
        return {'step': step}, out

    def decode_launches(self, idx, n):
        bd, lib = self.bd, self.lib
        chunks = -(-n // CHUNK)
        perm = torch.empty((chunks, 256), dtype=torch.uint8,
                           device=idx.device)
        lib.cz_mtf_undo_perm(idx.data_ptr(), perm.data_ptr(), n, chunks,
                             self.stream)
        lists = bd._start_lists(perm)
        out = torch.empty(n, dtype=torch.int32, device=idx.device)

        def perm_k(c):
            m = min(c * CHUNK, n)
            return lambda: lib.cz_mtf_undo_perm(
                idx.data_ptr(), perm.data_ptr(), m, c, self.stream)

        def dec_k(c):
            m = min(c * CHUNK, n)
            return lambda: lib.cz_mtf_undo_decode(
                idx.data_ptr(), lists.data_ptr(), out.data_ptr(), m, c,
                self.stream)
        return {'perm': perm_k, 'step': dec_k}, out


class New:
    """The redesigned entry points: three launches a direction, the
    start lists built by the first two."""

    def __init__(self, lib, bk, bd):
        self.lib, self.bk, self.bd = lib, bk, bd

    def encode_launches(self, dense):
        lib, bk = self.lib, self.bk
        n = dense.shape[0]
        chunks = -(-n // CHUNK)
        tiles = -(-chunks // bk.TILE_CHUNKS)
        agg = torch.empty((tiles, 256), dtype=torch.int32,
                          device=dense.device)
        pre = torch.empty_like(agg)
        out = torch.empty_like(dense)
        lib.cz_mtf_encode_tiles(dense.data_ptr(), agg.data_ptr(), n, chunks,
                                self.stream)
        lib.cz_mtf_encode_prefix(agg.data_ptr(), pre.data_ptr(), tiles,
                                 self.stream)

        def tiles_k(c):
            m = min(c * CHUNK, n)
            return lambda: lib.cz_mtf_encode_tiles(
                dense.data_ptr(), agg.data_ptr(), m, c, self.stream)

        def prefix_k(c):
            t = -(-c // bk.TILE_CHUNKS)
            return lambda: lib.cz_mtf_encode_prefix(
                agg.data_ptr(), pre.data_ptr(), t, self.stream)

        def step(c):
            m = min(c * CHUNK, n)
            return lambda: lib.cz_mtf_encode(
                dense.data_ptr(), pre.data_ptr(), out.data_ptr(), m, c,
                self.stream)
        return {'tiles': tiles_k, 'prefix': prefix_k, 'step': step}, out

    def decode_launches(self, idx, n):
        lib, bd = self.lib, self.bd
        chunks = -(-n // CHUNK)
        tiles = -(-chunks // bd.TILE_CHUNKS)
        perm = torch.empty((chunks, 256), dtype=torch.uint8,
                           device=idx.device)
        agg = torch.empty((tiles, 256), dtype=torch.uint8, device=idx.device)
        tl = torch.empty_like(agg)
        out = torch.empty(n, dtype=torch.int32, device=idx.device)
        lib.cz_mtf_undo_perm(idx.data_ptr(), perm.data_ptr(), agg.data_ptr(),
                             n, chunks, self.stream)
        lib.cz_mtf_undo_prefix(agg.data_ptr(), tl.data_ptr(), tiles,
                               self.stream)

        def perm_k(c):
            m = min(c * CHUNK, n)
            return lambda: lib.cz_mtf_undo_perm(
                idx.data_ptr(), perm.data_ptr(), agg.data_ptr(), m, c,
                self.stream)

        def prefix_k(c):
            t = -(-c // bd.TILE_CHUNKS)
            return lambda: lib.cz_mtf_undo_prefix(
                agg.data_ptr(), tl.data_ptr(), t, self.stream)

        def dec_k(c):
            m = min(c * CHUNK, n)
            return lambda: lib.cz_mtf_undo_decode(
                idx.data_ptr(), perm.data_ptr(), tl.data_ptr(),
                out.data_ptr(), m, c, self.stream)
        return {'perm': perm_k, 'prefix': prefix_k, 'step': dec_k}, out


ENCODE_PHASES = ('load+stage', 'rank', 'pass 1 (front)', 'pass 2 (tail)',
                 'write')
PERM_PHASES = ('stage', 'steps', 'rows+tile')
DECODE_PHASES = ('start list', 'stage', 'steps', 'write')


def summarize(st, names):
    """Per-phase mean and max cycles over chunks, the slowest chunk's
    phases and step counts, and cycles per step of the step phases."""
    k = len(names)
    total = st[:, :k].sum(1)
    slow = int(total.argmax())
    out = {'mean': dict(zip(names, st[:, :k].mean(0).round(1).tolist())),
           'max': dict(zip(names, st[:, :k].max(0).tolist())),
           'slowest_chunk': slow,
           'slowest': dict(zip(names, st[slow, :k].tolist())),
           'slowest_steps': int(st[slow, k]),
           'slowest_deep': int(st[slow, k + 1]),
           'steps_mean': float(st[:, k].mean()),
           'deep_mean': float(st[:, k + 1].mean())}
    return out


def phase_report(_cuda, bk, bd, dense, uniform, codes, zipf, zn):
    """The kernels built with CZ_MTF_PROFILE=1: each launch's cycles per
    chunk by phase on sample5's block and the random inputs."""
    import ctypes
    lib = _cuda._bind(ctypes.CDLL(_cuda._build(
        _cuda.SOURCES, ('CZ_MTF_PROFILE=1',))))
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cz_mtf_encode_phases.argtypes = [p, i32]
    lib.cz_mtf_undo_phases.argtypes = [p, p, i32]
    api = New(lib, bk, bd)
    api.stream = _cuda.stream_handle(dense.device)
    rep = {}
    for name, d in (('encode_sample5', dense), ('encode_uniform', uniform)):
        n = d.shape[0]
        chunks = -(-n // CHUNK)
        kernels, _ = api.encode_launches(d)
        kernels['step'](chunks)()
        torch.cuda.synchronize()
        st = np.zeros((chunks, 8), np.int64)
        _cuda.check(lib.cz_mtf_encode_phases(st.ctypes.data, chunks),
                    'phases')
        rep[name] = r = summarize(st, ENCODE_PHASES)
        steps, deep = st[:, 5].sum(), st[:, 6].sum()
        r['pass1_cycles_per_step'] = float(st[:, 2].sum() / max(steps, 1))
        r['pass2_cycles_per_deep'] = float(st[:, 3].sum() / max(deep, 1))
    for name, idx, n in (('decode_sample5', codes, CAP),
                         ('decode_zipf', zipf, zn)):
        chunks = -(-n // CHUNK)
        kernels, _ = api.decode_launches(idx, n)
        kernels['perm'](chunks)()
        kernels['step'](chunks)()
        torch.cuda.synchronize()
        sp = np.zeros((chunks, 8), np.int64)
        sd = np.zeros((chunks, 8), np.int64)
        _cuda.check(lib.cz_mtf_undo_phases(sp.ctypes.data, sd.ctypes.data,
                                           chunks), 'phases')
        # the perm rows hold 3 phases then counts at 4, 5: move them up
        rep[name + '_perm'] = r = summarize(
            np.concatenate([sp[:, :3], sp[:, 4:6]], 1), PERM_PHASES)
        r['cycles_per_step'] = float(sp[:, 1].sum() / max(sp[:, 4].sum(), 1))
        rep[name + '_decode'] = r = summarize(sd, DECODE_PHASES)
        r['cycles_per_step'] = float(sd[:, 2].sum() / max(sd[:, 4].sum(), 1))
    for name, r in rep.items():
        print('  phases %s: mean %s; slowest chunk %d: %s (%d steps, %d '
              'deep); %s' % (name, r['mean'], r['slowest_chunk'],
                             r['slowest'], r['slowest_steps'],
                             r['slowest_deep'],
                             {k: round(v, 1) for k, v in r.items()
                              if 'per' in k}))
    return rep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=HERE,
                    help='tree whose compressjs_tpu_torch is loaded')
    ap.add_argument('--label', default='this tree')
    ap.add_argument('--out', help='also write the JSON here')
    ap.add_argument('--sass', help='write the SASS of the MTF kernels '
                    '(cuobjdump) to this file')
    ap.add_argument('--phases', action='store_true',
                    help='time each kernel phase (a CZ_MTF_PROFILE build)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_mtf_profile: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import block_decode as bd
    from compressjs_tpu_torch.ops import block_kernels as bk
    assert bk.CHUNK_LEN == bd.CHUNK_LEN == CHUNK
    dev = torch.device('cuda')
    card = card_line()
    print('%s: %s' % (args.label, card), flush=True)
    lib = _cuda.lib()
    ptxas = [ln.strip() for ln in _cuda.build_info['log'].splitlines()
             if 'ptxas' in ln or 'stack frame' in ln]
    api = (New if hasattr(lib, 'cz_mtf_undo_prefix') else Old)(lib, bk, bd)
    api.stream = _cuda.stream_handle(dev)
    res = {'label': args.label, 'root': os.path.abspath(args.root),
           'card': card, 'api': type(api).__name__, 'ptxas': ptxas}
    # the MTF kernels' lines: each "Compiling entry" line and the two
    # after it (registers, stack frame)
    for i, ln in enumerate(ptxas):
        if 'mtf' in ln and 'Compiling' in ln:
            print('  ' + ' | '.join(ptxas[i:i + 3]))

    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), 'cuobjdump')
        sass = subprocess.run([cuobjdump, '-sass', _cuda.build_info['path']],
                              capture_output=True, text=True).stdout
        keep, on = [], False
        for ln in sass.splitlines():
            if 'Function :' in ln:
                on = 'mtf' in ln
            if on:
                keep.append(ln)
        os.makedirs(os.path.dirname(os.path.abspath(args.sass)),
                    exist_ok=True)
        with open(args.sass, 'w') as f:
            f.write('\n'.join(keep) + '\n')

    dense = sample5_inputs(dev)
    n = dense.shape[0]
    rng = np.random.default_rng(1234)
    uniform = torch.from_numpy(rng.integers(0, 256, n).astype(
        np.int32)).to(dev)
    zipf = np.minimum(rng.zipf(1.3, n) - 1, 255).astype(np.int32)
    zipf[3::97] = 256
    zipf = torch.from_numpy(zipf).to(dev)
    want_codes = bk.mtf_encode(dense.cpu(), n)
    codes = torch.zeros(CAP, dtype=torch.int32, device=dev)
    codes[:n] = want_codes.to(dev)

    def probe(kernels, out, want, chunk_counts, reps=20):
        t = {}
        for name, make in kernels.items():
            t[name] = {c: cuda_ms(make(c), reps) for c in chunk_counts}
        err = int((out.cpu().long() - want.long()).abs().max())
        return t, err

    full = -(-n // CHUNK)
    counts = [1, 4, 16, 132, 528, full]
    enc_k, enc_out = api.encode_launches(dense)
    res['encode_sample5'], e1 = probe(enc_k, enc_out, want_codes, counts)
    dec_k, dec_out = api.decode_launches(codes, CAP)
    want_dec = bd.mtf_decode_plain(codes.cpu(), CAP)
    res['decode_sample5'], e2 = probe(dec_k, dec_out, want_dec,
                                      counts[:-1] + [-(-CAP // CHUNK)])
    enc_k, enc_out = api.encode_launches(uniform)
    res['encode_uniform'], e3 = probe(enc_k, enc_out,
                                      bk.mtf_encode(uniform.cpu(), n),
                                      [full])
    zn = n - 4
    dec_k, dec_out = api.decode_launches(zipf, zn)
    res['decode_zipf'], e4 = probe(dec_k, dec_out,
                                   bd.mtf_decode_plain(zipf.cpu(), zn),
                                   [-(-zn // CHUNK)])
    res['max_abs_err'] = max(e1, e2, e3, e4)
    if res['max_abs_err']:
        raise AssertionError('an MTF kernel differs from its plain '
                             'version: %d' % res['max_abs_err'])
    for key in ('encode_sample5', 'decode_sample5', 'encode_uniform',
                'decode_zipf'):
        for name, by_c in res[key].items():
            print('  %s %s: %s' % (key, name, ', '.join(
                '%d chunks %.4f ms' % kv for kv in by_c.items())))

    stages = {}
    for name, fn in (('mtf_encode', lambda: bk.mtf_encode(dense, n)),
                     ('mtf_decode', lambda: bd.mtf_decode(codes, CAP))):
        stages[name] = {'device_ms': cuda_ms(fn, 20),
                        'wall_ms': wall_ms(fn, 20),
                        'kernels_per_call': kernels_per_call(fn)}
        print('  stage %s: %.4f ms device (20 calls back to back), %.4f ms '
              'wall per synchronised call, %d kernels a call'
              % (name, stages[name]['device_ms'], stages[name]['wall_ms'],
                 stages[name]['kernels_per_call']))
    res['stages'] = stages
    for name in stages:
        got = (bk.mtf_encode(dense, n) if name == 'mtf_encode'
               else bd.mtf_decode(codes, CAP))
        want = want_codes if name == 'mtf_encode' else want_dec
        if not torch.equal(got.cpu(), want):
            raise AssertionError('%s differs from its plain version' % name)
    clocks = sm_clock_while(dec_k['step'](-(-zn // CHUNK)))
    res['sm_clock_mhz'] = clocks
    print('  SM clock under the decode kernel: %s MHz' % clocks)
    if args.phases and isinstance(api, New):
        res['phases'] = phase_report(_cuda, bk, bd, dense, uniform, codes,
                                     zipf, zn)
    res['card_after'] = card_line()
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line)
    return 0


if __name__ == '__main__':
    sys.exit(main())
