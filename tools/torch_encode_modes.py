#!/usr/bin/env python3
"""The -9 encode of sample5x4 in each encoder split on one CUDA card,
with and without the encoder's overlap of device and host work; or, with
--hetero, the host + card encode against the card's encode.

    python3 tools/torch_encode_modes.py [--pairs N] [--out PATH]
    python3 tools/torch_encode_modes.py --hetero [--tile K]
        [--host-workers W] [--pairs N] [--out PATH]

For each of 'full', 'core', 'hybrid' and 'hybrid' with one batched BWT:
one warm-up encode, then N pairs of encodes that alternate which runs
first: the encoder as it is (a worker thread runs each block's device
stage while the calling thread runs the host stage of the block before)
and the same encoder with its device stages run inline on the calling
thread (no overlap).  Then one profiled encode (``torch.profiler``) for
the card's busy ms and idle share.  Every output is checked against the
golden.  Prints one JSON object with the card's name and power limit and
the host CPU, and writes it to --out when given.

--hetero: sample5x4 tiled K times (default 3: 29 blocks); one warm-up of
each, then N pairs that alternate which runs first:
``hetero_compress_bzip2`` (W host workers, default 2, and the device
worker) and ``compress_file_device`` (mode 'full') on the same input.
Both outputs must be equal.  Prints each run's wall and the hetero
scheduler's counts (blocks by the hosts and the device, steals, denied
claims), the medians, MB/s and how many pairs hetero won.
"""

import argparse
import bz2
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import Future

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [('full', {'mode': 'full'}), ('core', {'mode': 'core'}),
           ('hybrid', {'mode': 'hybrid'}),
           ('hybrid_batch', {'mode': 'hybrid', 'batch': True})]


class InlinePool:
    """A stand-in for the encoder's one-thread pool that runs each task
    when it is submitted."""

    def __init__(self, workers):
        pass

    def submit(self, fn, *args):
        fut = Future()
        try:
            fut.set_result(fn(*args))
        except Exception as e:    # handed to the reader, as a pool would
            fut.set_exception(e)
        return fut

    def shutdown(self, wait=True, cancel_futures=False):
        pass


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


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


def hetero_pairs(cz, data, pairs, host_workers):
    """(walls by side, hetero's last_stats per run, runs hetero won)."""
    def run(side):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if side == 'hetero':
            out = cz.hetero_compress_bzip2(data, level=9,
                                           host_workers=host_workers)
        else:
            out = cz.compress_file_device(data, level=9)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    want, _ = run('device')
    if run('hetero')[0] != want:
        raise AssertionError('hetero stream differs from '
                             'compress_file_device\'s')
    walls = {'hetero': [], 'device': []}
    stats = []
    for i in range(pairs):
        for side in (('hetero', 'device') if i % 2 == 0
                     else ('device', 'hetero')):
            out, wall = run(side)
            if out != want:
                raise AssertionError('%s stream differs' % side)
            walls[side].append(wall)
            if side == 'hetero':
                stats.append(dict(cz.hetero_compress_bzip2.last_stats))
    wins = sum(a < b for a, b in zip(walls['hetero'], walls['device']))
    return walls, stats, wins


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--pairs', type=int, default=5)
    ap.add_argument('--out', help='also write the JSON here')
    ap.add_argument('--hetero', action='store_true',
                    help='time hetero_compress_bzip2 against '
                         'compress_file_device instead of the splits')
    ap.add_argument('--tile', type=int, default=3)
    ap.add_argument('--host-workers', type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_encode_modes: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import compressjs_tpu_torch as cz
    from compressjs_tpu_torch import native
    from compressjs_tpu_torch.parallel import pipeline as pl
    from torch.profiler import ProfilerActivity, profile

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'sample5x4_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    data = bz2.decompress(gold)
    if args.hetero:
        data = data * args.tile
        walls, stats, wins = hetero_pairs(cz, data, args.pairs,
                                          args.host_workers)
        med = {k: statistics.median(v) for k, v in walls.items()}
        result = {'card': card_line(),
                  'device': torch.cuda.get_device_name(0),
                  'host_cpu': native.cpu_model(),
                  'cpu_count': os.cpu_count(), 'input_bytes': len(data),
                  'host_workers': args.host_workers, 'pairs': args.pairs,
                  'wall_s': walls, 'median_s': med,
                  'median_mb_s': {k: len(data) / v / 1e6
                                  for k, v in med.items()},
                  'hetero_wins': wins, 'hetero_stats': stats}
        return emit(result, args.out)
    pool = pl.ThreadPoolExecutor

    def encode(kw, overlap):
        pl.ThreadPoolExecutor = pool if overlap else InlinePool
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cz.compress_file_device(data, level=9, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pl.ThreadPoolExecutor = pool
        if out != gold:
            raise AssertionError('encode differs from the golden: %s' % kw)
        return wall

    result = {'card': card_line(), 'device': torch.cuda.get_device_name(0),
              'host_cpu': native.cpu_model(), 'input_bytes': len(data),
              'pairs': args.pairs, 'configs': {}}
    for name, kw in CONFIGS:
        encode(kw, True)
        walls = {'overlap': [], 'inline': []}
        for i in range(args.pairs):
            order = ('overlap', 'inline') if i % 2 == 0 \
                else ('inline', 'overlap')
            for side in order:
                walls[side].append(encode(kw, side == 'overlap'))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pwall = encode(kw, True)
        busy = busy_ms(prof.events())
        med = {k: statistics.median(v) for k, v in walls.items()}
        result['configs'][name] = {
            'wall_s': walls, 'median_s': med,
            'median_mb_s': {k: len(data) / v / 1e6 for k, v in med.items()},
            'overlap_wins': sum(a < b for a, b in zip(walls['overlap'],
                                                      walls['inline'])),
            'profiled_wall_s': pwall, 'busy_ms': busy,
            'idle_share': 1 - busy / (pwall * 1e3)}
        print(name, json.dumps(result['configs'][name]), flush=True)
    return emit(result, args.out)


def emit(result, out):
    text = json.dumps(result)
    print(text)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, 'w') as f:
            f.write(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
