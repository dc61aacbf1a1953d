#!/usr/bin/env python3
"""The -9 encode of sample5x4 in each encoder split on one CUDA card,
with and without the encoder's overlap of device and host work.

    python3 tools/torch_encode_modes.py [--pairs N] [--out PATH]

For each of 'full', 'core', 'hybrid' and 'hybrid' with one batched BWT:
one warm-up encode, then N pairs of encodes that alternate which runs
first: the encoder as it is (a worker thread runs each block's device
stage while the calling thread runs the host stage of the block before)
and the same encoder with its device stages run inline on the calling
thread (no overlap).  Then one profiled encode (``torch.profiler``) for
the card's busy ms and idle share.  Every output is checked against the
golden.  Prints one JSON object with the card's name and power limit and
the host CPU, and writes it to --out when given.
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

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        fut = Future()
        try:
            fut.set_result(fn(*args))
        except Exception as e:    # handed to the reader, as a pool would
            fut.set_exception(e)
        return fut


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--pairs', type=int, default=5)
    ap.add_argument('--out', help='also write the JSON here')
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
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
