#!/usr/bin/env python3
"""Where the time of compressjs_tpu_torch's -9 encode goes, on one CUDA
card.

    python3 tools/torch_encode_profile.py [--mode full|core|hybrid]
                                          [--batch] [--out PATH]

Encodes the decoded sample5x4 golden (8,522,560 B) with
``compress_file_device(level=9, mode=...)`` three times after a warm-up:

1. untimed stages, wall clock only (the end-to-end number);
2. with every stage wrapped in a timer: a device stage synchronises the
   card before and after it, so its wall time includes its device work
   (the syncs cost a little; run 1 shows how much); a host stage is
   timed on the host clock alone.  The device stages run on the
   encoder's worker thread, the host entropy stage on the calling
   thread at the same time, so their sums can exceed the wall;
3. under ``torch.profiler``: device time by kernel name and the card's
   busy share of the run's wall time (union of kernel intervals).

Prints one JSON object with the card's name and power limit and the
host CPU's model name, and also writes it to --out when given.
"""

import argparse
import bz2
import collections
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def stage_targets():
    """(module, function name, label, synchronise the card?) of each
    stage."""
    from compressjs_tpu_torch.ops import block_kernels as bk
    from compressjs_tpu_torch.ops import device_entropy as de
    from compressjs_tpu_torch.parallel import pipeline as pl
    return [
        (pl, 'rle1_encode', 'host: RLE1 split (native)', False),
        (pl, 'crc32_bzip2', 'host: block CRC', False),
        (pl, 'mtf_rle2', 'host: MTF + RLE2 (native; hybrid)', False),
        (pl, '_finish_block', 'host: entropy stage (native; core, '
         'hybrid)', False),
        (pl, '_device_block_header', 'host: block header bits (full)',
         False),
        (pl, 'block_inputs', 'host->device block copy', True),
        (bk, 'bwt_block', 'device: rotation sort + BWT', True),
        (bk, 'bwt_block_batch', 'device: batched sort + BWT', True),
        (bk, 'mtf_encode', 'device: MTF (3 kernels)', True),
        (bk, 'rle2_encode', 'device: RLE2', True),
        (de, 'optimize_groups_dev', 'device: group optimisation', True),
        (de, 'code_lengths_batch', 'device: table builds (inside group '
         'optimisation)', True),
        (de, 'payload_pack_words_dev', 'device: payload pack', True),
    ]


# the roofline model of each device stage that has one
ROOFLINE_STAGES = {'device: rotation sort + BWT': 'bwt',
                   'device: batched sort + BWT': 'bwt',
                   'device: MTF (3 kernels)': 'mtf',
                   'device: RLE2': 'rle2'}


@contextlib.contextmanager
def timed_stages(targets):
    """Patch each (module, function name, label) of `targets` with a
    timer that synchronises the card before and after the call; yields
    (seconds by label, calls by label) and undoes the patches on exit."""
    totals = collections.defaultdict(float)
    counts = collections.Counter()
    undo = []
    for mod, name, label, sync in targets:
        orig = getattr(mod, name)

        def timed(*a, _orig=orig, _label=label, _sync=sync, **k):
            if _sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = _orig(*a, **k)
            if _sync:
                torch.cuda.synchronize()
            totals[_label] += time.perf_counter() - t0
            counts[_label] += 1
            return r

        functools.update_wrapper(timed, orig)
        setattr(mod, name, timed)
        undo.append((mod, name, orig))
    try:
        yield totals, counts
    finally:
        for mod, name, orig in undo:
            setattr(mod, name, orig)


def busy_ms(events):
    """Union of device kernel intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--mode', default='full',
                    choices=['full', 'core', 'hybrid'])
    ap.add_argument('--batch', action='store_true',
                    help="one batched BWT call ('hybrid')")
    ap.add_argument('--out', help='also write the JSON here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_encode_profile: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import compressjs_tpu_torch as cz

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'sample5x4_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    data = bz2.decompress(gold)

    def encode():
        out = cz.compress_file_device(data, level=9, mode=args.mode,
                                      batch=args.batch)
        torch.cuda.synchronize()
        if out != gold:
            raise AssertionError('encode differs from the golden')

    encode()  # warm-up: kernel build, allocator caches
    from compressjs_tpu_torch.ops import _cuda
    for name in _cuda.launches:
        _cuda.launches[name] = 0
    t0 = time.perf_counter()
    encode()
    wall = time.perf_counter() - t0
    port_launches = dict(_cuda.launches)

    with timed_stages(stage_targets()) as (totals, counts):
        t0 = time.perf_counter()
        encode()
        staged_wall = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        encode()
        prof_wall = time.perf_counter() - t0
    events = prof.events()
    by_kernel = collections.defaultdict(float)
    launches = collections.Counter()
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name[:80]] += (e.time_range.end -
                                       e.time_range.start) / 1e3
            launches[e.name[:80]] += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    busy = busy_ms(events)

    from compressjs_tpu_torch import native
    from compressjs_tpu_torch.parallel.pipeline import _split_blocks
    from compressjs_tpu_torch.parallel.profiling import roofline
    block_bytes = sum(b.shape[0] for b, _ in _split_blocks(
        np.frombuffer(data, np.uint8), 899981))
    result = {
        'card': card_line(),
        'device': torch.cuda.get_device_name(0),
        'host_cpu': native.cpu_model(),
        'mode': args.mode,
        'batch': args.batch,
        'input_bytes': len(data),
        'encode_wall_s': wall,
        'encode_mb_s': len(data) / wall / 1e6,
        'port_kernel_launches': port_launches,
        'staged_wall_s': staged_wall,
        'stages_s': {k: totals[k] for k in sorted(totals,
                                                  key=lambda k: -totals[k])},
        'stage_calls': dict(counts),
        'block_bytes': block_bytes,
        'roofline': {k: roofline(ROOFLINE_STAGES[k], block_bytes, totals[k])
                     for k in totals if k in ROOFLINE_STAGES},
        'profiled_wall_s': prof_wall,
        'device_kernel_launches': sum(launches.values()),
        'device_busy_ms': busy if by_kernel else 'not measured',
        'device_idle_share': (1 - busy / (prof_wall * 1e3) if by_kernel
                              else 'not measured'),
        'device_ms_by_kernel': dict(top),
        'device_launches_by_kernel': {k: launches[k] for k, _ in top},
    }
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
