#!/usr/bin/env python3
"""Where the time of compressjs_tpu_torch's -9 decode goes, on one CUDA
card.

    python3 tools/torch_decode_profile.py [--out PATH]

Decodes the sample5x4 golden (1,089,841 B -> 8,522,560 B, 10 blocks)
with ``decompress_file_device`` three times after a warm-up, as
tools/torch_encode_profile.py does for the encode: untimed (the
end-to-end number), with every stage wrapped in a synchronising timer,
and under ``torch.profiler`` (device time by kernel, busy share).
Stages nest: the walk's timer includes stage 1, the compositions and the
chase, and the BWT column's includes RLE2 and MTF undo.

Prints one JSON object with the card's name and power limit, and also
writes it to --out when given.
"""

import argparse
import bz2
import collections
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_encode_profile import busy_ms, card_line, timed_stages  # noqa


def stage_targets():
    from compressjs_tpu_torch.ops import device_huffman as dh
    from compressjs_tpu_torch.parallel import decode as dec
    return [
        (dec, '_walk_inputs', 'host: header parse + upload'),
        (dec, 'huffman_walk_dev', 'device: Huffman walk (all)'),
        (dh, '_next_maps', 'device: walk stage 1 (code lengths)'),
        (dh, '_power_k', 'device: walk compositions (compose kernel)'),
        (dh, 'selector_chase', 'device: walk selector chase (kernel)'),
        (dec, 'bwt_column', 'device: BWT column (all)'),
        (dh, 'rle2_decode', 'device: RLE2 undo'),
        (dh, 'mtf_decode', 'device: MTF undo (3 kernels)'),
        (dec, '_device_entropy_collect', 'host: read-back + checks'),
        (dh, 'inverse_bwt_block_masked', 'device: inverse BWT'),
        (dh, 'rle1_decode_dev', 'device: RLE1 undo'),
        (dec, 'crc32_bzip2', 'host: block CRC'),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', help='also write the JSON here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_decode_profile: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import compressjs_tpu_torch as cz

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'sample5x4_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    data = bz2.decompress(gold)

    def decode():
        out = cz.decompress_file_device(gold)
        torch.cuda.synchronize()
        if out != data:
            raise AssertionError('decode differs from bz2')

    decode()  # warm-up: kernel build, allocator caches
    from compressjs_tpu_torch.ops import _cuda
    for name in _cuda.launches:
        _cuda.launches[name] = 0
    t0 = time.perf_counter()
    decode()
    wall = time.perf_counter() - t0
    port_launches = dict(_cuda.launches)

    with timed_stages(stage_targets()) as (totals, counts):
        t0 = time.perf_counter()
        decode()
        staged_wall = time.perf_counter() - t0

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode()
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

    result = {
        'card': card_line(),
        'device': torch.cuda.get_device_name(0),
        'output_bytes': len(data),
        'decode_wall_s': wall,
        'decode_mb_s': len(data) / wall / 1e6,
        'port_kernel_launches': port_launches,
        'staged_wall_s': staged_wall,
        'stages_s': {k: totals[k] for k in sorted(totals,
                                                  key=lambda k: -totals[k])},
        'stage_calls': dict(counts),
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
