#!/usr/bin/env python3
"""``decompress_file_parallel`` of the sample5x4 golden with its two
executors, in pairs: worker threads (the default) against forked worker
processes (``executor='process'``).

    python3 tools/torch_decode_executors.py [--pairs N] [--workers W]
        [--out PATH]

The process touches no CUDA context (forking one that holds it is
unsafe), so it runs on any host; on a card's machine it prints the card
line beside the host CPU, as every number of the port is kept.  One
warm-up of each executor, then N pairs (default 7) that alternate which
runs first; every output is checked against bz2.  Prints each pair, the
medians, MB/s of output and how many pairs the process executor won, as
one JSON object, and writes it to --out when given.
"""

import argparse
import bz2
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    if shutil.which('nvidia-smi') is None:
        return None
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--pairs', type=int, default=7)
    ap.add_argument('--workers', type=int, default=None,
                    help='n_workers of both executors (default: the '
                         "decoder's own)")
    ap.add_argument('--out', default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import compressjs_tpu_torch as cz
    from compressjs_tpu_torch import native
    from compressjs_tpu_torch.parallel.decode import _default_workers

    with open(os.path.join(ROOT, 'tests', 'golden',
                           'sample5x4_bzip2_9.bz2'), 'rb') as f:
        comp = f.read()
    want = bz2.decompress(comp)

    def run(executor):
        t0 = time.perf_counter()
        out = cz.decompress_file_parallel(comp, n_workers=args.workers,
                                          executor=executor)
        wall = time.perf_counter() - t0
        if out != want:
            raise AssertionError('%s executor output differs' % executor)
        return wall

    run('thread')
    run('process')
    pairs = []
    for k in range(args.pairs):
        order = ('thread', 'process') if k % 2 == 0 else \
            ('process', 'thread')
        walls = {e: run(e) for e in order}
        pairs.append(walls)
        print('pair %d (%s first): thread %.4f s, process %.4f s'
              % (k, order[0], walls['thread'], walls['process']),
              flush=True)
    med = {e: statistics.median(p[e] for p in pairs)
           for e in ('thread', 'process')}
    result = {
        'input': 'tests/golden/sample5x4_bzip2_9.bz2',
        'output_bytes': len(want),
        'n_workers': args.workers or _default_workers(),
        'cpu_count': os.cpu_count(),
        'pairs': pairs,
        'median_s': med,
        'mb_s': {e: len(want) / med[e] / 1e6 for e in med},
        'process_won': sum(p['process'] < p['thread'] for p in pairs),
        'card': card_line(),
        'host_cpu': native.build_info['cpu'],
    }
    print(json.dumps(result))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(result, f, indent=1)


if __name__ == '__main__':
    main()
