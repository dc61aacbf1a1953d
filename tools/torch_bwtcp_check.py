"""BWTC-P or BWTC-L -9 at full width on the card: the port's normal
entry point against the host codec, and the benchmark's plain reference
on its output.

    python3 tools/torch_bwtcp_check.py [--format bwtcp|bwtcl]
        [--seed N ...] [--bytes N] [--batch B] [--workers W]
        [--device cpu]

For each seed, one file that the benchmark's generator
(``benchmark/traffic.py``) cuts from its corpus, enwik8's 10^8 bytes by
default: the format's entry, ``bwtcp_compress_device(data, level=9,
batch=B)`` or ``bwtcl_compress_device(data, level=9)`` (its 128 lanes),
once to warm and once timed, its ``last_stats``, the stream held byte
for byte to the host codec's ``compress_file(data, None, 9)``
(``host.bwtcp.BWTCP`` or ``host.bwtcl.BWTCL``), the card's peak memory,
and the seconds the plain reference ``benchmark/reference/bwtc.py``
(``decode`` or ``decode_bwtcl``) takes to decode the stream on W worker
processes (and whether it gives the file back).  Prints one JSON line a
seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--format', choices=('bwtcp', 'bwtcl'), default='bwtcp')
    p.add_argument('--seed', type=int, nargs='+', default=[3_000_000_019])
    p.add_argument('--bytes', type=int, default=100_000_000)
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--workers', type=int, default=8)
    p.add_argument('--device', default='cuda')
    args = p.parse_args(argv)
    import numpy as np
    import torch
    from compressjs_tpu_torch.host import bwtcl as hbwtcl
    from compressjs_tpu_torch.host import bwtcp as hbwtcp
    from compressjs_tpu_torch.parallel import pipeline
    from benchmark import traffic as tr
    from benchmark.reference import bwtc as ref
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('torch_bwtcp_check: no CUDA device', file=sys.stderr)
        return 2
    card = (subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True).stdout.strip()
            if args.device == 'cuda' else 'cpu')
    if args.format == 'bwtcp':
        entry = pipeline.bwtcp_compress_device
        kwargs = {'batch': args.batch}
        host, decode = hbwtcp.BWTCP, ref.decode
    else:
        entry, kwargs = pipeline.bwtcl_compress_device, {}
        host, decode = hbwtcl.BWTCL, ref.decode_bwtcl
    corpus = tr.load_corpus('data/sample5_bzip2_9.bz2')
    for seed in args.seed:
        data = tr.make_pool(corpus, {'chunk_bytes': 4096, 'pool_passes': 1,
                                     'ladder_bytes': [args.bytes]},
                            seed)[0]['data']

        def encode():
            out = entry(data, level=9, device=args.device, **kwargs)
            if args.device == 'cuda':
                torch.cuda.synchronize()
            return out
        t0 = time.perf_counter()
        encode()
        warm_s = time.perf_counter() - t0
        if args.device == 'cuda':
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = encode()
        call_s = time.perf_counter() - t0
        stats = dict(entry.last_stats)
        peak = (torch.cuda.max_memory_allocated()
                if args.device == 'cuda' else 0)
        t0 = time.perf_counter()
        host_out = host.compress_file(np.frombuffer(data, np.uint8), None,
                                      9)
        host_s = time.perf_counter() - t0
        stream = np.asarray(out, dtype=np.uint8).tobytes()
        same = stream == np.asarray(host_out, dtype=np.uint8).tobytes()
        t0 = time.perf_counter()
        try:
            back = decode(stream, workers=args.workers).data == data
        except ref.FormatError as e:
            back = 'FormatError: %s' % e
        judge_s = time.perf_counter() - t0
        print(json.dumps({
            'format': args.format, 'seed': seed, 'card': card,
            'file_bytes': len(data),
            'stream_bytes': len(stream), 'last_stats': stats,
            'equal_to_host_codec': same, 'reference_gives_file': back,
            'warm_call_s': warm_s, 'call_s': call_s,
            'encode_MBps': len(data) / call_s / 1e6,
            'host_codec_s': host_s, 'judge_s': judge_s,
            'judge_workers': args.workers, 'memory_peak_bytes': peak}),
            flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
