#!/usr/bin/env python3
"""Wall time of each end-to-end path of compressjs_tpu_torch on one CUDA
card, for runs of two trees side by side.

    python3 tools/torch_path_times.py [--root TREE] [--reps N] [--out PATH]

Imports the package from TREE (default: this checkout), so a parent
commit unpacked with ``git archive`` is timed by the same script: run
parent, change, change, parent in one call and compare medians.  The
paths: the -9 encode (``compress_file_device``) and decode
(``decompress_file_device``) of sample5x4 (the golden decoded);
``mesh_compress_bzip2`` and ``decompress_file_mesh`` with host and
device entropy, in an NCCL process group of this process alone (a
FileStore in a temporary directory, no network);
``decompress_file_parallel``; ``hetero_compress_bzip2`` (two host
workers) and ``compress_file_device`` of sample5x4 tiled three times;
``bwtcl_decompress_device`` of sample5x4's -9 BWTC-L stream (the host
codec's).
One warm-up call of each, then N rounds, each calling every path once
in an order rotated by one per round.  Every output is checked.  Prints
one JSON object (each path's walls and median, the card's name and
power limit, the host CPU) and writes it to --out when given.
"""

import argparse
import bz2
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_line():
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=ROOT)
    ap.add_argument('--reps', type=int, default=5)
    ap.add_argument('--out', help='also write the JSON here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_path_times: no CUDA device', file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch.distributed as dist
    import compressjs_tpu_torch as cz
    from compressjs_tpu_torch import native
    with open(os.path.join(ROOT, 'tests', 'golden',
                           'sample5x4_bzip2_9.bz2'), 'rb') as f:
        comp = f.read()
    data = bz2.decompress(comp)
    tiled = data * 3
    tiled_comp = cz.compress_file_device(tiled, level=9)
    bwtcl_comp = bytes(cz.BWTCL.compress_file(data, None, 9))
    if bz2.decompress(tiled_comp) != tiled:
        raise AssertionError('the tiled input does not round-trip')
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group('nccl', store=dist.FileStore(
            os.path.join(tmp, 'store'), 1), rank=0, world_size=1)
        try:
            mesh = cz.make_mesh('cuda')
            paths = [
                ('compress_file_device',
                 lambda: cz.compress_file_device(data, level=9), comp),
                ('decompress_file_device',
                 lambda: cz.decompress_file_device(comp), data),
                ('mesh_compress_bzip2',
                 lambda: cz.mesh_compress_bzip2(mesh, data, level=9), comp),
                ('decompress_file_mesh_host',
                 lambda: cz.decompress_file_mesh(comp, mesh=mesh,
                                                 entropy='host'), data),
                ('decompress_file_mesh_device',
                 lambda: cz.decompress_file_mesh(comp, mesh=mesh,
                                                 entropy='device'), data),
                ('decompress_file_parallel',
                 lambda: cz.decompress_file_parallel(comp), data),
                ('hetero_compress_bzip2',
                 lambda: cz.hetero_compress_bzip2(tiled, level=9,
                                                  host_workers=2),
                 tiled_comp),
                ('compress_file_device_tiled',
                 lambda: cz.compress_file_device(tiled, level=9),
                 tiled_comp),
                ('bwtcl_decompress_device',
                 lambda: bytes(cz.bwtcl_decompress_device(bwtcl_comp)),
                 data)]
            walls = {name: [] for name, _, _ in paths}

            def run(name, fn, want):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if out != want:
                    raise AssertionError('%s output differs' % name)
                return wall

            for name, fn, want in paths:       # warm-up
                run(name, fn, want)
            for r in range(args.reps):
                k = r % len(paths)
                for name, fn, want in paths[k:] + paths[:k]:
                    walls[name].append(run(name, fn, want))
        finally:
            dist.destroy_process_group()
    result = {'root': root, 'card': card_line(),
              'device': torch.cuda.get_device_name(0),
              'host_cpu': native.cpu_model(), 'reps': args.reps,
              'walls_s': walls,
              'median_s': {k: statistics.median(v)
                           for k, v in walls.items()}}
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
