"""Run one cell of the benchmark of compressjs_tpu_torch on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  It prints, as the last line of its
standard output, one JSON object: correct, attempted, failed, metrics,
device (and with --trace 1 a breakdown), then the numbers compared with
their limits under 'checks'.  Without a CUDA card it exits 2 and prints
no result.  ``BENCHMARK.json`` lists the cells.
"""

import os
import sys
import time


def _process_start():
    """When this process started, on the wall clock (set-up counts from
    there)."""
    try:
        with open('/proc/self/stat') as f:
            ticks = int(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError):
        return time.time()


if __name__ == '__main__':
    start = _process_start()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # every cache a run can fill lives at a fixed place in the checkout,
    # so that only a cell's first run there builds or compiles
    cache = os.path.join(root, '.bench_cache')
    os.environ.setdefault('PYTORCH_KERNEL_CACHE_PATH',
                          os.path.join(cache, 'torch_kernels'))
    os.environ.setdefault('CUDA_CACHE_PATH', os.path.join(cache, 'nv'))
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(cache, 'triton'))
    sys.path.insert(0, root)
    from benchmark import harness
    sys.exit(harness.main(sys.argv[1:], process_start=start))
