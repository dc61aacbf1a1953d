"""Tracing and profiling of the block pipelines (counterpart of
``compressjs_tpu.parallel.profiling``).

* `stage_timer()` -- the process's one `StageTimer`: host seconds and
  entries of the entry points' named stages, and integer counters; on
  with COMPRESSJS_TPU_TRACE=1 (each entry point prints the report to
  stderr) or by setting its `enabled`.  While it is on, each stage is
  also a ``compressjs/<name>`` range on ``torch.profiler``'s host
  timeline, beside the card's operations on the same clock.  The timer
  lives in the leaf module ``compressjs_tpu_torch.tracer``, which every
  layer may import; README lists the stage and counter names.
* `device_trace(logdir)` -- a ``torch.profiler`` trace of a region, with
  the timer on, written as a Chrome trace.
* `roofline(stage, n, seconds)` -- a stage's time against the least time
  the H100's memory allows for its bytes.
* `chain_throughput(body, init, n_bytes)` -- a device stage's rate with
  CUDA events over chained calls.
"""

from __future__ import annotations

import contextlib
import os

from ..tracer import SPAN_PREFIX, StageTimer, stage_timer  # noqa: F401


@contextlib.contextmanager
def device_trace(logdir):
    """Trace a region with ``torch.profiler`` (the card's kernels too,
    where there is a card), with `stage_timer()` on for the region so
    that the program's ``compressjs/`` stages show beside them, and
    write ``logdir/trace.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    timer = stage_timer()
    was = timer.enabled
    timer.enabled = True
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        timer.enabled = was
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


# H100 SXM HBM3 bandwidth (NVIDIA H100 data sheet), the peak that
# `roofline` holds a stage against.  No random-gather rate has been
# measured on the card, so there is no gather bound.
HBM_PEAK_BYTES_PER_S = 3.35e12

# The least bytes each stage of the port must move for n elements: each
# input read once and each output written once, in the port's own types.
# Outputs whose size follows the data (symbol streams, payloads) are not
# counted, so every model is a lower bound.  n counts block bytes for
# 'bwt', 'mtf', 'rle2', 'mtf_undo', 'ibwt' and 'rle1_undo', symbols for
# 'groups' and 'pack'.
STAGE_MODELS = {
    'bwt': lambda n: 2 * n,          # uint8 block in, uint8 U out
    'mtf': lambda n: 8 * n,          # int32 symbols in, int32 indices out
    'rle2': lambda n: 4 * n,         # int32 indices in
    'groups': lambda n: 2 * n,       # int16 symbols in
    'pack': lambda n: 2 * n,         # int16 symbols in
    'mtf_undo': lambda n: 8 * n,     # int32 indices in, int32 symbols out
    'ibwt': lambda n: 2 * n,         # uint8 U in, uint8 block out
    'rle1_undo': lambda n: n,        # uint8 block in
}


def roofline(stage, n, seconds):
    """One measured stage against its memory bound: ms, the model's
    bytes, the rate they imply, and the share of the HBM bound reached
    (100 means the stage runs at the card's memory rate)."""
    b = STAGE_MODELS[stage](n)
    t_bound = b / HBM_PEAK_BYTES_PER_S
    return {
        'ms': seconds * 1e3,
        'bytes_moved_mb': b / 1e6,
        'achieved_gb_s': b / seconds / 1e9,
        'bound': 'hbm',
        'pct_of_bound': 100 * t_bound / seconds,
    }


def chain_throughput(body, init, n_bytes, iters=10, reps=2):
    """Rate of a device stage: `iters` chained calls x = body(x) from a
    CUDA tensor `init`, timed with CUDA events after one warm-up chain,
    best of `reps`.  Returns (MB/s of n_bytes per call, the share of the
    HBM peak that one read and one write of n_bytes per call reach)."""
    import torch
    if init.device.type != 'cuda':
        raise RuntimeError('chain_throughput times the card: init is on %s'
                           % init.device)

    def chain():
        x = init
        for _ in range(iters):
            x = body(x)
        return x

    chain()
    torch.cuda.synchronize()
    best = None
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        chain()
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / iters
        best = ms if best is None else min(best, ms)
    sec = best / 1e3
    return n_bytes / 1e6 / sec, 2 * n_bytes / sec / HBM_PEAK_BYTES_PER_S
