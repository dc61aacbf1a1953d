"""Where a call's time goes, by the port's own stages, on the card.

    python3 tools/torch_stage_trace.py
        [--entry encode decode bwtcl bwtcp bwtcl_enc]
        [--seed N] [--bytes N] [--reps K] [--calls N] [--out DIR]
        [--device cpu]

For each entry point of the benchmark's cells -- ``compress_file_device``
at -9, ``decompress_file_device`` of a stdlib ``bz2 -9`` stream,
``bwtcl_decompress_device`` of a ``BWTCL -9`` stream,
``bwtcp_compress_device`` at -9 and ``bwtcl_compress_device`` at -9 --
on one file that
the benchmark's generator (``benchmark/traffic.py``) cuts from its
corpus, enwik8's 10^8 bytes by default:

1. one warm call;
2. the rate with the stage timer off, on, and on under ``torch.profiler``,
   `--reps` calls each, in turns;
3. `--calls` calls back to back, profiled with the timer on: the card's
   idle gaps, each put down to the innermost program stage
   (``compressjs/<name>``) open on the calling thread, and on the
   encode's worker, at its middle, and the longest ones to every
   top-level stage and every host operation of 1 ms or more they
   overlap; the share of the calls that no stage on
   the calling thread covers; the timer's totals and counters a block;
   for the bzip2 encode, the worker's host ms a block (``encode.device``)
   for the blocks it started while the calling thread still split and
   queued the file, and for those after;
4. one call under ``torch.cuda.set_sync_debug_mode('warn')`` with the
   timer on: the synchronising operations by source line, beside the
   program's ``host_syncs``.

Prints one JSON line an entry; with ``--out DIR`` also writes it, with
every gap, to ``DIR/<entry>.json``.  Needs a card.
"""

from __future__ import annotations

import argparse
import bz2
import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import compressjs_tpu_torch as cz  # noqa: E402
from compressjs_tpu_torch.parallel import profiling  # noqa: E402
from benchmark.tracing import _union, profiler  # noqa: E402

CALL = 'tool/call'
# the function called once a block, by its stage
BLOCK_STAGE = {'encode': 'ops.bwt_block', 'decode': 'decode.inverse',
               'bwtcl': 'bwtcl.launch', 'bwtcp': 'ops.bwt_eof_block',
               'bwtcl_enc': 'bwtcl_enc.launch'}


def _inputs(entry, data, device):
    """(the call on `device`, its input)."""
    if entry == 'encode':
        return (lambda x: cz.compress_file_device(x, level=9,
                                                  device=device)), data
    if entry == 'decode':
        return (lambda x: cz.decompress_file_device(x, device=device),
                bz2.compress(data, 9))
    if entry == 'bwtcp':
        return (lambda x: cz.bwtcp_compress_device(x, level=9,
                                                   device=device)), data
    if entry == 'bwtcl_enc':
        return (lambda x: cz.bwtcl_compress_device(x, level=9,
                                                   device=device)), data
    comp = cz.BWTCL.compress_file(np.frombuffer(data, np.uint8), None, 9)
    return (lambda x: cz.bwtcl_decompress_device(x, device=device),
            bytes(comp))


def _innermost(ranges, times):
    """For each of the ascending `times`, the name of the innermost of
    one thread's `ranges` (start, end, name; nested, sorted by start)
    that holds it, or None: one sweep with a stack of open ranges."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _sync(device):
    if device == 'cuda':
        torch.cuda.synchronize()


def _timed(call, x, device, timer, on, prof):
    timer.enabled = on
    try:
        with profiler() if prof else contextlib.nullcontext():
            t0 = time.perf_counter()
            call(x)
            _sync(device)
            return time.perf_counter() - t0
    finally:
        timer.enabled = False


def _reset(timer):
    timer.totals.clear()
    timer.counts.clear()
    timer.counters.clear()


def _top(ranges):
    """The ranges of one thread (sorted by start) that no other holds."""
    out = []
    for r in ranges:
        if not out or r[0] >= out[-1][1]:
            out.append(r)
    return out


def _profiled(call, x, device, timer, block_stage, calls):
    """`calls` calls back to back under the profiler with the timer on:
    their gaps, coverage and the timer's numbers."""
    from torch._C._profiler import _RecordFunctionFast
    _reset(timer)
    timer.enabled = True
    try:
        with profiler() as prof:
            for _ in range(calls):
                with _RecordFunctionFast(CALL):
                    call(x)
            _sync(device)
    finally:
        timer.enabled = False
    from torch.autograd import DeviceType
    ranges = collections.defaultdict(list)      # thread -> [(s, e, name)]
    dev, call_spans, host = [], [], []
    for e in prof.profiler.kineto_results.events():
        name, s = e.name(), e.start_ns()
        end = s + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if end - s >= 1e6:                  # a host event of 1 ms or more
                host.append((s, end, e.start_thread_id(), name))
            if name == CALL:
                call_spans.append((s, end, e.start_thread_id()))
            elif name.startswith(profiling.SPAN_PREFIX):
                ranges[e.start_thread_id()].append(
                    (s, end, name[len(profiling.SPAN_PREFIX):]))
        elif not name.startswith((profiling.SPAN_PREFIX, 'tool/')):
            dev.append((s, end))
    call_spans.sort()
    t0, t1, caller = call_spans[0][0], call_spans[-1][1], call_spans[0][2]
    ranges[caller] += [(e, s, '(between calls)') for (_, e, _), (s, _, _)
                       in zip(call_spans, call_spans[1:])]
    for r in ranges.values():
        r.sort(key=lambda r: (r[0], -r[1]))      # a range before those in it
    others = [tid for tid in ranges if tid != caller]
    busy = _union((max(s, t0), min(e, t1)) for s, e in dev
                  if min(e, t1) > max(s, t0))
    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    idle = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    mids = [(s + e) / 2 for s, e in idle]
    labels = [[n or '(no stage)' for n in _innermost(ranges[caller], mids)]]
    labels += [_innermost(ranges[t], mids) for t in others]
    gaps, idle_by = [], collections.defaultdict(float)
    for k, (s, e) in enumerate(idle):
        label = labels[0][k]
        worker = [w[k] for w in labels[1:] if w[k]]
        if worker:
            label += ' | worker: ' + ', '.join(worker)
        gaps.append(((e - s) * 1e-9, label))
        idle_by[label] += (e - s) * 1e-9
    top = _top(ranges[caller])
    covered = _union((max(s, t0), min(e, t1)) for s, e, n in top
                     if min(e, t1) > max(s, t0) and n != '(between calls)')
    wall = (t1 - t0) * 1e-9
    in_calls = sum(e - s for s, e, _ in call_spans) * 1e-9
    uncovered = in_calls - sum(e - s for s, e in covered) * 1e-9
    idle.sort(key=lambda g: g[0] - g[1])

    def overlaps(s, e):
        """{top-level stage: seconds of the gap s..e it covers}"""
        out = collections.defaultdict(float)
        for rs, re_, n in top:
            if rs < e and re_ > s:
                out[n] += (min(e, re_) - max(s, rs)) * 1e-9
        return {n: round(v, 6) for n, v in out.items()}

    def held(s, e):
        """The host events of 1 ms or more on the calling thread that
        overlap the gap s..e, outside the program's ranges: [name,
        seconds of the gap they cover]."""
        out = [[n, round((min(e, he) - max(s, hs)) * 1e-9, 6)]
               for hs, he, tid, n in host
               if tid == caller and hs < e and he > s and n != CALL
               and not n.startswith(profiling.SPAN_PREFIX)]
        return sorted(out, key=lambda x: -x[1])[:8]
    blocks = timer.counts.get(block_stage, 0) or float('nan')
    gaps.sort(reverse=True)
    extra = _worker_blocks(ranges, caller, others, call_spans)
    return dict(extra, **{
        'wall_s': wall,
        'busy_s': sum(e - s for s, e in busy) * 1e-9,
        'idle_share': 1 - sum(e - s for s, e in busy) * 1e-9 / wall,
        'calls': len(call_spans),
        'uncovered_share': uncovered / in_calls,
        'blocks': blocks,
        'longest_gaps': [[round(g, 6), n] for g, n in gaps[:12]],
        'longest_gaps_by_top_stage': [[round((e - s) * 1e-9, 6),
                                       overlaps(s, e), held(s, e)]
                                      for s, e in idle[:6]],
        'idle_by_stage_s': dict(sorted(idle_by.items(),
                                       key=lambda kv: -kv[1])[:12]),
        'stage_ms_per_block': {n: 1e3 * t / blocks for n, t in sorted(
            timer.totals.items(), key=lambda kv: -kv[1])},
        'stage_counts': dict(timer.counts),
        'counters_per_block': {n: c / blocks
                               for n, c in timer.counters.items()},
    }), gaps


def _worker_blocks(ranges, caller, others, call_spans):
    """The bzip2 encode's worker host ms a block (its `encode.device`
    ranges), for the blocks it started while the calling thread was
    still splitting and queueing (before the call's last `encode.queue`
    ended) and for those after; {} for another entry point."""
    queued = [r for r in ranges[caller] if r[2] == 'encode.queue']
    if not queued:
        return {}
    during, after = [], []
    for s, e, _ in call_spans:
        split_end = max((qe for qs, qe, _ in queued if s <= qs < e),
                        default=s)
        for t in others:
            for ws, we, n in ranges[t]:
                if n == 'encode.device' and s <= ws < e:
                    (during if ws < split_end else after).append(
                        (we - ws) * 1e-6)
    return {'worker_ms_per_block': {
        k: {'blocks': len(ms),
            'mean_ms': statistics.fmean(ms) if ms else None,
            'median_ms': statistics.median(ms) if ms else None}
        for k, ms in (('during_split', during), ('after_split', after))}}


def _synced(call, x, timer, block_stage):
    """One call in sync debug mode: the synchronising operations by
    source line, and host_syncs."""
    _reset(timer)
    timer.enabled = True
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            call(x)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        timer.enabled = False
    sites = collections.Counter(
        '%s:%d' % (os.path.relpath(w.filename, ROOT), w.lineno)
        for w in caught if 'synchroniz' in str(w.message))
    blocks = timer.counts.get(block_stage, 0) or float('nan')
    return {'sync_debug_per_block': sum(sites.values()) / blocks,
            'host_syncs_per_block': timer.counters['host_syncs'] / blocks,
            'sync_sites_per_block': {k: v / blocks
                                     for k, v in sites.most_common()}}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--entry', nargs='+', choices=sorted(BLOCK_STAGE),
                   default=['encode', 'decode', 'bwtcl', 'bwtcp',
                            'bwtcl_enc'])
    p.add_argument('--seed', type=int, default=3_000_000_019)
    p.add_argument('--bytes', type=int, default=100_000_000)
    p.add_argument('--reps', type=int, default=3)
    p.add_argument('--calls', type=int, default=2)
    p.add_argument('--device', default='cuda',
                   help="'cpu' rehearses the tool at a small --bytes with "
                        'the kernels\' plain versions (no sync debug)')
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        print('torch_stage_trace: no CUDA device', file=sys.stderr)
        return 2
    from benchmark import traffic as tr
    card = (subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True,
                           text=True).stdout.strip()
            if args.device == 'cuda' else 'cpu')
    corpus = tr.load_corpus('data/sample5_bzip2_9.bz2')
    data = tr.make_pool(corpus, {'chunk_bytes': 4096, 'pool_passes': 1,
                                 'ladder_bytes': [args.bytes]},
                        args.seed)[0]['data']
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    timer = profiling.stage_timer()
    timer.report = lambda out=None: None
    for entry in args.entry:
        call, x = _inputs(entry, data, args.device)
        call(x)                                  # warm
        _sync(args.device)
        modes = {'off': (False, False), 'timer': (True, False),
                 'timer+profiler': (True, True)}
        times = collections.defaultdict(list)
        for r in range(args.reps):
            order = list(modes) if r % 2 == 0 else list(modes)[::-1]
            for m in order:
                times[m].append(_timed(call, x, args.device, timer,
                                       *modes[m]))
        line, gaps = _profiled(call, x, args.device, timer,
                               BLOCK_STAGE[entry], args.calls)
        if args.device == 'cuda':
            line.update(_synced(call, x, timer, BLOCK_STAGE[entry]))
        line = dict(
            {'entry': entry, 'card': card, 'file_bytes': len(data),
             'MBps': {m: [len(data) / t / 1e6 for t in ts]
                      for m, ts in times.items()},
             'MBps_median': {m: statistics.median(len(data) / t / 1e6
                                                  for t in ts)
                             for m, ts in times.items()}}, **line)
        if args.out:
            with open(os.path.join(args.out, entry + '.json'), 'w') as f:
                json.dump(dict(line, gaps=gaps), f, indent=1)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
