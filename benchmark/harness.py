"""One run of one cell: set-up, warm-up, the measured window, the checks,
and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``: ``configs/<config>.json``
(through its ``file``), ``formats/<format>.py`` (the entries and the
checks of a configuration's format), ``traffic/<traffic>.json`` and
``metrics/<metric>.py``.

The traffic is a closed loop with one caller: the pool's files, one call
of the entry each, back to back and round and round.  The window opens at
the first call after the warm-up and closes when the first call to end
after `--seconds` ends, so the last file counts whole.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import resource
import sys
import time
import traceback

from benchmark import traffic as tr

ROOT = os.path.dirname(tr.ROOT)         # the checkout
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'compressjs_tpu')
# the traced slice: whole passes over the pool from the second on, until
# it has lasted this long (a traffic mix may set its own 'trace_min_s')
TRACE_MIN_S = 2.0


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--fault', default=None,
                   help='break the timed path (faults.py); for the '
                        'controls and their tests, never the benchmark')
    return p.parse_args(argv)


def load_file_module(kind, name):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(tr.ROOT, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        'benchmark_%s_%s' % (kind, name.replace('.', '_').replace('-', '_')),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, trace):
    """The metrics a run of `cell` reports: end-to-end ones untraced,
    per-layer ones traced."""
    group = bench['per_layer' if trace else 'end_to_end']
    return [m for m in group
            if cell['name'] in m.get('workloads', [cell['name']])]


def load_cell(name):
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit('no workload %r in BENCHMARK.json' % name)
    cell = cells[name]
    conf = {c['name']: c for c in bench['configs']}[cell['config']]
    with open(os.path.join(ROOT, conf['file'])) as f:
        config = json.load(f)
    return bench, cell, config, tr.load_json('traffic', cell['traffic'])


def p95(times):
    """Nearest-rank 95th percentile: a time some file really took."""
    s = sorted(times)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Window:
    """The measured window's calls: (pool index, start, end, raised)."""

    def __init__(self, pool):
        self.pool = pool
        self.calls = []
        self.rejected = set()            # calls whose output was wrong

    def add(self, k, t0, t1, raised):
        self.calls.append((k, t0, t1, raised))
        return len(self.calls) - 1

    @property
    def seconds(self):
        return self.calls[-1][2] - self.calls[0][1]

    @property
    def done(self):
        return [i for i, c in enumerate(self.calls)
                if not c[3] and i not in self.rejected]

    @property
    def failed(self):
        return len(self.calls) - len(self.done)

    @property
    def mb_per_s(self):
        """Bytes of every file completed, over the window's wall."""
        b = sum(self.pool[self.calls[i][0]]['size'] for i in self.done)
        return b / self.seconds / 1e6

    @property
    def p95_ms(self):
        return 1e3 * p95([c[2] - c[1] for c in self.calls if not c[3]])


class Run:
    """What the metric readers see: `window`, `setup_s`, and in a traced
    run `slice` (``tracing.Slice``)."""

    def __init__(self, window, setup_s, slice_=None):
        self.window, self.setup_s, self.slice = window, setup_s, slice_


def _device_info(torch, device, chips):
    if device.startswith('cuda'):
        return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                'count': chips,
                'memory_peak_bytes': max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips))}
    return {'platform': 'cpu', 'kind': 'cpu', 'count': chips,
            'memory_peak_bytes': 0}


class TracedSlice:
    """The profiled slice of a traced run: whole passes over the pool,
    from the second pass on, until it has lasted TRACE_MIN_S."""

    def __init__(self, recorder, min_s=TRACE_MIN_S):
        self.recorder = recorder
        self.min_s = min_s
        self.prof = self.span = self.stage = None
        self.stage_before = {}
        self.t0 = None
        self.done = False

    def before_call(self, i, n_pool):
        if self.prof is None and i >= n_pool and i % n_pool == 0:
            from compressjs_tpu_torch.parallel.profiling import stage_timer
            from torch.profiler import record_function
            from benchmark import tracing
            self.stage = stage_timer()
            self.stage.enabled = True
            self.stage.report = lambda out=None: None
            self.stage_before = dict(self.stage.totals)
            self.prof = tracing.profiler()
            self.prof.__enter__()
            self.recorder.active = True
            self.t0 = time.perf_counter()
            self.span = record_function(tracing.SLICE)
            self.span.__enter__()

    def after_call(self, i, n_pool):
        if (self.recorder.active and i % n_pool == 0
                and time.perf_counter() - self.t0 >= self.min_s):
            self.span.__exit__(None, None, None)
            self.recorder.active = False
            self.prof.__exit__(None, None, None)
            self.stage.enabled = False
            self.done = True

    def stage_totals(self):
        return {n: t - self.stage_before.get(n, 0.0)
                for n, t in self.stage.totals.items()}


def measure(call, inputs, pool, seconds, check, traced=None):
    """The measured window: calls back to back, round the pool, until the
    first call to end after `seconds` (and, in a traced run, the end of
    the slice).  check(k, call id, output) keeps each output."""
    from torch.profiler import record_function
    from benchmark.tracing import CALL
    window = Window(pool)
    i = 0
    while True:
        k = i % len(pool)
        if traced:
            traced.before_call(i, len(pool))
        t0 = time.perf_counter()
        try:
            with record_function(CALL):
                out = call(inputs[k])
            raised = False
        except Exception:
            raised = True
            traceback.print_exc(limit=4)
        t1 = time.perf_counter()
        c = window.add(k, t0, t1, raised)
        if not raised:
            check(k, c, out)
            del out
        i += 1
        if traced:
            traced.after_call(i, len(pool))
        if t1 - window.calls[0][1] >= seconds and (not traced
                                                   or traced.done):
            return window


class Checks:
    """The numbers compared.  In the window it only keeps each output; once
    the window has closed, `judge` reads the numbers of each distinct
    output of each pool file and sums them over the calls that gave it."""

    def __init__(self, fmt, config, op, pool, found=None):
        self.fmt, self.config, self.op, self.pool = fmt, config, op, pool
        self.limits = dict(fmt.LIMITS[op], failed_calls=0)
        self.found = {n: 0 for n in fmt.LIMITS[op]}
        self.found.update(found or {})
        self.kept = []                       # (pool index, call id, output)
        self.rejected = set()

    def __call__(self, k, c, out):
        self.kept.append((k, c, out))

    def judge(self):
        from benchmark.formats import same_bytes
        distinct = {k: [] for k in range(len(self.pool))}  # [(out, ids)]
        for k, c, out in self.kept:
            for o, ids in distinct[k]:
                if same_bytes(o, out):
                    ids.append(c)
                    break
            else:
                distinct[k].append((out, [c]))
        self.kept.clear()
        for k, outs in distinct.items():
            for o, ids in outs:
                nums = self.fmt.judge(self.config, self.op, self.pool[k], o)
                for n, v in nums.items():
                    self.found[n] += v
                if any(nums.values()):
                    self.rejected.update(ids)


def main(argv=None, process_start=None, device=None, overrides=None,
         config_overrides=None):
    """Run one cell; prints the result line and returns the exit code.
    `device` other than None skips the look for a card, and the
    overrides replace keys of the traffic mix and the configuration (the
    CPU tests' sizes)."""
    process_start = process_start or time.time()
    args = parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    traffic = dict(traffic, **(overrides or {}))
    config = dict(config, **(config_overrides or {}))
    if traffic['loop'] != 'closed' or traffic['callers'] != 1:
        raise SystemExit('only a closed loop with one caller is built')
    marks = [('start', process_start), ('harness', time.time())]
    import torch
    marks.append(('import torch', time.time()))
    if device is None:
        if not torch.cuda.is_available():
            print('no CUDA device: this benchmark measures the card',
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell['chips']:
            print('%d CUDA devices, the cell needs %d'
                  % (torch.cuda.device_count(), cell['chips']),
                  file=sys.stderr)
            return 2
        device = 'cuda'
        torch.zeros(1, device=device)                # the CUDA context
    marks.append(('card context', time.time()))
    fmt = importlib.import_module('benchmark.formats.' + config['format'])
    op = traffic['op']
    metrics = {m['name']: load_file_module('metrics', m['name'])
               for m in cell_metrics(bench, cell, args.trace)}

    corpus = tr.load_corpus(config['corpus'])
    pool = tr.make_pool(corpus, traffic, args.seed)
    marks.append(('pool', time.time()))
    import compressjs_tpu_torch  # noqa: F401  (the program under test)
    marks.append(('import program', time.time()))
    inputs = fmt.prepare(config, op, pool)
    marks.append(('inputs', time.time()))
    found_at_setup = (fmt.check_setup(config, op, corpus)
                      if hasattr(fmt, 'check_setup') else {})
    del corpus
    marks.append(('set-up checks', time.time()))
    from benchmark import tracing
    recorder = tracing.Recorder()
    block_span = fmt.BLOCK_SPAN[op]
    patched = []
    try:
        if args.trace:
            spans, byte_fns = [block_span], {}
            for name, mod in metrics.items():
                spans += getattr(mod, 'SPANS', [])
                for span, fn in getattr(mod, 'BYTES', {}).items():
                    byte_fns.setdefault(span, []).append((name, fn))
            patched += tracing.install(spans, recorder, byte_fns)
        call = fmt.entry(config, op, device)
        if args.fault:
            from benchmark import faults
            call, done = faults.install(args.fault, op, call)
            patched += done

        for x in inputs:                         # warm-up: every file once
            call(x)
        if device.startswith('cuda'):
            torch.cuda.synchronize()
        setup_s = time.time() - process_start
        marks.append(('warm-up', process_start + setup_s))
        checks = Checks(fmt, config, op, pool, found_at_setup)
        traced = (TracedSlice(recorder,
                              traffic.get('trace_min_s', TRACE_MIN_S))
                  if args.trace else None)
        use0 = resource.getrusage(resource.RUSAGE_SELF)
        window = measure(call, inputs, pool, args.seconds, checks, traced)
        use1 = resource.getrusage(resource.RUSAGE_SELF)
    finally:
        tracing.restore(patched)

    info = _device_info(torch, device, cell['chips'])
    del inputs
    if device.startswith('cuda'):
        torch.cuda.empty_cache()
    checks.judge()
    window.rejected = checks.rejected

    loaded = sorted(n for n in sys.modules if n.split('.')[0] in FORBIDDEN)
    if loaded:
        print('modules of JAX or the JAX package were loaded: %s'
              % ', '.join(loaded), file=sys.stderr)
        return 3

    run = Run(window, setup_s)
    line = {}
    if args.trace:
        run.slice = tracing.Slice(traced.prof, recorder,
                                  traced.stage_totals(), block_span,
                                  tr.load_json('.', 'peaks'))
        info['busy_s'] = run.slice.busy_s
        info['window_s'] = run.slice.window_s
        line['breakdown'] = run.slice.breakdown()
        print('trace: %d device ops, %.4f of their time matched to a '
              'host launch; %d blocks in the slice; the harness between '
              'calls %.6f s of %.6f'
              % (len(run.slice.ops), run.slice.matched_share,
                 run.slice.blocks, run.slice.between_calls_s,
                 run.slice.window_s), file=sys.stderr)
    values = {}
    for m in cell_metrics(bench, cell, args.trace):
        v = metrics[m['name']].read(run)
        if v is not None:
            values[m['name']] = {'value': v, 'unit': m['unit']}

    found = dict(checks.found,
                 failed_calls=sum(1 for c in window.calls if c[3]))
    correct = all(found[n] <= lim for n, lim in checks.limits.items())
    print('setup: ' + ', '.join('%s %.3f s' % (n, t - marks[i][1])
                                for i, (n, t) in enumerate(marks[1:])),
          file=sys.stderr)
    print('window: %d files in %.6f s (%d failed); setup %.6f s'
          % (len(window.calls), window.seconds, window.failed, setup_s),
          file=sys.stderr)
    print('window host: user %.3f s, system %.3f s, %d minor faults, %d '
          'involuntary switches'
          % (use1.ru_utime - use0.ru_utime, use1.ru_stime - use0.ru_stime,
             use1.ru_minflt - use0.ru_minflt,
             use1.ru_nivcsw - use0.ru_nivcsw), file=sys.stderr)
    for n, lim in checks.limits.items():
        print('check %s %s limit %s' % (n, found[n], lim), file=sys.stderr)
    line = dict({'correct': correct, 'attempted': len(window.calls),
                 'failed': window.failed, 'metrics': values, 'device': info},
                **line)
    line['checks'] = {n: {'value': found[n], 'limit': lim}
                      for n, lim in checks.limits.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
