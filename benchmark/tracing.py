"""The benchmark's own spans around the program's functions, and the
reduction of a profiled slice to the numbers the per-layer metrics read.

`install` wraps functions of the program, named ``module.attr``, in a
``torch.profiler.record_function`` span ``bench/<module.attr>``, in every
module of the program that holds them; the program is not edited.
`Slice` reduces a profiled slice: a device operation belongs to the
spans open on the host thread that launched it.  The traced run adds no
synchronisation of its own.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import re
import sys
import threading
import time
from collections import defaultdict

PROGRAM = 'compressjs_tpu_torch'
SPAN = 'bench/'
SLICE = SPAN + 'slice'
CALL = SPAN + 'call'
_WORD = re.compile(r'[A-Za-z_][A-Za-z_0-9]*')
HARNESS_GAP = 'host in the harness, between calls'


class Recorder:
    """Calls, host seconds and counted bytes of the wrapped functions,
    kept while `active` (the profiled slice)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.active = False
        self.calls = defaultdict(int)
        self.host_s = defaultdict(float)
        self.bytes = defaultdict(int)        # by metric name

    def add(self, name, seconds, counted):
        with self.lock:
            self.calls[name] += 1
            self.host_s[name] += seconds
            for metric, b in counted:
                self.bytes[metric] += b


def _wrap(name, f, recorder, byte_fns):
    from torch.profiler import record_function
    label = SPAN + name

    @functools.wraps(f)
    def spanned(*args, **kwargs):
        with record_function(label):
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            dt = time.perf_counter() - t0
        if recorder.active:
            recorder.add(name, dt, [(m, fn(args, kwargs, out))
                                    for m, fn in byte_fns])
        return out
    return spanned


def replace(f, g):
    """Put `g` in place of `f` in every module of the program that holds
    `f`; returns the (module, name, f) to put back."""
    done = []
    for mod in list(sys.modules.values()):
        if getattr(mod, '__name__', '').split('.')[0] != PROGRAM:
            continue
        for k, v in list(vars(mod).items()):
            if v is f:
                setattr(mod, k, g)
                done.append((mod, k, f))
    return done


def restore(done):
    for mod, k, f in done:
        setattr(mod, k, f)


def install(names, recorder, byte_fns):
    """Wrap each function in `names` (``module.attr`` of the program).
    byte_fns: {name: [(metric, fn(args, kwargs, result) -> bytes)]}.
    Returns what `restore` puts back."""
    done = []
    for name in sorted(set(names)):
        modname, attr = name.rsplit('.', 1)
        f = getattr(importlib.import_module(modname), attr)
        done += replace(f, _wrap(name, f, recorder, byte_fns.get(name, [])))
    return done


def profiler():
    """A profiler of the host's operations on every thread and of the
    card's."""
    from torch.profiler import ProfilerActivity, profile
    try:
        from torch._C._profiler import _ExperimentalConfig
        cfg = dict(experimental_config=_ExperimentalConfig(
            profile_all_threads=True))
    except (ImportError, TypeError):
        cfg = {}
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   **cfg)


def _union(intervals):
    """Sorted disjoint union of (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name, width=96):
    return name if len(name) <= width else name[:width - 3] + '...'


def _open_spans(spans, launches):
    """{correlation id: the names of the spans open on the launching
    thread at the launch}, by one sweep of each thread's span edges and
    launches in time order."""
    by_thread = defaultdict(list)
    for tid, s, e, name in spans:
        by_thread[tid] += [(s, 0, name), (e, 2, name)]
    for corr, (tid, t) in launches.items():
        by_thread[tid].append((t, 1, corr))
    out = {}
    for edges in by_thread.values():
        edges.sort(key=lambda x: (x[0], x[1]))
        now = defaultdict(int)
        for _, kind, x in edges:
            if kind == 0:
                now[x] += 1
            elif kind == 2:
                now[x] -= 1
            else:
                out[x] = frozenset(n for n, c in now.items() if c > 0)
    return out


def _idle_gaps(merged, t0, t1, spans):
    """(label, seconds) of each stretch with no device operation, labelled
    by the innermost span open on any host thread at its middle."""
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    opened = sorted((s, e, n) for _, s, e, n in spans
                    if n != SLICE[len(SPAN):])
    starts = [o[0] for o in opened]
    gaps = []
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        inner = [o for o in opened[:bisect.bisect_right(starts, mid)]
                 if o[1] >= mid]
        label = ('host in ' + inner[-1][2].replace(PROGRAM + '.', '')
                 if inner else HARNESS_GAP)
        gaps.append((label, (e - s) * 1e-9))
    return gaps


class Slice:
    """What a profiled slice shows, for the metric readers.  Times in
    seconds.

    window_s, busy_s: the slice's wall and the union of its device
    operations' intervals; n_kernels: kernels launched (copies and fills
    not counted); blocks: calls of the format's per-block function;
    stage_totals: the program's StageTimer totals over the slice.

    A device operation belongs to the spans open on the host thread at
    the moment of the CUDA runtime call that launched it (the profiler
    gives both the same correlation id).  That holds for the kernels the
    program launches through its C entries too, which no torch operation
    encloses."""

    def __init__(self, prof, recorder, stage_totals, block_span, peaks):
        from torch.autograd import DeviceType
        self.recorder = recorder
        self.stage_totals = dict(stage_totals)
        self.blocks = recorder.calls.get(block_span, 0)
        self.peaks = peaks
        spans, launches, dev = [], {}, []
        for e in prof.profiler.kineto_results.events():
            name, t = e.name(), e.start_ns()
            if e.device_type() == DeviceType.CPU:
                if name.startswith(SPAN):
                    spans.append((e.start_thread_id(), t,
                                  t + e.duration_ns(), name[len(SPAN):]))
                elif name.startswith('cu'):         # a CUDA runtime call
                    launches[e.correlation_id()] = (e.start_thread_id(), t)
            elif not name.startswith(SPAN):         # not a span's shadow
                dev.append((name, t, t + e.duration_ns(),
                            e.correlation_id()))
        sl = [(s, e) for _, s, e, n in spans if n == SLICE[len(SPAN):]]
        t0, t1 = sl[0] if sl else (min((d[1] for d in dev), default=0),
                                   max((d[2] for d in dev), default=0))
        self.window_s = (t1 - t0) * 1e-9
        opened = _open_spans(spans, launches)
        self.ops = []       # (name, start ns, end ns, spans open at launch)
        matched = 0
        for name, s, e, corr in dev:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            under = opened.get(corr)
            matched += (e - s) if under is not None else 0
            self.ops.append((name, s, e, under or frozenset()))
        merged = _union((s, e) for _, s, e, _ in self.ops)
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        total = sum(e - s for _, s, e, _ in self.ops)
        self.matched_share = matched / total if total else 0.0
        self.n_kernels = sum(1 for n, *_ in self.ops
                             if not n.startswith(('Memcpy', 'Memset')))
        self._gaps = _idle_gaps(merged, t0, t1, spans)
        # idle time while the harness, not a call, held the host
        self.between_calls_s = sum(g for n, g in self._gaps
                                   if n == HARNESS_GAP)

    # -- readers' helpers --------------------------------------------------

    def calls(self, name):
        return self.recorder.calls.get(name, 0)

    def host_s(self, name):
        return self.recorder.host_s.get(name, 0.0)

    def bytes(self, metric):
        return self.recorder.bytes.get(metric, 0)

    def device_s_under(self, *names):
        """Device seconds of the operations launched under any of the
        spans `names`."""
        return sum(e - s for _, s, e, under in self.ops
                   if under.intersection(names)) * 1e-9

    def kernel_s(self, *kernels):
        """Device seconds of the kernels whose name holds one of
        `kernels` as a whole word."""
        def named(n):
            return not set(kernels).isdisjoint(_WORD.findall(n))
        return sum(e - s for n, s, e, _ in self.ops if named(n)) * 1e-9

    def breakdown(self):
        by_name = defaultdict(float)
        for n, s, e, _ in self.ops:
            by_name[_short(n)] += (e - s) * 1e-9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self._gaps, key=lambda g: -g[1])[:10]
        return {'device_ops': [[n, s] for n, s in top],
                'idle_gaps': [[n, s] for n, s in gaps]}
