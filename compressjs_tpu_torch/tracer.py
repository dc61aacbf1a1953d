"""The port's stage timer: host seconds and entries of the entry points'
named stages, integer counters, and a ``compressjs/<name>`` range on
``torch.profiler``'s host timeline for each stage entry while it is on.

This module imports nothing of the package, so that every layer (the
kernels' wrappers in ``ops`` as well as the entry points in ``parallel``)
may record into it.  ``parallel.profiling`` re-exports its names; README
lists the stage and counter names.
"""

from __future__ import annotations

import functools
import os
import sys
import threading
import time
from collections import defaultdict

from torch._C._profiler import _RecordFunctionFast

SPAN_PREFIX = 'compressjs/'


class _Off:
    """What `StageTimer.stage` returns while the timer is off: one shared
    context that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Stage:
    """One entry of a stage while the timer is on: its host seconds, and
    a profiler range named ``compressjs/<name>`` (with the block index,
    where there is one, in its arguments).

    The range is ``torch``'s `_RecordFunctionFast`, not
    `record_function`: a `record_function` range is a user scope, which
    the profiler also copies onto the card's timeline around the kernels
    launched inside it (a ``gpu_user_annotation``), where a reader of the
    trace takes it for device work.  This range stays on the host's
    timeline, and costs nothing unless a profiler runs."""

    __slots__ = ('timer', 'name', 'block', 'span', 't0')

    def __init__(self, timer, name, block):
        self.timer, self.name, self.block = timer, name, block

    def __enter__(self):
        self.span = (_RecordFunctionFast(SPAN_PREFIX + self.name)
                     if self.block is None else
                     _RecordFunctionFast(SPAN_PREFIX + self.name, (),
                                         {'block': self.block}))
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.span.__exit__(*exc)
        self.timer._record(self.name, dt)
        return False


class StageTimer:
    """Host seconds (`totals`) and entries (`counts`) by stage name, and
    integer `counters`; off unless `enabled` or COMPRESSJS_TPU_TRACE=1.
    Any thread may enter stages and add to counters."""

    def __init__(self, enabled=None):
        if enabled is None:
            enabled = os.environ.get('COMPRESSJS_TPU_TRACE') == '1'
        self.enabled = enabled
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = defaultdict(int)
        self._lock = threading.Lock()

    def stage(self, name, block=None):
        """A context that times one entry of stage `name` (`block`: the
        index of the block it serves, shown on its profiler range).  While
        the timer is off it is one shared no-op."""
        if not self.enabled:
            return _OFF
        return _Stage(self, name, block)

    def _record(self, name, seconds):
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def add(self, name, n=1):
        """Add `n` to counter `name`, while the timer is on."""
        if self.enabled:
            with self._lock:
                self.counters[name] += n

    def report(self, out=None):
        if not self.enabled or not (self.totals or self.counters):
            return
        out = out or sys.stderr
        with self._lock:
            totals = dict(self.totals)
            counts = dict(self.counts)
            counters = dict(self.counters)
        total = sum(totals.values()) or 1.0
        print('# stage timing:', file=out)
        for name, t in sorted(totals.items(), key=lambda kv: -kv[1]):
            print('#   %-28s %8.3fs  x%-5d (%4.1f%%)'
                  % (name, t, counts[name], 100 * t / total), file=out)
        for name, n in sorted(counters.items()):
            print('#   %-28s %8d' % (name, n), file=out)


_global_timer = None


def stage_timer():
    global _global_timer
    if _global_timer is None:
        _global_timer = StageTimer()
    return _global_timer


def staged(name):
    """Decorator: each call of the function is one entry of stage `name`
    of `stage_timer()`."""
    def wrap(f):
        @functools.wraps(f)
        def staged_call(*args, **kwargs):
            with stage_timer().stage(name):
                return f(*args, **kwargs)
        return staged_call
    return wrap
