"""What the per-layer readers take from the program's own tracer
(``compressjs_tpu_torch.parallel.profiling.stage_timer()``): host ms of
its stages a block, and its counters a block.

The harness diffs the stage totals over the traced slice
(`TracedSlice.stage_totals`) but not the counters, so the counters hold
the slice alone only where the timer was off until the slice began.
Where COMPRESSJS_TPU_TRACE=1 switched it on for the whole process they
hold the set-up and the warm-up too, and give no reading.  A program
whose timer has no counters gives none either."""

from __future__ import annotations

import os


def stage_ms_per_block(run, stages):
    """Host ms a block of the program's `stages` over the slice, or None
    where none was entered."""
    s = run.slice
    t = sum(s.stage_totals.get(n, 0.0) for n in stages)
    return 1e3 * t / s.blocks if s.blocks and t else None


def counters():
    """The program's counters over the slice, or None (see above)."""
    if os.environ.get('COMPRESSJS_TPU_TRACE') == '1':
        return None
    from compressjs_tpu_torch.parallel.profiling import stage_timer
    return getattr(stage_timer(), 'counters', None)


def count_per_block(run, names):
    """The sum of the program's counters `names` a block, or None where
    nothing was counted."""
    c = counters()
    n = sum(c.get(x, 0) for x in names) if c else 0
    return n / run.slice.blocks if run.slice.blocks and n else None
