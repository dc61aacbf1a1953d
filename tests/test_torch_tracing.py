"""The port's own tracer, `parallel.profiling.StageTimer`: its stages and
counters, the stages and counters of the five benchmarked entry points
(``compress_file_device``, ``decompress_file_device``,
``bwtcl_decompress_device``, ``bwtcp_compress_device`` and
``bwtcl_compress_device``), and the benchmark's readers of them.  The
names and counts held here are the ones README lists."""

import bz2
import json
import os
import subprocess
import sys
import threading
import time
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bwtcl as hbwtcl
from compressjs_tpu_torch.host import bwtcp as hbwtcp
from compressjs_tpu_torch.host import bzip2_parse as bp
from compressjs_tpu_torch.ops import device_entropy
from compressjs_tpu_torch import tracer
from compressjs_tpu_torch.parallel import pipeline, profiling
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'golden')

# the top-level stages on each entry point's calling thread: together
# they cover the call
TOP = {
    'encode': {'encode.split', 'encode.queue', 'device wait+fetch',
               'host header stage', 'encode.write'},
    'decode': {'decode.scan', 'decode.parse', 'decode.launch',
               'decode.wait', 'decode.retry', 'decode.inverse',
               'decode.download', 'decode.crc', 'decode.join'},
    'bwtcl': {'bwtcl.container', 'bwtcl.header', 'bwtcl.stage',
              'bwtcl.launch', 'bwtcl.wait', 'bwtcl.host_block',
              'bwtcl.write'},
    'bwtcp': {'bwtcp.split', 'bwtcp.group', 'bwtcp.host_block',
              'bwtcp.wait', 'bwtcp.write'},
    'bwtcl_enc': {'bwtcl_enc.split', 'bwtcl_enc.head', 'bwtcl_enc.launch',
                  'bwtcl_enc.fetch', 'bwtcl_enc.host_block',
                  'bwtcl_enc.write'},
}


@pytest.fixture(scope='module')
def sample5():
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        return bz2.decompress(f.read())


@pytest.fixture
def timer(monkeypatch):
    """A fresh process timer, on, in place of `stage_timer()`'s."""
    t = profiling.StageTimer(enabled=True)
    monkeypatch.setattr(tracer, '_global_timer', t)
    return t


def _span_events(prof):
    """[(name, start ns, end ns, thread)] of the compressjs/ ranges."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(profiling.SPAN_PREFIX)]


def _timed_call(f):
    t0 = time.perf_counter()
    out = f()
    return out, time.perf_counter() - t0


def _covers(timer, kind, wall):
    """Share of the call's wall under the calling thread's top stages."""
    return sum(t for n, t in timer.totals.items() if n in TOP[kind]) / wall


# -- the tracer ---------------------------------------------------------------

def test_disabled_stage_is_one_shared_noop():
    t = profiling.StageTimer(enabled=False)
    s = t.stage('a')
    assert s is t.stage('b', 3)
    assert not hasattr(s, '__next__')          # not a generator
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.stage('a'):
            with t.stage('b', 1):
                torch.arange(10).sum()
        t.add('c', 5)
    assert _span_events(prof) == []
    assert not t.totals and not t.counts and not t.counters


def test_disabled_stage_allocates_nothing():
    t = profiling.StageTimer(enabled=False)

    def entries():
        for i in range(10000):
            with t.stage('x', i):
                t.add('c')

    entries()
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        entries()
        grown = tracemalloc.get_traced_memory()[0] - before
    finally:
        tracemalloc.stop()
    assert grown < 1000              # 10,000 entries; one object each: 480 kB


def test_enabled_stages_are_nested_profiler_ranges():
    t = profiling.StageTimer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.stage('outer', 7):
            with t.stage('inner'):
                torch.arange(10).sum()
            with t.stage('inner'):
                pass
    ev = sorted(_span_events(prof), key=lambda e: e[1])
    assert [e[0] for e in ev] == ['compressjs/outer', 'compressjs/inner',
                                  'compressjs/inner']
    _, s0, e0, th = ev[0]
    for _, s, e, th1 in ev[1:]:
        assert s0 <= s <= e <= e0 and th1 == th
    assert ev[1][2] <= ev[2][1]
    assert dict(t.counts) == {'outer': 1, 'inner': 2}
    assert t.totals['outer'] >= t.totals['inner'] > 0


def test_block_index_is_a_range_argument(tmp_path):
    """Where the profiler records its ranges' inputs (record_shapes)."""
    t = profiling.StageTimer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with t.stage('encode.device', 12):
            pass
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    args = [e.get('args', {}) for e in events
            if e.get('name') == 'compressjs/encode.device']
    assert len(args) == 1 and args[0]['block'] == 12


def test_threads_leave_exact_counts():
    """More threads than cores, with a short switch interval, each making
    10,000 stage entries and counter adds on one timer."""
    t = profiling.StageTimer(enabled=True)
    n_threads, n = (os.cpu_count() or 2) + 2, 10000

    def work():
        for _ in range(n):
            with t.stage('s'):
                t.add('c')
            t.add('d', 2)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert t.counts['s'] == n_threads * n
    assert t.counters == {'c': n_threads * n, 'd': 2 * n_threads * n}


def test_report_prints_counters(capsys):
    t = profiling.StageTimer(enabled=True)
    with t.stage('a'):
        pass
    t.add('host_syncs', 3)
    t.report()
    err = capsys.readouterr().err
    assert 'stage timing' in err and 'host_syncs' in err and ' 3' in err


def test_device_trace_turns_the_timer_on(tmp_path, timer):
    timer.enabled = False
    with profiling.device_trace(str(tmp_path)):
        assert timer.enabled
        with timer.stage('traced'):
            torch.arange(1000).sum()
    assert not timer.enabled
    assert timer.counts['traced'] == 1
    with open(tmp_path / 'trace.json') as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'compressjs/traced' in names


# -- the entry points' stages and counters ------------------------------------

def test_encode_stages_and_counters(sample5, timer, monkeypatch):
    """Two level-1 blocks.  Per block: the host's stages (the split's
    last entry finds the input's end), the worker's `encode.device` with
    its upload, ops stages and downloads; host_syncs 14 + twice the
    sort's rounds + the group optimisation's refinement rounds; each
    block queued once, the second while the first may still run."""
    builds = []

    def counted(freqs, m, err):
        builds.append(1)
        return build(freqs, m, err)

    build = device_entropy.code_lengths_batch
    monkeypatch.setattr(device_entropy, 'code_lengths_batch', counted)
    data = sample5[:150000]
    out, wall = _timed_call(lambda: cz.compress_file_device(
        data, level=1, device='cpu'))
    assert bz2.decompress(out) == data
    B = 2
    assert dict(timer.counts) == {
        'encode.split': B + 1, 'encode.queue': B, 'device wait+fetch': B,
        'host header stage': B, 'encode.write': B + 2,
        'encode.device': B, 'encode.upload': B, 'encode.wait': B,
        'ops.bwt_block': B, 'ops.mtf_encode': B,
        'ops.optimize_groups_dev': B, 'ops.payload_pack_words_dev': B}
    rounds = timer.counters['sort_rounds']
    # a block of 2,400 symbols or more: one table build from the block's
    # frequencies, four greedy splits, then one a refinement round
    refine = len(builds) - 5 * B
    assert rounds >= B and B <= refine <= 4 * B
    assert timer.counters['host_syncs'] == 14 * B + 2 * rounds + refine
    assert timer.counters['encode_submits'] == B
    assert timer.counters['encode_submits_busy'] <= B - 1
    assert set(timer.counters) == {'sort_rounds', 'host_syncs',
                                   'encode_submits', 'encode_submits_busy'}
    assert _covers(timer, 'encode', wall) > 0.9


def _planted_block_magic(monkeypatch, positions):
    scan = bp._scan_magic

    def planted(data, pattern):
        extra = positions if pattern is bp.MAGIC_BYTES else []
        return np.sort(np.concatenate(
            [scan(data, pattern), np.asarray(extra, dtype=np.int64)]))

    monkeypatch.setattr(bp, '_scan_magic', planted)


def test_decode_stages_and_counters(sample5, timer):
    """Two blocks of a stdlib stream: a launch, a read-back, an inverse
    and a download each; host_syncs 8 a launch and 5 a block."""
    data = sample5[:150000]
    out, wall = _timed_call(lambda: cz.decompress_file_device(
        bz2.compress(data, 1), device='cpu'))
    assert out == data
    B = 2
    assert dict(timer.counts) == {
        'decode.scan': 1, 'decode.parse': B, 'decode.launch': B,
        'ops.huffman_walk_dev': B, 'ops.compose_windowed': 7 * B,
        'decode.wait': B, 'decode.inverse': B, 'decode.download': B,
        'decode.crc': B + 1, 'decode.join': 1}
    assert dict(timer.counters) == {
        'candidates_launched': B, 'candidates_accepted': B,
        'host_syncs': 8 * B + 5 * B}
    assert _covers(timer, 'decode', wall) > 0.9


def test_decode_retry_counts_as_a_launch(timer, monkeypatch):
    """A false block magic 5,000 bits into block 0: block 0's first
    launch, bounded by it, fails and is launched again to the wider
    bound; the false candidate parses no header, first or on retry."""
    rng = np.random.default_rng(0)
    data = rng.choice(np.frombuffer(b'abcd', np.uint8), 150000).tobytes()
    comp = bz2.compress(data, 1)
    blocks = bp._scan_magic(np.frombuffer(comp, np.uint8), bp.MAGIC_BYTES)
    _planted_block_magic(monkeypatch, [int(blocks[0]) + 5000])
    assert cz.decompress_file_device(comp, device='cpu') == data
    assert len(blocks) == 2
    assert timer.counts['decode.retry'] == 2
    assert timer.counts['decode.parse'] == 5
    assert dict(timer.counters) == {
        'candidates_launched': 3, 'candidates_accepted': 2,
        'host_syncs': 8 * 3 + 5 * 2}


def test_bwtcl_decode_stages_and_counters(sample5, timer):
    """One level-1 block on the device path and the tail on the host:
    host_syncs 6 a device block here (the card's Fenwick decode reads its
    error flag too: 7 there)."""
    data = sample5[:120000]
    comp = bytes(hbwtcl.BWTCL.compress_file(data, None, 1))
    out, wall = _timed_call(lambda: cz.bwtcl_decompress_device(
        comp, device='cpu'))
    assert bytes(out) == data
    assert dict(timer.counts) == {
        'bwtcl.container': 1, 'bwtcl.header': 2, 'bwtcl.stage': 1,
        'bwtcl.launch': 1, 'ops.fenwick_decode_streams': 1,
        'bwtcl.wait': 1, 'bwtcl.host_block': 1, 'bwtcl.write': 1}
    assert dict(timer.counters) == {'host_syncs': 6}
    assert _covers(timer, 'bwtcl', wall) > 0.9


def test_bwtcp_encode_stages_and_counters(timer):
    """Three level-6 blocks, two to a dispatch, and a 50,000-byte tail:
    G = 2 dispatches, D = 3 card blocks, H = 1 host block.  host_syncs 7
    a card block + 2 x sort_rounds + 5 a dispatch here (the card's fused
    kernel reads its error flag too: 6 there).  Each dispatch's coder is
    a job of the worker thread, collected once in `bwtcp.wait`; a job
    still running then counts in coder_waits.  A short pattern repeated
    keeps the plain Fenwick model and coder to ~900 steps a block."""
    rng = np.random.default_rng(5)
    pat = rng.integers(97, 123, 64, dtype=np.uint8).tobytes()
    data = (pat * 30_000)[:1_850_000]
    out, wall = _timed_call(lambda: cz.bwtcp_compress_device(
        data, None, 6, batch=2, device='cpu'))
    assert bytes(out) == bytes(hbwtcp.BWTCP.compress_file(data, None, 6))
    G, D, H = 2, 3, 1
    assert dict(timer.counts) == {
        'bwtcp.split': 1, 'bwtcp.group': G, 'bwtcp.head': D,
        'ops.bwt_eof_block': D, 'ops.mtf_encode': D,
        'ops.fenwick_code_streams': G, 'bwtcp.fetch': G,
        'bwtcp.host_block': H, 'bwtcp.wait': G, 'bwtcp.write': 1}
    rounds = timer.counters['sort_rounds']
    waits = timer.counters.get('coder_waits', 0)
    assert rounds >= D and 0 <= waits <= G
    assert {k: v for k, v in timer.counters.items()
            if k != 'coder_waits'} == {
        'sort_rounds': rounds, 'host_syncs': 7 * D + 2 * rounds + 5 * G,
        'coder_dispatches': G}
    assert _covers(timer, 'bwtcp', wall) > 0.9


def test_bwtcl_encode_stages_and_counters(sample5, timer):
    """Level-1 blocks: two of text on the card (G = 2), then a full block
    of one byte, whose RLE2 symbols are fewer than the lanes, and the
    tail on the host (H = 2).  A full block is headed, launched and read
    back whatever its route.  host_syncs 12 a card block and 10 a full
    block that takes the host after its launch, + 2 x sort_rounds, here
    (the card's fused kernel reads its error flag too: 13 and 11
    there)."""
    data = sample5[:200_000] + b'q' * 100_000 + sample5[200_000:250_000]
    out, wall = _timed_call(lambda: cz.bwtcl_compress_device(
        data, None, 1, device='cpu'))
    assert bytes(out) == bytes(hbwtcl.BWTCL.compress_file(data, None, 1))
    assert pipeline.bwtcl_compress_device.last_stats == {
        'device_blocks': 2, 'host_blocks': 2, 'overflow_blocks': 0}
    G, F, H = 2, 3, 2                  # card blocks, full blocks, host blocks
    assert dict(timer.counts) == {
        'bwtcl_enc.split': 1, 'bwtcl_enc.head': F, 'bwtcl_enc.launch': F,
        'ops.bwt_eof_block': F, 'ops.mtf_encode': F,
        'ops.fenwick_code_streams': F, 'bwtcl_enc.fetch': F,
        'bwtcl_enc.host_block': H, 'bwtcl_enc.write': 1}
    rounds = timer.counters['sort_rounds']
    assert rounds >= F
    assert dict(timer.counters) == {
        'sort_rounds': rounds,
        'host_syncs': 12 * G + 10 * (F - G) + 2 * rounds}
    assert _covers(timer, 'bwtcl_enc', wall) > 0.9


def test_entry_points_record_nothing_while_off(sample5, monkeypatch):
    t = profiling.StageTimer(enabled=False)
    monkeypatch.setattr(tracer, '_global_timer', t)
    data = sample5[:20000]
    assert cz.decompress_file_device(cz.compress_file_device(
        data, level=1, device='cpu'), device='cpu') == data
    assert not t.totals and not t.counts and not t.counters


# -- the benchmark's readers --------------------------------------------------

def _reader(name):
    sys.path.insert(0, ROOT)
    try:
        from benchmark import harness
    finally:
        sys.path.remove(ROOT)
    return harness.load_file_module('metrics', name)


def _run(stage_totals, blocks):
    return types.SimpleNamespace(slice=types.SimpleNamespace(
        stage_totals=stage_totals, blocks=blocks))


@pytest.mark.parametrize('name,totals,want', [
    ('host_split_ms_per_block.encode', {'encode.split': 0.8}, 200.0),
    ('host_write_ms_per_block.encode',
     {'encode.write': 0.2, 'encode.split': 9.0}, 50.0),
    ('host_scan_ms_per_block.decode', {'decode.scan': 0.04}, 10.0),
    ('host_finish_ms_per_block.decode',
     {'decode.crc': 0.1, 'decode.join': 0.02, 'decode.scan': 5}, 30.0),
    ('host_container_ms_per_block.bwtcl',
     {'bwtcl.container': 0.004, 'bwtcl.header': 0.002,
      'bwtcl.stage': 0.006, 'bwtcl.launch': 1.0}, 3.0),
    ('host_route_ms_per_block.bwtcl', {'bwtcl.host_block': 0.12}, 30.0),
    ('host_head_ms_per_block.bwtcp',
     {'bwtcp.head': 0.008, 'bwtcp.group': 2.0}, 2.0),
    ('host_fetch_ms_per_block.bwtcl_enc',
     {'bwtcl_enc.fetch': 0.006, 'bwtcl_enc.launch': 2.0}, 1.5),
    ('host_head_ms_per_block.bwtcl_enc',
     {'bwtcl_enc.head': 0.002, 'bwtcl_enc.fetch': 2.0}, 0.5),
])
def test_stage_readers(name, totals, want):
    read = _reader(name).read
    assert read(_run(totals, 4)) == pytest.approx(want)
    assert read(_run({'other': 1.0}, 4)) is None
    assert read(_run(totals, 0)) is None


@pytest.mark.parametrize('name,counters,want', [
    ('sort_rounds_per_block.encode', {'sort_rounds': 12}, 3.0),
    ('syncs_per_block.encode', {'host_syncs': 100, 'sort_rounds': 1}, 25.0),
    ('syncs_per_block.decode', {'host_syncs': 14}, 3.5),
    ('syncs_per_block.bwtcp', {'host_syncs': 130, 'sort_rounds': 9}, 32.5),
    ('syncs_per_block.bwtcl_enc', {'host_syncs': 74, 'sort_rounds': 12},
     18.5),
    ('candidate_yield.decode',
     {'candidates_launched': 5, 'candidates_accepted': 4}, 80.0),
    ('coder_hidden_pct.bwtcp', {'coder_dispatches': 14, 'coder_waits': 1},
     100.0 * 13 / 14),
    ('split_hidden_pct.encode',
     {'encode_submits': 112, 'encode_submits_busy': 111}, 100.0 * 111 / 112),
])
def test_counter_readers(name, counters, want, timer):
    read = _reader(name).read
    run = _run({}, 4)
    assert read(run) is None                          # nothing counted
    timer.counters.update(counters)
    assert read(run) == pytest.approx(want)


def test_counter_readers_read_nothing_from_an_older_timer(monkeypatch):
    """A program whose timer has no counters (the commit before them)."""
    monkeypatch.setattr(tracer, '_global_timer', types.SimpleNamespace())
    for name in ('sort_rounds_per_block.encode', 'syncs_per_block.encode',
                 'syncs_per_block.decode', 'candidate_yield.decode',
                 'coder_hidden_pct.bwtcp', 'syncs_per_block.bwtcl_enc',
                 'split_hidden_pct.encode'):
        assert _reader(name).read(_run({}, 4)) is None


def test_counter_readers_read_nothing_when_the_environment_traced(
        timer, monkeypatch):
    """COMPRESSJS_TPU_TRACE=1 keeps the timer on from the start, so its
    counters hold more than the slice: no reading."""
    timer.counters.update({'sort_rounds': 12, 'host_syncs': 100,
                           'candidates_launched': 5,
                           'candidates_accepted': 4})
    monkeypatch.setenv('COMPRESSJS_TPU_TRACE', '1')
    for name in ('sort_rounds_per_block.encode', 'syncs_per_block.encode',
                 'syncs_per_block.decode', 'candidate_yield.decode'):
        assert _reader(name).read(_run({}, 4)) is None
    monkeypatch.setenv('COMPRESSJS_TPU_TRACE', '0')
    assert _reader('syncs_per_block.decode').read(_run({}, 4)) == 25.0


class _DeviceSlice:
    """What the device readers take from a traced slice: 4 blocks, 2.5 s
    of wall, 1.5 s busy, 300 kernels, 0.02 s under the lane coder's three
    spans (0.01 under each other span)."""
    blocks, window_s, busy_s, n_kernels = 4, 2.5, 1.5, 300
    LANE = {'compressjs_tpu_torch.ops.device_model.fenwick_code_streams',
            'compressjs_tpu_torch.ops.device_coder.token_bytes',
            'compressjs_tpu_torch.ops.device_lane.ragged_concat'}

    def device_s_under(self, *names):
        return 0.02 if set(names) == self.LANE else 0.01


@pytest.mark.parametrize('name,want', [
    ('lane_code_ms_per_block.bwtcl_enc', 5.0),
    ('launches_per_block.bwtcl_enc', 75.0),
    ('device_idle_pct.bwtcl_enc', 40.0),
    ('launches_per_block.bwtcp', 75.0),
    ('device_idle_pct.bwtcp', 40.0),
])
def test_device_readers(name, want):
    """Each reader on a slice that has its operations, and on one where no
    block or no device operation was seen (a CPU run's): no reading."""
    read = _reader(name).read
    s = _DeviceSlice()
    assert read(types.SimpleNamespace(slice=s)) == pytest.approx(want)
    s.blocks = s.busy_s = s.n_kernels = 0
    s.device_s_under = lambda *names: 0.0
    assert read(types.SimpleNamespace(slice=s)) is None


# the harness refuses to run in a process that has loaded JAX, as this
# one has (conftest.py): its traced run goes to a child process
_TRACED = '''
import sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
sys.exit(harness.main(['--workload', sys.argv[2], '--seed', '3000000019',
                       '--seconds', '0.1', '--trace', '1'], device='cpu',
                      overrides={'ladder_bytes': [3000], 'pool_passes': 1,
                                 'trace_min_s': 0}))
'''


@pytest.mark.parametrize('workload,names,zero', [
    ('bzip2-9.files-encode',
     ['host_wait_share.encode', 'host_split_ms_per_block.encode',
      'host_write_ms_per_block.encode', 'sort_rounds_per_block.encode',
      'syncs_per_block.encode'], ['split_hidden_pct.encode']),
    ('bzip2-9.files-decode',
     ['host_parse_ms_per_block', 'host_scan_ms_per_block.decode',
      'host_finish_ms_per_block.decode', 'candidate_yield.decode',
      'syncs_per_block.decode'], []),
])
def test_traced_cpu_run_reports_the_program_metrics(workload, names, zero):
    """The harness's traced run on the CPU (the device metrics read
    nothing there) reports each metric read from the program's tracer;
    those in `zero` read 0 on its one-block files (a first block has no
    block before it to hide behind)."""
    env = dict(os.environ)
    env.pop('COMPRESSJS_TPU_TRACE', None)
    r = subprocess.run([sys.executable, '-c', _TRACED, ROOT, workload],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line['correct'] is True
    assert sorted(line['metrics']) == sorted(names + zero)
    assert all(line['metrics'][n]['value'] > 0 for n in names)
    assert all(line['metrics'][n]['value'] == 0 for n in zero)
