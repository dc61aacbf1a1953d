"""The BWTC-L encode cell, ``bwtcl-9.files-encode``, on the CPU: the
port's entry ``bwtcl_compress_device`` with each kernel's plain version
against the host codec and the benchmark's plain reference decoder, its
format module ``benchmark/formats/bwtcl_encode.py``, and the harness's
runs of the cell at a small size, sound and with each control."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bwtcl as hbwtcl
from compressjs_tpu_torch.parallel import pipeline
from benchmark import traffic as tr
from benchmark.reference import bwtc as ref
from tests import _cpu_share

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = 'bwtcl-9.files-encode'
CONFIG = 'bwtcl-9-wikitext-encode'


@pytest.fixture(scope='module')
def corpus():
    return tr.load_corpus('data/sample5_bzip2_9.bz2')


def _input(kind, corpus):
    """Level-1 inputs (100,000-byte blocks) and their routes: (data,
    last_stats)."""
    rng = np.random.default_rng(7)
    if kind == 'blocks_and_tail':
        return corpus[:340_000], (3, 1, 0)
    if kind == 'fewer_symbols_than_lanes':
        # a run of one byte: ~20 RLE2 symbols for 128 lanes
        return corpus[:100_000] + b'q' * 100_000 + corpus[:7], (1, 2, 0)
    if kind == 'all_256':
        data = rng.permutation(np.tile(np.arange(256, dtype=np.uint8), 400))
        return data[:100_000].tobytes() + corpus[:20_000], (1, 1, 0)
    raise ValueError(kind)


@pytest.mark.parametrize('kind', ['blocks_and_tail',
                                  'fewer_symbols_than_lanes', 'all_256'])
def test_device_encode_is_the_host_codec_and_decodes(kind, corpus):
    data, routes = _input(kind, corpus)
    out = bytes(cz.bwtcl_compress_device(data, None, 1, device='cpu'))
    stats = pipeline.bwtcl_compress_device.last_stats
    assert (stats['device_blocks'], stats['host_blocks'],
            stats['overflow_blocks']) == routes
    assert out == bytes(hbwtcl.BWTCL.compress_file(data, None, 1))
    d = ref.decode_bwtcl(out)
    assert d.data == data and d.level == 1


# -- the format module --------------------------------------------------------

@pytest.fixture
def fmt(monkeypatch):
    from benchmark.formats import bwtcl_encode
    monkeypatch.setattr(bwtcl_encode, 'JUDGE_WORKERS', 1)
    monkeypatch.setattr(bwtcl_encode, '_offcard', [0])
    return bwtcl_encode


def test_format_holds_the_card_encode_to_the_golden(fmt, corpus):
    """The golden piece (one 900,000-byte block and a tail) through the
    entry, and another piece, whose stream differs."""
    config = tr.load_json('configs', CONFIG)
    assert fmt.check_setup(config, 'encode', corpus) == {'golden_differs': 0}
    other = dict(config, golden=dict(config['golden'], piece_bytes=500_000))
    assert fmt.check_setup(other, 'encode', corpus) == {'golden_differs': 1}
    assert fmt._offcard == [0]


def test_format_judges_each_output(fmt, corpus):
    config = dict(tr.load_json('configs', CONFIG), level=1)
    data = corpus[:150_000]
    file = {'data': data}
    s = bytes(hbwtcl.BWTCL.compress_file(data, None, 1))
    sound = {'format_errors': 0, 'files_differing': 0, 'golden_differs': 0,
             'offcard_blocks': 0}
    assert fmt.judge(config, 'encode', file, s) == sound
    b = bytearray(s)
    b[len(b) // 2] ^= 0x01
    got = fmt.judge(config, 'encode', file, bytes(b))
    assert got['files_differing'] == 1 and got['format_errors'] in (0, 1)
    assert fmt.judge(config, 'encode', file, data)['format_errors'] == 1
    other = bytes(hbwtcl.BWTCL.compress_file(data, None, 2))
    assert fmt.judge(config, 'encode', file, other) == dict(
        sound, format_errors=1)


def test_format_counts_full_blocks_off_the_card(fmt, corpus):
    """A full block of fewer RLE2 symbols than lanes takes the host codec:
    the first judge after the calls counts it, once."""
    config = dict(tr.load_json('configs', CONFIG), level=1)
    data = corpus[:100_000] + b'q' * 100_000
    out = fmt.entry(config, 'encode', 'cpu')(data)
    assert pipeline.bwtcl_compress_device.last_stats == {
        'device_blocks': 1, 'host_blocks': 1, 'overflow_blocks': 0}
    got = fmt.judge(config, 'encode', {'data': data}, out)
    assert got['offcard_blocks'] == 1 and got['files_differing'] == 0
    assert fmt.judge(config, 'encode', {'data': data}, out)[
        'offcard_blocks'] == 0


# -- the harness --------------------------------------------------------------

# the harness refuses to run in a process that has loaded JAX, as this
# one has (conftest.py): its runs go to one child process, which prints
# one result line a run, in the order of RUNS
_RUNS = '''
import json, sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
for fault, trace in json.loads(sys.argv[2]):
    argv = ['--workload', sys.argv[3], '--seed', '3000000019', '--seconds',
            '0.1', '--trace', str(trace)]
    if fault:
        argv += ['--fault', fault]
    rc = harness.main(argv, device='cpu', overrides={
        'ladder_bytes': [100000], 'pool_passes': 1, 'trace_min_s': 0},
        config_overrides={'level': 1})
    print('RC', rc, flush=True)
'''
RUNS = [(None, 0), (None, 1), ('byte_altered', 0), ('half_blocks', 0),
        ('unchanged', 0)]


@pytest.fixture(scope='module')
def harness_lines():
    """{(fault, trace): the run's result line}."""
    env = dict(os.environ, OMP_NUM_THREADS=str(_cpu_share.share()))
    env.pop('COMPRESSJS_TPU_TRACE', None)
    r = subprocess.run([sys.executable, '-c', _RUNS, ROOT, json.dumps(RUNS),
                        CELL], capture_output=True, text=True, timeout=900,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert lines[1::2] == ['RC 0'] * len(RUNS), r.stderr[-3000:]
    return {run: json.loads(line) for run, line in zip(RUNS, lines[::2])}


def _bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def _names(group):
    return sorted(m['name'] for m in _bench()[group]
                  if CELL in m.get('workloads', [CELL]))


def test_sound_run_is_correct(harness_lines):
    line = harness_lines[(None, 0)]
    assert line['correct'] is True and line['failed'] == 0
    assert line['attempted'] >= 1
    assert {n: c['value'] for n, c in line['checks'].items()} == {
        'format_errors': 0, 'files_differing': 0, 'golden_differs': 0,
        'offcard_blocks': 0, 'failed_calls': 0}
    assert sorted(line['metrics']) == _names('end_to_end')
    assert all(v['value'] > 0 for v in line['metrics'].values())


def test_traced_run_reports_the_program_metrics(harness_lines):
    """On the CPU the device metrics read nothing; the program's stages
    and counters do."""
    line = harness_lines[(None, 1)]
    assert line['correct'] is True
    program = ['host_fetch_ms_per_block.bwtcl_enc',
               'host_head_ms_per_block.bwtcl_enc',
               'syncs_per_block.bwtcl_enc']
    assert set(program) <= set(_names('per_layer'))
    assert sorted(line['metrics']) == program
    assert all(line['metrics'][n]['value'] > 0 for n in program)


@pytest.mark.parametrize('fault', ['byte_altered', 'half_blocks',
                                   'unchanged'])
def test_broken_paths_read_not_correct(harness_lines, fault):
    line = harness_lines[(fault, 0)]
    assert line['correct'] is False
    assert line['failed'] == line['attempted']
