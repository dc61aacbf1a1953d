"""CPU tests of the benchmark's yardstick: the traffic generator, the
window's arithmetic, the roofline counts, the plain reference, and the
harness's runs on the CPU with the timed path sound and broken.

    python -m pytest benchmark/

The test marked ``cuda`` runs every cell briefly on a card and skips
without one."""

from __future__ import annotations

import bz2
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, traffic as tr
from benchmark.reference import bzip2 as ref

ROOT = harness.ROOT
GOLDEN = os.path.join(ROOT, 'tests', 'golden')
TINY = {'ladder_bytes': [3000, 9000], 'pool_passes': 1}


def _bench():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as f:
        return json.load(f)


def _run(capsys, workload, seed=3_000_000_019, trace=0, fault=None,
         overrides=TINY, config_overrides=None, seconds=0.3):
    argv = ['--workload', workload, '--seed', str(seed), '--seconds',
            str(seconds), '--trace', str(trace)]
    if fault:
        argv += ['--fault', fault]
    rc = harness.main(argv, device='cpu', overrides=overrides,
                      config_overrides=config_overrides)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


# -- traffic ------------------------------------------------------------------

@pytest.mark.parametrize('name', ['enwik8-encode', 'enwik8-decode'])
def test_pool_is_a_function_of_the_seed(name):
    corpus = tr.load_corpus('data/sample5_bzip2_9.bz2')
    mix = tr.load_json('traffic', name)
    a = tr.make_pool(corpus, mix, 2 ** 31 + 5)
    b = tr.make_pool(corpus, mix, 2 ** 31 + 5)
    c = tr.make_pool(corpus, mix, 7)
    assert [f['data'] for f in a] == [f['data'] for f in b]
    assert [f['data'] for f in a] != [f['data'] for f in c]
    # the same sizes for every seed, each pass visiting every rung once
    ladder = mix['ladder_bytes']
    for pool in (a, c):
        assert sorted(f['size'] for f in pool) == sorted(
            ladder * mix['pool_passes'])
        assert all(len(f['data']) == f['size'] for f in pool)
        for p in range(mix['pool_passes']):
            part = pool[p * len(ladder):(p + 1) * len(ladder)]
            assert sorted(f['size'] for f in part) == sorted(ladder)


def test_files_are_corpus_chunks():
    corpus = tr.load_corpus('data/sample5_bzip2_9.bz2')
    assert len(corpus) == 2_130_640
    chunks = tr.chunk_list(corpus, 4096)
    assert len(chunks) == 521 and len(chunks[-1]) == 720
    # each file is whole chunks end to end, the last one cut
    mix = dict(tr.load_json('traffic', 'enwik8-encode'),
               ladder_bytes=[300_000, 5_000_000])
    for f in tr.make_pool(corpus, mix, 11):
        data, pos, seen = f['data'], 0, []
        while pos < len(data):
            piece = next(i for i, c in enumerate(chunks)
                         if data[pos:pos + len(c)] == c
                         or pos + len(c) > len(data)
                         and c.startswith(data[pos:]))
            seen.append(piece)
            pos += len(chunks[piece])
        # one shuffle of every chunk, repeated: no chunk comes back
        # before all the others have passed
        assert sorted(seen[:521]) == list(range(521)) or len(seen) < 521
        assert all(seen[i] == seen[i % 521] for i in range(len(seen)))


# -- the window's arithmetic --------------------------------------------------

def test_window_rate_and_p95_on_fixed_timings():
    pool = [{'size': 1_000_000}, {'size': 3_000_000}]
    w = harness.Window(pool)
    t = 10.0
    for i in range(40):                       # 40 calls, 0.1 s .. 4.0 s
        d = 0.1 * (i + 1)
        w.add(i % 2, t, t + d, False)
        t += d
    assert w.seconds == pytest.approx(sum(0.1 * (i + 1) for i in range(40)))
    assert w.mb_per_s == pytest.approx(20 * 4.0 / w.seconds)
    assert w.p95_ms == pytest.approx(3800.0)   # rank ceil(0.95 * 40) = 38
    w.add(0, t, t + 1.0, True)                 # a call that raised
    w.rejected = {1}                           # a wrong output (3 MB)
    assert w.failed == 2
    assert w.mb_per_s == pytest.approx((80.0 - 3.0) / w.seconds)


def test_p95_is_nearest_rank():
    assert harness.p95([5.0]) == 5.0
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95(list(range(1, 201))) == 190


# -- roofline counts ----------------------------------------------------------

def _metric(name):
    return harness.load_file_module('metrics', name)


def test_roofline_counts_by_hand():
    mtf = _metric('mtf_scan_roofline_pct')
    assert mtf.bytes_of_call(900_000) == 1_800_000      # 1 B in, 1 B out
    undo = _metric('mtf_undo_roofline_pct')
    assert undo.bytes_of_call(1000) == 2000
    comp = _metric('compose_windowed_roofline_pct')
    assert comp.bytes_of_call(6, 4096) == 6 * 4096 * (4 + 4 + 4)
    fen = _metric('fenwick_decode_roofline_pct')
    # 128 lanes of 100 bytes, 50 steps: 12,800 B read, 128 x 50 symbols of
    # 2 B written, 128 states of 16 B read and written
    assert fen.bytes_of_call(128, 100, 50) == 12_800 + 12_800 + 4096


def test_roofline_counts_read_the_calls_shapes():
    comp = _metric('compose_windowed_roofline_pct')
    a = torch.zeros((6, 4096), dtype=torch.int32)
    assert comp.BYTES[comp.SPANS[0]]((a, a, 1, 20), {}, a) == \
        comp.bytes_of_call(6, 4096)
    fen = _metric('fenwick_decode_roofline_pct')
    pay = torch.zeros((128, 100), dtype=torch.uint8)
    valid = torch.zeros((128, 50), dtype=torch.bool)
    args = (pay, None, None, 258, 0xFF00, 0x100, valid)
    assert fen.BYTES[fen.SPANS[0]](args, {}, None) == \
        fen.bytes_of_call(128, 100, 50)
    scan = _metric('mtf_scan_roofline_pct')
    assert scan.BYTES[scan.SPANS[0]]((None, 777), {}, None) == 2 * 777
    # the MTF undo counts a bzip2 block by the column its read-back
    # accepts, not by the header's block size that the kernels run at,
    # and a refused candidate not at all; a BWTC-L block by its length
    undo = _metric('mtf_undo_roofline_pct')
    collect = undo.BYTES[undo.SPANS[0]]
    column = torch.zeros(777, dtype=torch.int32)
    assert collect((None, 261_900, 900_000), {},
                   (column, 3, 0, 100)) == 2 * 777
    assert collect((None, 261_900, 900_000), {}, None) == 0
    lanes = undo.BYTES[undo.SPANS[1]]
    assert lanes((None, 900_000, 128, 1, 2, 3, None), {}, None) == 1_800_000


def test_every_metric_has_a_reader():
    bench = _bench()
    for m in bench['end_to_end'] + bench['per_layer']:
        assert callable(_metric(m['name']).read), m['name']


# -- the plain reference ------------------------------------------------------

@pytest.mark.parametrize('name', ['sample5_bzip2_9.bz2',
                                  'sample5x4_bzip2_9.bz2'])
def test_reference_decodes_the_goldens(name):
    with open(os.path.join(GOLDEN, name), 'rb') as f:
        stream = f.read()
    d = ref.decode(stream)
    assert d.data == bz2.decompress(stream)
    assert d.level == 9 and d.crc_mismatches == 0
    assert max(d.block_lengths) <= 900_000


def test_benchmark_corpus_is_the_golden():
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        golden = f.read()
    with open(os.path.join(tr.ROOT, 'data', 'sample5_bzip2_9.bz2'),
              'rb') as f:
        assert f.read() == golden


@pytest.mark.parametrize('data', [b'', b'x', b'ab' * 40_000,
                                  bytes(range(256)) * 300,
                                  b'a' * 5000 + b'b' * 255 + b'cdef'])
def test_reference_decodes_stdlib_streams(data):
    for level in (1, 9):
        d = ref.decode(bz2.compress(data, level))
        assert d.data == data and d.crc_mismatches == 0 and d.level == level


def test_reference_reports_broken_guarantees():
    data = tr.load_corpus('data/sample5_bzip2_9.bz2')[:200_000]
    s = bytearray(bz2.compress(data, 9))
    s[10] ^= 0xFF                                    # the block CRC
    assert ref.decode(bytes(s)).crc_mismatches >= 1
    with pytest.raises(ref.FormatError):
        ref.decode(bz2.compress(data, 9) + b'\0')    # bytes after the end
    with pytest.raises(ref.FormatError):
        ref.decode(b'BZh9' + b'\0' * 20)             # no block magic
    # a level-1 stream's blocks, claimed as level 1 but 200,000 bytes long
    big = bytearray(bz2.compress(bytes(range(256)) * 800, 2))
    big[3] = ord('1')
    with pytest.raises(ref.FormatError):
        ref.decode(bytes(big))


@pytest.mark.parametrize('workers', [1, 2])
def test_reference_chains_blocks_decoded_apart(workers):
    # level 1: 100,000-byte blocks, so 300 KB is four of them
    data = tr.load_corpus('data/sample5_bzip2_9.bz2')[:300_000]
    d = ref.decode(bz2.compress(data, 1), workers=workers)
    assert d.data == data and d.crc_mismatches == 0
    assert len(d.block_lengths) == 4
    # a block left out breaks the chain: the next magic is not where the
    # block before it ended
    s = bz2.compress(data, 1)
    starts, ends = ref._magics(s)
    assert len(starts) == 4 and len(ends) == 1
    cut = s[:starts[1] // 8] + s[starts[2] // 8:]
    with pytest.raises(ref.FormatError):
        ref.decode(cut, workers=workers)


def test_bwtcl_host_codec_is_held_to_the_golden():
    from benchmark.formats import bwtcl
    corpus = tr.load_corpus('data/sample5_bzip2_9.bz2')
    config = tr.load_json('configs', 'bwtcl-9-wikitext')
    assert bwtcl.check_setup(config, 'decode', corpus) == \
        {'golden_differs': 0}
    other = dict(config, golden=dict(config['golden'], piece_bytes=999_999))
    assert bwtcl.check_setup(other, 'decode', corpus) == \
        {'golden_differs': 1}


class _CountingFormat:
    LIMITS = {'decode': {'files_differing': 0}}

    def __init__(self):
        self.judged = []

    def judge(self, config, op, file, out):
        self.judged.append(out)
        return {'files_differing': int(out != file['data'])}


def test_outputs_are_judged_after_the_window():
    fmt = _CountingFormat()
    pool = [{'data': b'abc'}, {'data': b'xyz'}]
    checks = harness.Checks(fmt, {}, 'decode', pool)
    for c, (k, out) in enumerate([(0, b'abc'), (1, b'xyz'), (0, b'abc'),
                                  (1, b'xyQ'), (0, b'abc')]):
        checks(k, c, out)
    assert fmt.judged == []                  # nothing judged in the window
    checks.judge()
    # each distinct output once; the wrong one rejects its call only
    assert sorted(fmt.judged) == [b'abc', b'xyQ', b'xyz']
    assert checks.found == {'files_differing': 1}
    assert checks.rejected == {3}


# -- the harness on the CPU ---------------------------------------------------

@pytest.mark.parametrize('workload', ['bzip2-9.files-encode',
                                      'bzip2-9.files-decode'])
def test_sound_runs_are_correct(capsys, workload):
    line, err = _run(capsys, workload)
    assert line['correct'] is True and line['failed'] == 0
    assert line['attempted'] >= 1
    names = [m['name'] for m in harness.cell_metrics(
        _bench(), {w['name']: w for w in _bench()['workloads']}[workload], 0)]
    assert sorted(line['metrics']) == sorted(names)
    assert all(v['value'] > 0 for v in line['metrics'].values())
    assert list(line)[-1] == 'checks'
    assert err.strip().splitlines()[-1].startswith('check failed_calls 0')


def test_bwtcl_sound_run_is_correct(capsys):
    # level 1 (100,000-byte blocks) keeps the plain decode short here
    line, _ = _run(capsys, 'bwtcl-9.files-decode',
                   overrides={'ladder_bytes': [100_000], 'pool_passes': 1},
                   config_overrides={'level': 1}, seconds=0.1)
    assert line['correct'] is True and line['failed'] == 0


def test_traced_run_reports_its_slice(capsys):
    line, err = _run(capsys, 'bzip2-9.files-encode', trace=1,
                     overrides={'ladder_bytes': [3000], 'pool_passes': 1,
                                'trace_min_s': 0})
    assert line['correct'] is True
    assert line['device']['window_s'] > 0
    assert 'device_ops' in line['breakdown']
    assert 'host_wait_share.encode' in line['metrics']
    assert 'trace:' in err


# each fault a cell can have, and each cell's control, reads correct false
@pytest.mark.parametrize('workload,fault', [
    ('bzip2-9.files-encode', 'crc_skipped'),
    ('bzip2-9.files-encode', 'byte_altered'),
    ('bzip2-9.files-encode', 'half_blocks'),
    ('bzip2-9.files-encode', 'unchanged'),
    ('bzip2-9.files-decode', 'byte_altered'),
    ('bzip2-9.files-decode', 'half_blocks'),
    ('bzip2-9.files-decode', 'unchanged'),
])
def test_broken_paths_read_not_correct(capsys, workload, fault):
    line, _ = _run(capsys, workload, fault=fault)
    assert line['correct'] is False
    assert line['failed'] == line['attempted']


@pytest.mark.parametrize('fault', ['byte_altered', 'half_blocks',
                                   'unchanged'])
def test_bwtcl_broken_paths_read_not_correct(capsys, fault):
    line, _ = _run(capsys, 'bwtcl-9.files-decode', fault=fault,
                   overrides={'ladder_bytes': [100_000], 'pool_passes': 1},
                   config_overrides={'level': 1}, seconds=0.1)
    assert line['correct'] is False


# -- the process --------------------------------------------------------------

_DRIVE = '''
import sys
sys.path.insert(0, sys.argv[1])
from benchmark import harness
rc = harness.main(['--workload', 'bzip2-9.files-decode', '--seed', '5',
                   '--seconds', '0.2', '--trace', '0'], device='cpu',
                  overrides={'ladder_bytes': [3000], 'pool_passes': 1})
tops = sorted({n.split('.')[0] for n in sys.modules})
print('TOPS', ' '.join(tops))
sys.exit(rc)
'''


def test_harness_loads_no_jax():
    r = subprocess.run([sys.executable, '-c', _DRIVE, ROOT],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    tops = r.stdout.split('TOPS', 1)[1].split()
    assert 'compressjs_tpu_torch' in tops
    assert not set(tops) & {'jax', 'jaxlib', 'flax', 'compressjs_tpu'}


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present')
    r = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                        'bzip2-9.files-encode', '--seed', '1', '--seconds',
                        '1', '--trace', '0'], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert 'no CUDA device' in r.stderr
    assert r.stdout.strip() == ''


def test_benchmark_alone_exits_nonzero(tmp_path):
    # a checkout of BENCHMARK.json and the benchmark's files, no program
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    for p in _bench()['paths']:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns('__pycache__'))
    r = subprocess.run([sys.executable, '-c', _DRIVE, str(tmp_path)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '{"correct"' not in r.stdout


@pytest.mark.cuda
def test_every_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    for cell in _bench()['workloads']:
        r = subprocess.run([sys.executable, 'benchmark/run.py', '--workload',
                            cell['name'], '--seed', '12345', '--seconds',
                            '2', '--trace', '0'], cwd=ROOT,
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-2000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line['correct'] is True, line
        assert line['device']['platform'] == 'gpu'
