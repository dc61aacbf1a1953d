"""The whole slice: compressjs_tpu_torch.compress_file_device against
the JAX package's host codec and the in-repo goldens, on the CPU."""

import bz2
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from compressjs_tpu.codecs import bzip2 as bzip2_ref
import compressjs_tpu_torch as cz
from compressjs_tpu_torch import tracer
from compressjs_tpu_torch.host import bzip2 as host_bzip2
from compressjs_tpu_torch.parallel import pipeline, profiling
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9)))
             for _ in range(800)]
    lines = []
    size = 0
    while size < n:
        line = b' '.join(words[i] for i in rng.integers(0, 800, 12))
        lines.append(line.capitalize() + b'.\n')
        size += len(lines[-1])
    return b''.join(lines)[:n]


def _input(kind):
    if kind == 'text_150k':      # one full -1 block and a tail
        return _text_like(5, 150000)
    if kind == 'short':
        return b'hello, hello, hello world\n'
    if kind == 'empty':
        return b''
    if kind == 'runs':           # RLE1 count bytes and cut runs
        rng = np.random.default_rng(6)
        vals = rng.integers(0, 256, 3000).astype(np.uint8)
        lens = rng.choice([1, 3, 4, 5, 255, 256, 600], 3000)
        return np.repeat(vals, lens).tobytes()[:250000]
    if kind == 'random':
        return np.random.default_rng(7).integers(
            0, 256, 120000).astype(np.uint8).tobytes()
    raise ValueError(kind)


ENCODERS = {
    'full': dict(mode='full'),
    'core': dict(mode='core'),
    'hybrid': dict(mode='hybrid'),
    'hybrid_batch': dict(mode='hybrid', batch=True),
    'hybrid_self_check': dict(mode='hybrid', self_check=True),
}


@pytest.mark.parametrize('encoder', list(ENCODERS))
@pytest.mark.parametrize('kind', ['text_150k', 'short', 'empty', 'runs',
                                  'random'])
def test_level1_matches_host_codec(kind, encoder):
    data = _input(kind)
    enc = cz.DeviceBzip2Encoder(1, device='cpu', **ENCODERS[encoder])
    got = enc.compress(data)
    want = bytes(bzip2_ref.compress_file(data, None, 1))
    assert got == want
    assert bz2.decompress(got) == data


def test_output_file_object(tmp_path):
    data = _input('short')
    path = tmp_path / 'out.bz2'
    with open(path, 'wb') as f:
        assert cz.compress_file_device(data, f, level=2, device='cpu') is f
    assert path.read_bytes() == cz.compress_file_device(data, level=2,
                                                        device='cpu')


def test_cuda_is_required_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        cz.compress_file_device(b'abc')
    with pytest.raises(RuntimeError):
        cz.DeviceBzip2Encoder(9)


@pytest.mark.parametrize('level', [0, 10])
def test_bad_level(level):
    with pytest.raises(ValueError):
        cz.DeviceBzip2Encoder(level, device='cpu')


def test_tail_block_takes_device_path(monkeypatch):
    """Every block, the short tail included, goes through
    encode_block_full."""
    calls = []
    real = pipeline.encode_block_full

    def spy(block, n, remap, eob):
        calls.append(n)
        return real(block, n, remap, eob)

    monkeypatch.setattr(pipeline, 'encode_block_full', spy)
    data = _input('text_150k')
    cz.compress_file_device(data, level=1, device='cpu')
    assert len(calls) == 2 and calls[0] == 99981 and calls[1] < 99981


# -- blocks queued as the split produces them -------------------------------

def _blocks_input(kind, level):
    """'one_block': a full block and nothing after; 'blocks': two full
    blocks and a short tail at level 9, three and a tail at level 1;
    'empty'.  Text-like bytes, which RLE1 leaves near their size."""
    bs = host_bzip2.block_size_of(level)
    if kind == 'empty':
        return b''
    n = bs if kind == 'one_block' else (2 if level == 9 else 3) * bs + 5000
    rng = np.random.default_rng(11)
    words = [rng.integers(97, 123, rng.integers(1, 9)).astype(np.uint8)
             for _ in range(800)]
    text = np.concatenate([np.append(words[i], np.uint8(32))
                           for i in rng.integers(0, 800, n // 2)])[:n]
    sizes = [b.shape[0] for b, _ in host_bzip2.split_blocks(text, bs)]
    assert len(sizes) == (1 if kind == 'one_block' else n // bs + 1)
    return text.tobytes()


@pytest.mark.parametrize('level,kind,encoder', [
    (1, 'one_block', 'full'), (1, 'blocks', 'full'), (1, 'empty', 'full'),
    (9, 'one_block', 'full'), (9, 'blocks', 'full'), (9, 'empty', 'full'),
    (1, 'blocks', 'core'), (1, 'blocks', 'hybrid_batch')])
def test_streamed_compress_matches_host_codec(level, kind, encoder):
    data = _blocks_input(kind, level)
    got = cz.DeviceBzip2Encoder(level, device='cpu',
                                **ENCODERS[encoder]).compress(data)
    assert got == bytes(bzip2_ref.compress_file(data, None, level))
    assert bz2.decompress(got) == data


def _spy_split(monkeypatch, order, before=None, end=None):
    """Record each block the split produces as ('split', k); call
    `before(k)` first, and `end()` once the split is exhausted."""
    real = pipeline.split_blocks

    def spy(data, block_size):
        for k, item in enumerate(real(data, block_size)):
            if before is not None:
                before(k)
            order.append(('split', k))
            yield item
        if end is not None:
            end()

    monkeypatch.setattr(pipeline, 'split_blocks', spy)


def _spy_device(monkeypatch, order, before=None):
    """Record each block's device stage as ('device', index) when it
    starts; call `before(index)` first."""
    real = pipeline.device_stage

    def spy(block, meta, mode, device, index=None):
        if before is not None:
            before(index)
        order.append(('device', index))
        return real(block, meta, mode, device, index)

    monkeypatch.setattr(pipeline, 'device_stage', spy)


def test_first_block_runs_while_the_split_goes_on(monkeypatch):
    """The split holds back every block after the first until block 0's
    device stage has started (a whole-file split first would wait out
    the guard for each, and record the device stage last)."""
    data = _blocks_input('blocks', 1)
    order, started = [], threading.Event()
    _spy_split(monkeypatch, order,
               lambda k: k and started.wait(timeout=30))
    _spy_device(monkeypatch, order, lambda i: started.set())
    got = cz.compress_file_device(data, level=1, device='cpu')
    assert bz2.decompress(got) == data
    splits = [e for e in order if e[0] == 'split']
    assert len(splits) == 4
    assert order.index(('device', 0)) < order.index(splits[-1])
    assert [e for e in order if e[0] == 'device'] == [
        ('device', i) for i in range(4)]


def _encoder_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith('ThreadPoolExecutor')}


@pytest.mark.parametrize('where', ['device', 'split'])
def test_errors_propagate_and_end_the_worker(monkeypatch, where):
    """A RuntimeError of block 1's device stage (of 4), or of the split
    at its third block, is raised from `compress`, and the encoder's
    worker has ended."""
    data = _blocks_input('blocks', 1)
    order = []

    def fail(k):
        if k == {'device': 1, 'split': 2}[where]:
            raise RuntimeError('planted ' + where)

    if where == 'device':
        _spy_device(monkeypatch, order, fail)
    else:
        _spy_split(monkeypatch, order, fail)
    before = _encoder_threads()
    enc = cz.DeviceBzip2Encoder(1, device='cpu')
    with pytest.raises(RuntimeError, match='planted ' + where):
        enc.compress(data)
    assert enc._pool is None
    assert not {t for t in _encoder_threads() - before if t.is_alive()}


def test_submit_counters(monkeypatch):
    """Each block's device stage waits until the split is exhausted, so
    every block after the first is queued while the one before it runs;
    with the timer off nothing is counted."""
    timer = profiling.StageTimer(enabled=True)
    monkeypatch.setattr(tracer, '_global_timer', timer)
    order, split_done = [], threading.Event()
    data = _blocks_input('blocks', 1)
    _spy_split(monkeypatch, order, end=split_done.set)
    _spy_device(monkeypatch, order, lambda i: split_done.wait(timeout=30))
    cz.compress_file_device(data, level=1, device='cpu')
    assert timer.counters['encode_submits'] == 4
    assert timer.counters['encode_submits_busy'] == 3
    assert timer.counts['encode.queue'] == 4
    timer.counters.clear()
    timer.enabled = False
    cz.compress_file_device(data, level=1, device='cpu')
    assert not timer.counters


REF_TIES = 'COMPRESSJS_TPU_BZ2_REF_TIES'


def _ref_ties(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(REF_TIES, raising=False)
    else:
        monkeypatch.setenv(REF_TIES, value)


@pytest.mark.parametrize('ref_ties', ['1', None])
@pytest.mark.parametrize('encoder', ['full', 'core', 'hybrid', 'mesh'])
def test_ref_ties_one_block(monkeypatch, encoder, ref_ties):
    """COMPRESSJS_TPU_BZ2_REF_TIES=1 switches the host Huffman stage to
    the reference's grouping, as it does in the JAX package: every mode
    gives compress_file's bytes for one (tail) block at -9, with the
    variable set and unset."""
    _ref_ties(monkeypatch, ref_ties)
    data = _text_like(8, 200000)
    want = bytes(bzip2_ref.compress_file(data, None, 9))
    if encoder == 'mesh':
        got = cz.mesh_compress_bzip2(cz.make_mesh('cpu'), data, level=9)
    else:
        got = cz.compress_file_device(data, level=9, mode=encoder,
                                      device='cpu')
    assert got == want


@pytest.mark.parametrize('ref_ties', ['1', None])
@pytest.mark.parametrize('encoder', ['core', 'hybrid', 'hetero'])
def test_ref_ties_blocks(monkeypatch, encoder, ref_ties):
    """The same on 4 level-1 blocks, for the splits whose every block
    takes the host Huffman stage and for the hosts-only hetero encode."""
    _ref_ties(monkeypatch, ref_ties)
    data = _text_like(9, 350000)
    want = bytes(bzip2_ref.compress_file(data, None, 1))
    if encoder == 'hetero':
        got = cz.hetero_compress_bzip2(data, level=1, device=None)
    else:
        got = cz.compress_file_device(data, level=1, mode=encoder,
                                      device='cpu')
    assert got == want


@pytest.mark.parametrize('seed,n,level', [(8, 200000, 9), (9, 350000, 1)])
def test_ref_ties_changes_the_grouping(monkeypatch, seed, n, level):
    """The inputs above tell the two groupings apart."""
    data = _text_like(seed, n)
    _ref_ties(monkeypatch, '1')
    with_ties = cz.compress_file_device(data, level=level, mode='core',
                                        device='cpu')
    _ref_ties(monkeypatch, None)
    assert with_ties != cz.compress_file_device(data, level=level,
                                                mode='core', device='cpu')


def test_import_isolation():
    """The port loads neither JAX nor any compressjs_tpu module."""
    code = ('import sys, compressjs_tpu_torch, compressjs_tpu_torch.convert;'
            'import compressjs_tpu_torch.ops.block_kernels;'
            'import compressjs_tpu_torch.ops.block_decode;'
            'import compressjs_tpu_torch.ops.compose;'
            'import compressjs_tpu_torch.ops.device_huffman;'
            'import compressjs_tpu_torch.host.bzip2_parse;'
            'import compressjs_tpu_torch.parallel.decode;'
            'import compressjs_tpu_torch.native;'
            'import compressjs_tpu_torch.host.huffman_stages;'
            'import compressjs_tpu_torch.host.bwt;'
            'import compressjs_tpu_torch.host.mtf_rle2;'
            'import compressjs_tpu_torch.parallel.profiling;'
            'import compressjs_tpu_torch.parallel.mesh;'
            'import compressjs_tpu_torch.parallel.hetero;'
            'import compressjs_tpu_torch.host.bzip2_decode;'
            'import compressjs_tpu_torch.host.bwtc;'
            'import compressjs_tpu_torch.host.mtf;'
            'import compressjs_tpu_torch.host.rle;'
            'import compressjs_tpu_torch.host.range_coder;'
            'import compressjs_tpu_torch.host.stream;'
            'import compressjs_tpu_torch.host.util;'
            'import compressjs_tpu_torch.host.no_model;'
            'import compressjs_tpu_torch.host.log_distance_model;'
            'import compressjs_tpu_torch.host.defsum_model;'
            'import compressjs_tpu_torch.host.fenwick_model;'
            'import compressjs_tpu_torch.parallel.sharded_sort;'
            'import compressjs_tpu_torch.ops.device_coder;'
            'import compressjs_tpu_torch.ops.device_model;'
            'import compressjs_tpu_torch.ops.device_lane;'
            'import compressjs_tpu_torch.host.bwtcp;'
            'import compressjs_tpu_torch.host.bwtcl;'
            'import compressjs_tpu_torch.config;'
            'import compressjs_tpu_torch.cli;'
            'import compressjs_tpu_torch.host.bzip2;'
            'import compressjs_tpu_torch.host.simple;'
            'import compressjs_tpu_torch.host.lzjb;'
            'import compressjs_tpu_torch.host.lzjbr;'
            'import compressjs_tpu_torch.host.lzp3;'
            'import compressjs_tpu_torch.host.dmc;'
            'import compressjs_tpu_torch.host.ppm;'
            'import compressjs_tpu_torch.host.huffman;'
            'import compressjs_tpu_torch.host.mtf_model;'
            'import compressjs_tpu_torch.host.context1_model;'
            'import compressjs_tpu_torch.host.deflate_distance_model;'
            'import compressjs_tpu_torch.host.dummy_range_coder;'
            'import compressjs_tpu_torch.host.freeze;'
            'import compressjs_tpu_torch.coders;'
            'import compressjs_tpu_torch.models;'
            'import compressjs_tpu_torch.utils;'
            'compressjs_tpu_torch.utils.CRC32().update_crc_run(7, 1000);'
            'compressjs_tpu_torch.BWT.suffixsort(bytearray(5000), [0] * 5000, 5000);'
            '[getattr(compressjs_tpu_torch, n) for n in'
            ' compressjs_tpu_torch.__all__];'
            'compressjs_tpu_torch.bwtcl_compress_device(bytes(range(256)) * 40,'
            ' device="cpu");'
            'compressjs_tpu_torch.DeviceBWTCEncoder(1, device="cpu")'
            '.compress(bytes(range(256)) * 400);'
            'compressjs_tpu_torch.native.lib();'
            'd = bytes(range(256)) * 20;'
            'assert all(bytes(getattr(compressjs_tpu_torch, c).decompress_file('
            'getattr(compressjs_tpu_torch, c).compress_file(d))) == d for c in'
            ' ("Bzip2", "Lzp3", "Lzjb", "LzjbR", "PPM", "Dmc", "Simple"));'
            'bad = [m for m in sys.modules if m.split(".")[0].startswith('
            '"jax") or m.split(".")[0] == "compressjs_tpu"];'
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
