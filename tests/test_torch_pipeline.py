"""The whole slice: compressjs_tpu_torch.compress_file_device against
the JAX package's host codec and the in-repo goldens, on the CPU."""

import bz2
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from compressjs_tpu.codecs import bzip2 as bzip2_ref
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.parallel import pipeline

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
            'compressjs_tpu_torch.native.lib();'
            'bad = [m for m in sys.modules if m.split(".")[0].startswith('
            '"jax") or m.split(".")[0] == "compressjs_tpu"];'
            'print(bad); sys.exit(1 if bad else 0)')
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
