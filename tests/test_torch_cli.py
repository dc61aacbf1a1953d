"""The port's command line (python -m compressjs_tpu_torch.cli) against
the contract of tests/test_cli.py and byte for byte against the JAX
package's command line, with --device cpu for the encodes that have a
card path; on the CPU, on generated inputs and the goldens.

Both command lines run in-process (``main(argv)`` with the standard
streams swapped); a subprocess runs only where the module entry itself
is under test."""

import bz2
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from compressjs_tpu import cli as jcli
from compressjs_tpu_torch import cli
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'golden')
KEYS = ['defsum', 'fenwick', 'mtf', 'context1', 'no', 'huff', 'huffman',
        'bwtc', 'bwtcp', 'bzip', 'bzip2', 'dmc', 'lzjb', 'lzjbr', 'lzp3',
        'ppm', 'simple']


class _Stdout:
    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s):
        self.buffer.write(s.encode())

    def flush(self):
        pass


def run(main, argv, stdin=b'', monkeypatch=None):
    """(exit code, stdout bytes, stderr text) of main(argv)."""
    out, err = _Stdout(), io.StringIO()
    inp = io.TextIOWrapper(io.BytesIO(stdin))
    with monkeypatch.context() as m:
        m.setattr(sys, 'stdin', inp)
        m.setattr(sys, 'stdout', out)
        m.setattr(sys, 'stderr', err)
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.buffer.getvalue(), err.getvalue()


@pytest.fixture
def port(monkeypatch):
    return lambda argv, stdin=b'': run(cli.main, argv, stdin, monkeypatch)


@pytest.fixture
def jax_cli(monkeypatch):
    return lambda argv, stdin=b'': run(jcli.main, argv, stdin, monkeypatch)


def _text(n, seed=0):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(500)]
    return b' '.join(words[i] for i in rng.integers(0, 500, n // 3))[:n]


@pytest.fixture(scope='module')
def sample(tmp_path_factory):
    p = tmp_path_factory.mktemp('cli') / 'sample.txt'
    p.write_bytes(_text(12000, 1) + bytes(range(256)) * 4)
    return p


def test_roundtrip_via_files(port, tmp_path, sample):
    comp, back = tmp_path / 'out.lzjb', tmp_path / 'back.txt'
    rc, _, err = port(['-z', '-t', 'lzjb', '-1', str(sample), str(comp)])
    assert rc == 0, err
    rc, _, err = port(['-d', '-t', 'lzjb', str(comp), str(back)])
    assert rc == 0, err
    assert back.read_bytes() == sample.read_bytes()


def test_module_stdin_stdout():
    """The module entry itself, through pipes (one subprocess each way)."""
    data = b'hello compressjs tpu torch\n' * 10
    env = dict(os.environ, PYTHONPATH=ROOT)
    cmd = [sys.executable, '-m', 'compressjs_tpu_torch.cli']
    r = subprocess.run(cmd + ['-z', '-t', 'simple'], input=data,
                       capture_output=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    r2 = subprocess.run(cmd + ['-d', '-t', 'simple'], input=r.stdout,
                        capture_output=True, cwd=ROOT, env=env, timeout=120)
    assert r2.returncode == 0, r2.stderr
    assert r2.stdout == data


def test_stdin_stdout_in_process(port):
    data = b'abc' * 300
    rc, comp, _ = port(['-z', '-t', 'ppm'], data)
    assert rc == 0
    rc, back, _ = port(['-d', '-t', 'ppm'], comp)
    assert rc == 0 and back == data


def test_default_codec_is_lzp3(port, jax_cli):
    rc, out, _ = port(['-z'], b'abcabcabc')
    assert rc == 0
    assert out[:4] == b'lzp3'
    assert out == jax_cli(['-z'], b'abcabcabc')[1]


def test_block_extraction(port, jax_cli, tmp_path):
    src = os.path.join(GOLDEN, 'sample5x4_bzip2_9.bz2')
    pos = 1009640          # the second block of the golden
    rc, _, err = port(['-d', '-t', 'bzip2', '-b', str(pos), src,
                       str(tmp_path / 'blk')])
    assert rc == 0, err
    rc, _, err = jax_cli(['-d', '-t', 'bzip2', '-b', str(pos), src,
                          str(tmp_path / 'jblk')])
    assert rc == 0, err
    got = (tmp_path / 'blk').read_bytes()
    assert got == (tmp_path / 'jblk').read_bytes()
    with open(src, 'rb') as f:
        whole = bz2.decompress(f.read())
    assert len(got) == 899959 and got in whole


def test_bad_codec_name(port):
    rc, _, err = port(['-z', '-t', 'nosuch'], b'x')
    assert rc == 1
    assert 'Unknown compressor' in err


@pytest.mark.parametrize('argv', [
    ['-z', '-t', 'lzjb', '-1', '-9'],           # conflicting levels
    ['-d', '-t', 'lzjb', '-5'],                 # a level to decompress
    ['-z', '-b', '32'],                         # --block to compress
    ['-d', '-z'],                               # both directions
])
def test_rejected_options(port, jax_cli, argv):
    rc, _, err = port(argv, b'x')
    assert rc == 1
    assert (rc, err) == jax_cli(argv, b'x')[::2]


def test_block_on_non_random_access_codec(port):
    rc, _, err = port(['-d', '-t', 'lzjb', '-b', '32'], b'x')
    assert rc == 1
    assert 'random-access' in err and 'Traceback' not in err


@pytest.mark.parametrize('argv,payload', [
    (['-d', '-t', 'lzp3'], b'NOTAMAGIC'),
    (['-d', '-t', 'bzip2'], b''),
    (['-d', '-t', 'bwtc'], b'bwtc....garbage'),
])
def test_corrupt_input_clean_error(port, argv, payload):
    rc, _, err = port(argv, payload)
    assert rc == 1
    assert 'error:' in err or 'Not bzip' in err
    assert 'Traceback' not in err


@pytest.mark.parametrize('corrupt', ['block_magic', 'stream_magic',
                                     'truncated', 'payload_byte'])
def test_corrupt_bzip2_stderr_matches_jax_cli(port, jax_cli, tmp_path,
                                              corrupt):
    stream = bytearray(bz2.compress(_text(5000, 3), 9))
    if corrupt == 'block_magic':
        stream[4] ^= 0xFF
    elif corrupt == 'stream_magic':
        stream[0] = ord('X')
    elif corrupt == 'truncated':
        stream = stream[:len(stream) // 2]
    else:
        stream[len(stream) // 3] ^= 0x10
    src = tmp_path / 'bad.bz2'
    src.write_bytes(bytes(stream))
    argv = ['-d', '-t', 'bzip2', str(src), str(tmp_path / 'out')]
    want = jax_cli(argv)
    assert want[0] == 1 and want[2].startswith('error: ')
    assert port(argv) == want


def test_corrupt_input_keeps_destination(port, tmp_path):
    dest = tmp_path / 'out'
    dest.write_bytes(b'keep me')
    src = tmp_path / 'bad'
    src.write_bytes(b'lzp3 garbage garbage')
    rc, _, _ = port(['-d', '-t', 'lzp3', str(src), str(dest)])
    assert rc == 1
    assert dest.read_bytes() == b'keep me'
    assert sorted(os.listdir(tmp_path)) == ['bad', 'out']


def test_missing_input_file_clean_error(port, tmp_path):
    rc, _, err = port(['-z', '-t', 'lzp3', str(tmp_path / 'nothing')])
    assert rc == 1
    assert 'error:' in err and 'Traceback' not in err


@pytest.mark.parametrize('name', KEYS)
def test_all_dispatch_names(port, name):
    data = b'dispatch test data ' * 5
    rc, comp, err = port(['-z', '-t', name, '-1', '--device', 'cpu'], data)
    assert rc == 0, err
    rc, back, err = port(['-d', '-t', name], comp)
    assert rc == 0, err
    assert back == data


@pytest.mark.parametrize('level', ['-1', '-9', None])
@pytest.mark.parametrize('name', KEYS)
def test_output_files_match_jax_cli(port, jax_cli, tmp_path, sample, name,
                                    level):
    lv = [level] if level else []
    out, jout = tmp_path / 'p', tmp_path / 'j'
    rc, _, err = port(['-z', '-t', name, *lv, '--device', 'cpu',
                       str(sample), str(out)])
    assert rc == 0, err
    rc, _, err = jax_cli(['-z', '-t', name, *lv, str(sample), str(jout)])
    assert rc == 0, err
    assert out.read_bytes() == jout.read_bytes()
    back, jback = tmp_path / 'pb', tmp_path / 'jb'
    assert port(['-d', '-t', name, str(jout), str(back)])[0] == 0
    assert jax_cli(['-d', '-t', name, str(out), str(jback)])[0] == 0
    assert back.read_bytes() == jback.read_bytes() == sample.read_bytes()


@pytest.mark.parametrize('golden', ['sample5_bzip2_9.bz2',
                                    'sample5x4_bzip2_9.bz2'])
def test_golden_decode_matches_jax_cli(port, jax_cli, tmp_path, golden):
    src = os.path.join(GOLDEN, golden)
    out, jout = tmp_path / 'p', tmp_path / 'j'
    assert port(['-d', '-t', 'bzip2', src, str(out)])[0] == 0
    assert jax_cli(['-d', '-t', 'bzip2', src, str(jout)])[0] == 0
    assert out.read_bytes() == jout.read_bytes()


@pytest.mark.skipif(torch.cuda.is_available(), reason='a CUDA card is here')
@pytest.mark.parametrize('name', cli.CARD_ROUTES)
def test_card_route_without_card_exits_1(port, tmp_path, sample, name):
    """The default --device cuda never goes on on the CPU: exit 1, a
    message naming the missing device, no output file."""
    out = tmp_path / 'out'
    rc, _, err = port(['-z', '-t', name, '-9', str(sample), str(out)])
    assert rc == 1
    assert 'no CUDA device' in err
    assert os.listdir(tmp_path) == []


@pytest.mark.skipif(torch.cuda.is_available(), reason='a CUDA card is here')
def test_module_card_route_without_card(tmp_path, sample):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = tmp_path / 'out.bz2'
    r = subprocess.run([sys.executable, '-m', 'compressjs_tpu_torch.cli',
                        '-z', '-t', 'bzip2', '-9', str(sample), str(out)],
                       capture_output=True, cwd=ROOT, env=env, timeout=120)
    assert r.returncode == 1
    assert b'no CUDA device' in r.stderr and b'Traceback' not in r.stderr
    assert not out.exists() and os.listdir(tmp_path) == []


def test_host_codecs_ignore_device(port, jax_cli):
    """A codec with no card path runs on the host whatever --device says,
    as the JAX command line runs it."""
    data = _text(3000, 2)
    want = jax_cli(['-z', '-t', 'lzp3'], data)[1]
    assert port(['-z', '-t', 'lzp3'], data)[1] == want
    assert port(['-z', '-t', 'lzp3', '--device', 'cpu'], data)[1] == want
