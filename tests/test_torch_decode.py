"""The decode slice as a whole: compressjs_tpu_torch.decompress_file_device
on the CPU returns the original bytes of streams written by the JAX
package, by the stdlib bz2 and by the port itself, and of the in-repo
golden, and raises ValueError on a corrupt stream."""

import bz2
import io
import os

import numpy as np
import pytest
import torch

from compressjs_tpu.codecs import bzip2 as jbz
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bzip2_parse as bp
from compressjs_tpu_torch.parallel import decode as dec
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9)))
             for _ in range(800)]
    out = b' '.join(words[i] for i in rng.integers(0, 800, n // 4))
    return out[:n]


def _runs(seed, n):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 256, 3000).astype(np.uint8)
    return np.repeat(vals, rng.choice([1, 3, 4, 5, 255, 600], 3000)
                     ).tobytes()[:n]


def test_jax_multiblock_level1_stream():
    data = _text_like(1, 150000) + _runs(2, 80000)
    comp = bytes(jbz.compress_file(data, props=1))
    assert cz.decompress_file_device(comp, device='cpu') == data


def test_stdlib_level9_stream():
    data = _runs(3, 60000)
    assert cz.decompress_file_device(bz2.compress(data, 9),
                                     device='cpu') == data


def test_port_encoded_stream():
    data = _text_like(4, 120000)
    comp = cz.compress_file_device(data, level=1, device='cpu')
    assert cz.decompress_file_device(comp, device='cpu') == data


def test_golden_sample5():
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    assert cz.decompress_file_device(gold, device='cpu') == \
        bz2.decompress(gold)


@pytest.mark.parametrize('data', [b'', b'x', b'hello, hello, hello world\n'])
def test_short_streams(data):
    assert cz.decompress_file_device(bz2.compress(data, 1),
                                     device='cpu') == data


def test_output_file_object():
    data = _text_like(5, 5000)
    out = io.BytesIO()
    assert cz.decompress_file_device(bz2.compress(data), out,
                                     device='cpu') is out
    assert out.getvalue() == data


@pytest.mark.parametrize('where', ['payload', 'late_payload', 'stream_crc'])
def test_corrupt_stream_raises(where):
    data = _text_like(6, 150000)
    comp = bytearray(jbz.compress_file(data, props=1))
    i = {'payload': 3000, 'late_payload': len(comp) - 500,
         'stream_crc': len(comp) - 2}[where]
    comp[i] ^= 0x24
    with pytest.raises(ValueError):
        cz.decompress_file_device(bytes(comp), device='cpu')


@pytest.mark.parametrize('comp', [b'', b'BZh0', b'PK\x03\x04 not bzip2',
                                  bz2.compress(b'abc' * 1000)[:-20]])
def test_bad_streams_raise(comp):
    with pytest.raises(ValueError):
        cz.decompress_file_device(comp, device='cpu')


def _plant_magic(monkeypatch, block_hits=(), end_hits=()):
    """Make the magic scan also report the given bit positions, as a
    payload that happens to hold a magic's bit pattern would."""
    scan = bp._scan_magic

    def planted(data, pattern):
        extra = block_hits if pattern is bp.MAGIC_BYTES else end_hits
        return np.sort(np.concatenate(
            [scan(data, pattern), np.asarray(extra, dtype=np.int64)]))

    monkeypatch.setattr(bp, '_scan_magic', planted)


@pytest.mark.parametrize('false_end,false_block', [
    ([1], []), ([0, 1], []), ([1], [0]), ([0], [0, 1])])
def test_false_magic_inside_a_payload(monkeypatch, false_end,
                                      false_block):
    """A 3-block stream with false end-of-stream and block magics planted
    5,000 bits into the payloads of the listed blocks decodes."""
    rng = np.random.default_rng(0)
    data = rng.choice(np.frombuffer(b'abcd', np.uint8), 250000).tobytes()
    comp = bz2.compress(data, 1)
    blocks = bp._scan_magic(np.frombuffer(comp, np.uint8), bp.MAGIC_BYTES)
    assert len(blocks) == 3
    _plant_magic(monkeypatch, [int(blocks[i]) + 5000 for i in false_block],
                 [int(blocks[i]) + 5000 for i in false_end])
    assert cz.decompress_file_device(comp, device='cpu') == data


@pytest.mark.parametrize('false_end', [[], [1]])
def test_retry_far_from_the_end(monkeypatch, false_end):
    """A false block magic inside block 0, with the stream end further
    away than the retry may read: the retry is bounded by the largest
    block, not by the end, and still reaches block 1.  The largest block
    is shrunk to 300,000 bits (block 0 takes about 218,000) so that a
    small stream stands for one of many megabits."""
    monkeypatch.setattr(dec, '_max_block_bits', lambda dbuf_size: 300000)
    rng = np.random.default_rng(0)
    data = rng.choice(np.frombuffer(b'abcd', np.uint8), 250000).tobytes()
    comp = bz2.compress(data, 1)
    blocks = bp._scan_magic(np.frombuffer(comp, np.uint8), bp.MAGIC_BYTES)
    assert len(comp) * 8 - int(blocks[0]) > 300000
    _plant_magic(monkeypatch, [int(blocks[0]) + 5000],
                 [int(blocks[i]) + 5000 for i in false_end])
    assert cz.decompress_file_device(comp, device='cpu') == data


def test_cuda_is_required_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        cz.decompress_file_device(bz2.compress(b'abc'))
