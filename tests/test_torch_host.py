"""compressjs_tpu_torch.host (copies of JAX-free host helpers) against
the JAX package's originals."""

import numpy as np
import pytest

from compressjs_tpu import native as native_ref
from compressjs_tpu.codecs import bzip2 as bzip2_ref
from compressjs_tpu.ops import huffman_stages as hs
from compressjs_tpu.ops import rle as rle_ref
from compressjs_tpu.utils import crc32 as crc_ref
from compressjs_tpu_torch.host import bits, crc32, huffman_stages, rle1
from tests import _cpu_share  # noqa: F401 -- caps torch's threads


@pytest.mark.parametrize('data', [b'', b'a', b'hello world' * 1000,
                                  bytes(range(256)) * 7])
def test_crc32(data):
    assert crc32.crc32_bzip2(data) == crc_ref.crc32_bzip2(data)
    arr = np.frombuffer(data, np.uint8)
    assert crc32.crc32_bzip2(arr) == crc_ref.crc32_bzip2(arr)


def test_stream_crc_combine():
    for s, b in [(0, 0x12345678), (0x80000001, 0xFFFFFFFF), (0xDEADBEEF, 1)]:
        assert crc32.stream_crc_combine(s, b) == \
            crc_ref.stream_crc_combine(s, b)


def _runs(seed, n, lens):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 4, n).astype(np.uint8)
    return np.repeat(vals, rng.choice(lens, n))


@pytest.mark.parametrize('case', ['literals', 'runs4', 'long_runs',
                                  'cut_at_count'])
def test_rle1_encode(case):
    if case == 'literals':
        data, bs = np.arange(5000, dtype=np.uint8), 999
    elif case == 'runs4':
        data, bs = _runs(1, 3000, [1, 4, 5]), 2000
    elif case == 'long_runs':
        data, bs = _runs(2, 500, [255, 256, 300, 1000]), 1500
    else:   # a count byte lands on the last slot of a block
        data, bs = np.full(40, 9, dtype=np.uint8), 5
    # the port's native fill against the JAX package's native one, and
    # the port's numpy twin against rle_ref.rle1_encode, which takes its
    # numpy path for inputs this small
    for split, split_ref in [
            (rle1.rle1_encode, lambda d, s, b: native_ref.rle1_encode(
                d[s:], b)),
            (rle1.rle1_encode_plain, rle_ref.rle1_encode)]:
        start = 0
        while start < data.shape[0]:
            got, used = split(data, start, bs)
            want, used_ref = split_ref(data, start, bs)
            np.testing.assert_array_equal(got, want)
            assert used == used_ref
            if used == 0:
                break
            start += used


def test_table_deltas_and_selectors():
    rng = np.random.default_rng(3)
    for _ in range(5):
        lens = rng.integers(1, 21, 258).astype(np.uint8)
        np.testing.assert_array_equal(huffman_stages.emit_table_deltas(lens),
                                      hs.emit_table_deltas(lens))
        g = int(rng.integers(2, 7))
        sel = rng.integers(0, g, 400).astype(np.uint8)
        np.testing.assert_array_equal(
            huffman_stages.selector_mtf_bits(sel, g),
            hs.selector_mtf_bits(sel, g))


def test_bit_writers():
    assert bits.WHOLEPI == bzip2_ref.WHOLEPI
    assert bits.SQRTPI == bzip2_ref.SQRTPI
    w, ref = bits.BitArrayWriter(), bzip2_ref.BitArrayWriter()
    for x in (w, ref):
        x.write_bit(1)
        x.write_bits(24, 0xABCDE)
        x.append(np.array([0, 1, 1], dtype=np.uint8))
    np.testing.assert_array_equal(w.bits(), ref.bits())
    out = bits.BitWriter()
    out.write_bits(3, 0b101)
    out.write_bit_array(np.array([1, 1, 1, 1, 0, 0, 0, 0, 1], np.uint8))
    out.write_bits(4, 0xF)
    assert out.getvalue() == bytes([0b10111110, 0b00011111])
