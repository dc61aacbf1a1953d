"""compressjs_tpu_torch.decompress_file_parallel (whole blocks on host
threads, the native block decoder) against the JAX package's
decompress_file_parallel and stdlib bz2, on generated multi-block streams
and the in-repo goldens: the candidate manifest, both executors, bogus
candidates, blocks appended after the end magic, false end magics, and
the streams the JAX decoder hands to its sequential decoder, which raise
ValueError here."""

import bz2
import os

import numpy as np
import pytest

from compressjs_tpu.codecs import bzip2 as jbz
from compressjs_tpu.parallel import decode as jdec
from compressjs_tpu.utils.crc32 import stream_crc_combine
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bzip2_parse as bp
from compressjs_tpu_torch.parallel import decode as dec

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(800)]
    return b' '.join(words[i] for i in rng.integers(0, 800, n // 4))[:n]


@pytest.fixture(scope='module')
def multiblock():
    """A 4-block level-1 stream of the JAX host codec and its input."""
    data = _text_like(1, 330000)
    return bytes(jbz.compress_file(data, props=1)), data


def _plant_magic(monkeypatch, block_hits=(), end_hits=(), only=None):
    """Make the magic scan also report the given bit positions (or, with
    `only`, report only those block magics), as a payload that holds a
    magic's bit pattern would."""
    scan = bp._scan_magic

    def planted(data, pattern):
        if pattern is bp.MAGIC_BYTES and only is not None:
            return np.asarray(only, dtype=np.int64)
        extra = block_hits if pattern is bp.MAGIC_BYTES else end_hits
        return np.unique(np.concatenate(
            [scan(data, pattern), np.asarray(extra, dtype=np.int64)]))

    monkeypatch.setattr(bp, '_scan_magic', planted)


def test_block_index_matches_jax(multiblock):
    comp, _ = multiblock
    got = dec.block_index(comp)
    np.testing.assert_array_equal(got, jdec.block_index(comp))
    assert len(got) == 4


@pytest.mark.filterwarnings('ignore::DeprecationWarning')
@pytest.mark.parametrize('executor', ['thread', 'process'])
def test_parallel_decode_matches(multiblock, executor):
    # 'process' forks this process (torch loaded, no CUDA context here):
    # the fork warnings are the expected cost of the opt-in path
    comp, data = multiblock
    out = cz.decompress_file_parallel(comp, executor=executor)
    assert out == data
    assert out == bytes(jdec.decompress_file_parallel(
        np.frombuffer(comp, dtype=np.uint8), None, executor='thread'))


@pytest.mark.parametrize('name', ['sample5_bzip2_9.bz2',
                                  'sample5x4_bzip2_9.bz2'])
def test_goldens(name):
    with open(os.path.join(GOLDEN, name), 'rb') as f:
        gold = f.read()
    assert cz.decompress_file_parallel(gold, n_workers=4) == \
        bz2.decompress(gold)


@pytest.mark.parametrize('data', [b'', b'x', b'hello, hello, hello world\n'])
def test_short_streams(data):
    assert cz.decompress_file_parallel(bz2.compress(data, 1)) == data


def test_survives_bogus_candidates(multiblock, monkeypatch):
    """Garbage manifest entries are skipped (they fail to decode or are
    off the chain): the output never changes."""
    comp, data = multiblock
    real = dec.block_index(comp)
    _plant_magic(monkeypatch, [33, 1000, int(real[1]) + 3,
                               len(comp) * 8 - 200])
    assert cz.decompress_file_parallel(comp) == data


@pytest.mark.parametrize('false_end', [[1], [0, 2]])
def test_false_end_magic_inside_a_payload(multiblock, monkeypatch,
                                          false_end):
    comp, data = multiblock
    real = dec.block_index(comp)
    _plant_magic(monkeypatch, end_hits=[int(real[i]) + 5000
                                        for i in false_end])
    assert cz.decompress_file_parallel(comp) == data


def test_first_candidate_mismatch_raises(multiblock, monkeypatch):
    """The JAX decoder hands this stream to its sequential decoder; the
    port has none and raises."""
    comp, data = multiblock
    monkeypatch.setattr(jdec, 'block_index',
                        lambda d: np.array([48, 99999], dtype=np.int64))
    assert bytes(jdec.decompress_file_parallel(
        np.frombuffer(comp, dtype=np.uint8))) == data
    _plant_magic(monkeypatch, only=[48, 99999])
    with pytest.raises(ValueError):
        cz.decompress_file_parallel(comp)


@pytest.mark.parametrize('where', ['payload', 'stream_crc'])
def test_corrupt_stream_raises(multiblock, where):
    comp, _ = multiblock
    bad = bytearray(comp)
    bad[{'payload': 3000, 'stream_crc': len(comp) - 2}[where]] ^= 0x24
    with pytest.raises(ValueError):
        cz.decompress_file_parallel(bytes(bad))


def test_injected_blocks_after_end_magic_are_ignored(multiblock):
    """A second stream's blocks appended after the end magic, then a
    forged end magic whose CRC matches every decodable block: the
    decoder stops at the true end magic, as the reference does."""
    comp, data = multiblock
    extra = np.frombuffer(b'injected payload, not part of the stream. '
                          * 400, dtype=np.uint8)
    comp2 = bytes(jbz.compress_file(extra, None, 1))
    evil = comp + comp2[4:]
    folded = 0
    for blob in (comp, comp2):
        r = jbz._BitReader(np.frombuffer(blob, dtype=np.uint8))
        level = jbz._start(r)
        while True:
            res = jbz._decode_one_block(r, level)
            if res is None:
                break
            folded = stream_crc_combine(folded, res[1])
    evil += int((jbz.SQRTPI << 32) | folded).to_bytes(10, 'big')
    assert cz.decompress_file_parallel(evil) == data
    assert bytes(jdec.decompress_file_parallel(
        np.frombuffer(evil, dtype=np.uint8))) == data


def test_output_file_object(tmp_path, multiblock):
    comp, data = multiblock
    with open(tmp_path / 'out', 'wb') as f:
        assert cz.decompress_file_parallel(comp, f) is f
    assert (tmp_path / 'out').read_bytes() == data


def test_bad_executor(multiblock):
    with pytest.raises(ValueError):
        cz.decompress_file_parallel(multiblock[0], executor='greenlet')
