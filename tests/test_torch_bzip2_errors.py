"""The port's `Bzip2` codec on corrupt streams against the JAX codec's,
on the CPU: for every input, `decompress_file` (native body and Python
twin), `decompress_block` and `table` give the same bytes, or raise the
same exception type with the same `error_code` and the same `str(e)`.

The inputs are two streams, one under and one over the codec's
parallel-decode threshold (`PARALLEL_MIN_BYTES`), each with named
corruptions (the stream and block headers, an obsolete randomised block,
truncation, a flipped payload byte) and a seeded set of single-byte
flips and truncations; sample5 is decoded from the in-repo golden."""

import os

import numpy as np
import pytest

import compressjs_tpu as jcz
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bzip2 as pbz
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')
N_FLIPS, N_CUTS = 30, 20     # seeded corruptions of each stream
FIRST_BLOCK = 32             # the bit after the 'BZh#' header


@pytest.fixture(scope='module')
def sample5():
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        return bytes(np.asarray(jcz.Bzip2.decompress_file(f.read())))


def _streams(sample5):
    """{'small': (stream, second block's bit or None), 'large': ...}: a
    one-block level-9 stream of 20 KB of sample5, and a two-block
    level-1 stream of sample5 and seeded random bytes whose compressed
    size passes the parallel threshold."""
    small = sample5[:20000]
    rng = np.random.default_rng(16)
    large = sample5[:40000] + rng.integers(0, 256, 90000,
                                           np.uint8).tobytes()
    out = {}
    for name, data, level in (('small', small, 9), ('large', large, 1)):
        stream = bytes(np.asarray(jcz.Bzip2.compress_file(data, None,
                                                          level)))
        blocks = []
        jcz.Bzip2.table(stream, lambda pos, size: blocks.append(pos))
        out[name] = (stream, blocks[1] if len(blocks) > 1 else None)
    assert len(out['small'][0]) < pbz.PARALLEL_MIN_BYTES < len(
        out['large'][0])
    return out


def _corrupt(stream, case):
    """The stream with one named or seeded corruption."""
    s = bytearray(stream)
    if case == 'empty':
        return b''
    if case == 'stream_magic':
        s[0] = ord('X')
    elif case == 'level_0':
        s[3] = ord('0')
    elif case == 'block_magic':
        s[4] ^= 0xFF
    elif case == 'half':
        s = s[:len(s) // 2]
    elif case == 'payload_byte':
        s[len(s) // 3] ^= 0x10
    elif case == 'randomised':
        s[14] |= 0x80            # the flag bit after magic and block CRC
    elif case.startswith('flip'):
        rng = np.random.default_rng(1000 + int(case[4:]))
        pos = int(rng.integers(4, len(s)))
        s[pos] ^= int(rng.integers(1, 256))
    else:                        # 'cutN'
        rng = np.random.default_rng(2000 + int(case[3:]))
        s = s[:int(rng.integers(4, len(s)))]
    return bytes(s)


NAMED = ['empty', 'stream_magic', 'level_0', 'block_magic', 'half',
         'payload_byte', 'randomised']
CASES = [(size, case) for size in ('small', 'large')
         for case in NAMED + ['flip%d' % i for i in range(N_FLIPS)]
         + ['cut%d' % i for i in range(N_CUTS)]]


def _outcome(fn):
    """('ok', result) or (exception type name, error_code, str(e))."""
    try:
        res = fn()
    except Exception as e:   # noqa: BLE001 -- the type is compared
        return (type(e).__name__, isinstance(e, ValueError),
                getattr(e, 'error_code', None), str(e))
    return ('ok', res)


def _file(codec, stream, **kw):
    return lambda: bytes(np.asarray(codec.decompress_file(stream, **kw)))


def _block(codec, stream, pos):
    return lambda: bytes(np.asarray(codec.decompress_block(stream, pos)))


def _table(codec, stream, **kw):
    def run():
        seen = []
        codec.table(stream, lambda pos, size: seen.append((pos, size)), **kw)
        return seen
    return run


@pytest.fixture(scope='module')
def streams(sample5):
    return _streams(sample5)


@pytest.mark.parametrize('size,case', CASES,
                         ids=['%s-%s' % c for c in CASES])
def test_corrupt_stream_outcomes_match_jax(streams, size, case):
    stream, second = streams[size]
    bad = _corrupt(stream, case)
    want = _outcome(_file(jcz.Bzip2, bad))
    assert _outcome(_file(cz.Bzip2, bad)) == want
    assert _outcome(_file(cz.Bzip2, bad, native_body=False)) == want
    for pos in (FIRST_BLOCK, second):
        if pos is not None:
            assert (_outcome(_block(cz.Bzip2, bad, pos))
                    == _outcome(_block(jcz.Bzip2, bad, pos)))
    assert _outcome(_table(cz.Bzip2, bad)) == _outcome(_table(jcz.Bzip2,
                                                              bad))


def test_named_messages(streams):
    """The messages the JAX codec gives for the named cases, spelled
    out (the card's smoke holds the command line to these texts)."""
    stream, _ = streams['small']
    msgs = {case: _outcome(_file(cz.Bzip2, _corrupt(stream, case)))[3]
            for case in NAMED}
    assert msgs['empty'] == msgs['stream_magic'] == 'Not bzip data: bad magic'
    assert msgs['level_0'] == 'Not bzip data: level out of range'
    assert msgs['block_magic'] == 'Not bzip data'
    assert msgs['half'] == 'Data error'
    assert msgs['payload_byte'].startswith('Data error: Bad block CRC (got ')
    assert msgs['randomised'] == ('Obsolete (pre 0.9.5) bzip format not '
                                  'supported.')


@pytest.mark.parametrize('multistream', [False, True])
def test_table_block_size_change(streams, sample5, multistream):
    """`table` over two concatenated streams of different levels: the
    first stream's blocks alone, or the JAX codec's AssertionError."""
    two = streams['small'][0] + bytes(np.asarray(
        jcz.Bzip2.compress_file(sample5[:3000], None, 1)))
    want = _outcome(_table(jcz.Bzip2, two, multistream=multistream))
    assert _outcome(_table(cz.Bzip2, two, multistream=multistream)) == want
    assert want[0] == ('AssertionError' if multistream else 'ok')


def test_multistream_decode_after_corrupt_second_stream(streams):
    """A multistream decode whose second stream has a bad header."""
    bad = streams['small'][0] + b'BZh0' + bytes(20)
    want = _outcome(_file(jcz.Bzip2, bad, multistream=True))
    assert want[0] == 'Bzip2Error'
    for native_body in (True, False):
        assert _outcome(_file(cz.Bzip2, bad, multistream=True,
                              native_body=native_body)) == want
