"""The port's host codec suite (compressjs_tpu_torch.host: the 17 codecs
of the command line, the Bzip2 class, the models and coders) byte for
byte against the JAX package's, by each codec's native body and by its
Python twin, with round trips through both decoders; on the CPU.

The Python twins (``native_body=False``) are held against the JAX
codecs with COMPRESSJS_TPU_NO_NATIVE set for the JAX side only (the
port never reads it), on inputs of at most 4 KB; the native bodies on
inputs of up to 16 KB."""

import bz2
import os
import types

import numpy as np
import pytest

import compressjs_tpu as jcz
import compressjs_tpu_torch as cz
from compressjs_tpu.codecs import bzip2 as jbz
from compressjs_tpu_torch import native
from compressjs_tpu_torch.host import bzip2 as pbz
from compressjs_tpu_torch.host.range_coder import RangeCoder
from compressjs_tpu_torch.host.stream import ArrayInputStream, BufferStream
from compressjs_tpu_torch.parallel import decode as pdecode
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')

# the command line's dispatch keys: (class name, reads a level)
KEYS = {
    'defsum': ('DefSumModel', False), 'fenwick': ('FenwickModel', False),
    'mtf': ('MTFModel', False), 'context1': ('Context1Model', False),
    'no': ('NoModel', False), 'huff': ('Huffman', False),
    'huffman': ('Huffman', False), 'bwtc': ('BWTC', True),
    'bwtcp': ('BWTCP', True), 'bzip': ('Bzip2', True),
    'bzip2': ('Bzip2', True), 'dmc': ('Dmc', False), 'lzjb': ('Lzjb', True),
    'lzjbr': ('LzjbR', True), 'lzp3': ('Lzp3', False), 'ppm': ('PPM', False),
    'simple': ('Simple', False),
}
CASES = [(k, lvl) for k, (_, reads) in KEYS.items()
         for lvl in ((1, 7, 9) if reads else (7,))]


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(600)]
    return b' '.join(words[i] for i in rng.integers(0, 600, n // 3))[:n]


def _input(kind, native_body):
    if kind == 'text':
        return _text_like(11, 16384 if native_body else 4096)
    if kind == 'random':
        return np.random.default_rng(12).integers(
            0, 256, 4096).astype(np.uint8).tobytes()
    if kind == 'runs':
        rng = np.random.default_rng(13)
        return b''.join(bytes([c]) * int(n) for c, n in zip(
            rng.integers(0, 256, 40), rng.integers(1, 200, 40)))[:4096]
    if kind == 'empty':
        return b''
    return b'\x7f'


def _jax_call(monkeypatch, native_body, fn, *args):
    """fn(*args) on the JAX side, on its Python paths for the twin."""
    with monkeypatch.context() as m:
        if not native_body:
            m.setenv('COMPRESSJS_TPU_NO_NATIVE', '1')
        return bytes(np.asarray(fn(*args), dtype=np.uint8))


@pytest.mark.parametrize('native_body', [True, False],
                         ids=['native', 'twin'])
@pytest.mark.parametrize('kind', ['text', 'random', 'runs', 'empty', 'one'])
@pytest.mark.parametrize('key,level', CASES)
def test_codec_matches_jax(monkeypatch, key, level, kind, native_body):
    name = KEYS[key][0]
    P, J = getattr(cz, name), getattr(jcz, name)
    data = _input(kind, native_body)
    want = _jax_call(monkeypatch, native_body, J.compress_file, data, None,
                     level)
    got = bytes(np.asarray(P.compress_file(data, None, level,
                                           native_body=native_body)))
    assert got == want
    back = P.decompress_file(want, native_body=native_body)
    assert bytes(np.asarray(back)) == data
    assert _jax_call(monkeypatch, native_body, J.decompress_file,
                     got) == data


# the native entry each codec's body calls
NATIVE_ENTRY = {
    'Simple': ('simple_encode', 'simple_decode'),
    'Lzjb': ('lzjb_encode', 'lzjb_decode'),
    'LzjbR': ('lzjbr_encode', 'lzjbr_decode'),
    'Lzp3': ('lzp3_encode', 'lzp3_decode'),
    'Dmc': ('dmc_encode', 'dmc_decode'), 'PPM': ('ppm_encode', 'ppm_decode'),
    'MTFModel': ('order0_encode', 'order0_decode'),
    'DefSumModel': ('order0_encode', 'order0_decode'),
    'FenwickModel': ('order0_fenwick_encode', 'order0_fenwick_decode'),
    'Context1Model': ('ctx1_encode', 'ctx1_decode'),
    'Huffman': ('huff_encode', 'huff_decode'),
    'BWTC': ('bwtc_encode_block', 'bwtc_decode_block'),
    'BWTCP': ('bwtc_encode_block', 'bwtc_decode_block'),
    'Bzip2': ('mtf_rle2', 'bz2_block_full'),
}


@pytest.mark.parametrize('name', sorted(NATIVE_ENTRY))
def test_native_body_is_taken_by_name(monkeypatch, name):
    """native_body=True reaches the codec's native entries (encode and
    decode) on the streams the entry points make; False reaches none."""
    calls = []
    for entry in NATIVE_ENTRY[name]:
        real = getattr(native, entry)

        def counted(*a, _real=real, _entry=entry, **k):
            calls.append(_entry)
            return _real(*a, **k)
        monkeypatch.setattr(native, entry, counted)
    P = getattr(cz, name)
    data = _text_like(14, 3000)
    comp = P.compress_file(data, None, 9)
    assert bytes(np.asarray(P.decompress_file(comp))) == data
    assert set(calls) == set(NATIVE_ENTRY[name])
    calls.clear()
    comp = P.compress_file(data, None, 9, native_body=False)
    back = P.decompress_file(comp, native_body=False)
    assert bytes(np.asarray(back)) == data
    assert calls == []


class _ByteStream:
    """A byte sink with write_byte only (no write_array)."""

    def __init__(self):
        self.data = bytearray()

    def write_byte(self, b):
        self.data.append(b & 0xFF)

    def write(self, buf, off, n):
        self.data += bytes(bytearray(buf[off:off + n]))
        return n

    def flush(self):
        pass


@pytest.mark.parametrize('name', ['Lzp3', 'PPM', 'Dmc', 'LzjbR', 'Simple'])
def test_stream_without_write_array_takes_the_twin(name):
    """An output stream that takes no whole arrays gets the Python twin
    (the JAX package's rule), with the same bytes."""
    data = _text_like(15, 2000)
    sink = _ByteStream()
    getattr(cz, name).compress_file(data, sink)
    assert bytes(sink.data) == bytes(getattr(jcz, name).compress_file(data))


# --- Bzip2 beyond compress_file / decompress_file -------------------------

@pytest.fixture(scope='module')
def golden():
    with open(os.path.join(GOLDEN, 'sample5x4_bzip2_9.bz2'), 'rb') as f:
        return f.read()


def test_bzip2_golden_table_and_every_block(golden):
    pos = []
    cz.Bzip2.table(golden, lambda p, n: pos.append((p, n)))
    assert len(pos) == 10
    pieces = []
    for p, n in pos:
        got = bytes(np.asarray(cz.Bzip2.decompress_block(golden, p)))
        assert got == bytes(np.asarray(jcz.Bzip2.decompress_block(golden,
                                                                  p)))
        assert len(got) == n
        pieces.append(got)
    assert b''.join(pieces) == bz2.decompress(golden)


def test_bzip2_table_matches_jax():
    stream = bytes(jbz.compress_file(_text_like(16, 230000), None, 1))
    got, want = [], []
    cz.Bzip2.table(stream, lambda p, n: got.append((p, n)))
    jcz.Bzip2.table(stream, lambda p, n: want.append((p, n)))
    assert got == want and len(got) == 3


def test_bzip2_multistream():
    a, b = _text_like(17, 3000), b'second stream'
    two = bytes(jbz.compress_file(a, None, 1)) + \
        bytes(jbz.compress_file(b, None, 9))
    for nb in (True, False):
        got = bytes(np.asarray(cz.Bzip2.decompress_file(
            two, multistream=True, native_body=nb)))
        assert got == a + b
    assert bytes(np.asarray(cz.Bzip2.decompress_file(two))) == \
        bytes(np.asarray(jcz.Bzip2.decompress_file(two))) == a


def test_bzip2_parallel_dispatch(monkeypatch):
    """A multi-block single-stream input over 64 KB goes to the port's
    parallel host decode; COMPRESSJS_TPU_NO_PARALLEL keeps it
    sequential, as in the JAX package."""
    data = _text_like(18, 110000) + np.random.default_rng(18).integers(
        0, 256, 120000).astype(np.uint8).tobytes()
    stream = bytes(jbz.compress_file(data, None, 1))
    assert len(stream) > pbz.PARALLEL_MIN_BYTES
    calls = []
    real = pdecode.decompress_file_parallel

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(pdecode, 'decompress_file_parallel', counted)
    monkeypatch.setattr(os, 'cpu_count', lambda: 4)
    assert bytes(np.asarray(cz.Bzip2.decompress_file(stream))) == data
    assert calls == [1]
    monkeypatch.setenv('COMPRESSJS_TPU_NO_PARALLEL', '1')
    assert bytes(np.asarray(cz.Bzip2.decompress_file(stream))) == data
    assert calls == [1]


@pytest.mark.parametrize('case', ['magic', 'block_crc', 'truncated'])
def test_bzip2_error_on_corrupt_stream(case):
    stream = bytearray(jbz.compress_file(_text_like(19, 5000), None, 9))
    if case == 'magic':
        stream[0] = ord('X')
    elif case == 'block_crc':
        stream[10] ^= 0x40          # inside the block's stored CRC
    else:
        stream = stream[:len(stream) // 2]
    with pytest.raises(jbz.Bzip2Error) as want:
        jcz.Bzip2.decompress_file(bytes(stream))
    with pytest.raises(pbz.Bzip2Error) as got:
        cz.Bzip2.decompress_file(bytes(stream))
    assert isinstance(got.value, ValueError)
    assert got.value.error_code == want.value.error_code
    assert str(got.value) == str(want.value)
    assert pbz.Err.DATA_ERROR == jbz.Err.DATA_ERROR


# --- the models and coders of the toolkit ---------------------------------

@pytest.mark.parametrize('name', ['LogDistanceModel', 'DeflateDistanceModel'])
def test_distance_models_match_jax(name):
    from compressjs_tpu.coders.range_coder import RangeCoder as JRC
    from compressjs_tpu.utils.stream import BufferStream as JBS
    vals = [0, 1, 2, 3, 4, 5, 100, 1023, 1024, 4095, -1, 7, 7, 2000]

    def encode(cls, rc, bs, fenwick):
        out = bs()
        enc = rc(out)
        enc.encode_start(0, 0)
        mf = fenwick.factory(enc)
        m = cls(4096, 1, mf, mf)
        for v in vals:
            m.encode(v)
        enc.encode_finish()
        return bytes(out.get_buffer())

    got = encode(getattr(cz, name), RangeCoder, BufferStream, cz.FenwickModel)
    assert got == encode(getattr(jcz, name), JRC, JBS, jcz.FenwickModel)
    dec = RangeCoder(ArrayInputStream(got))
    dec.decode_start()
    mf = cz.FenwickModel.factory(dec)
    m = getattr(cz, name)(4096, 1, mf, mf)
    assert [m.decode() for _ in vals] == vals


def test_dummy_range_coder_matches_jax():
    from compressjs_tpu.utils.stream import BufferStream as JBS

    def encode(cls, bs):
        out = bs()
        enc = cls(out)
        enc.encode_start(0, 0)
        enc.encode_freq(3, 4, 10)
        enc.encode_shift(1, 5, 4)
        enc.encode_bit(1)
        enc.encode_finish()
        return bytes(out.get_buffer())

    got = encode(cz.DummyRangeCoder, BufferStream)
    assert got == encode(jcz.DummyRangeCoder, JBS)
    dec = cz.DummyRangeCoder(ArrayInputStream(got))
    dec.decode_start()
    assert 4 <= dec.decode_cul_freq(10) < 7
    dec.decode_update(3, 4, 10)
    assert dec.decode_cul_shift(4) == 5
    dec.decode_update(1, 5, 16)
    assert dec.decode_bit() == 1


def test_huffman_and_mtf_models_match_jax():
    """The adaptive Vitter coder over a BitStream and the MTF-list model
    (with better_escape) over the range coder, symbol by symbol."""
    from compressjs_tpu.coders.range_coder import RangeCoder as JRC
    from compressjs_tpu.utils.stream import BitStream as JBits
    from compressjs_tpu.utils.stream import BufferStream as JBS
    syms = np.random.default_rng(20).zipf(1.4, 3000) % 200

    def huff(cls, bits, bs):
        out = bs()
        b = bits(out)
        h = cls(200, 200, b, 1000)
        for s in syms.tolist():
            h.encode(s)
        b.flush()
        return bytes(out.get_buffer())

    def mtf(cls, rc, bs):
        out = bs()
        enc = rc(out)
        enc.encode_start(0, 0)
        m = cls(enc, 200, None, None, True)
        for s in syms.tolist():
            m.encode(s)
        enc.encode_finish()
        return bytes(out.get_buffer())

    from compressjs_tpu_torch.host.stream import BitStream
    assert huff(cz.Huffman, BitStream, BufferStream) == \
        huff(jcz.Huffman, JBits, JBS)
    got = mtf(cz.MTFModel, RangeCoder, BufferStream)
    assert got == mtf(jcz.MTFModel, JRC, JBS)
    dec = RangeCoder(ArrayInputStream(got))
    dec.decode_start()
    m = cz.MTFModel(dec, 200, None, None, True)
    assert [m.decode() for _ in syms] == syms.tolist()


def test_namespace_matches_jax():
    names = ['Stream', 'BitStream', 'BWT', 'RangeCoder', 'DummyRangeCoder',
             'Huffman', 'HuffmanAllocator', 'MTFModel', 'FenwickModel',
             'DefSumModel', 'Context1Model', 'NoModel', 'LogDistanceModel',
             'DeflateDistanceModel', 'Bzip2', 'BWTC', 'BWTCP', 'Lzp3', 'Lzjb',
             'LzjbR', 'PPM', 'Dmc', 'Simple', 'version']
    for n in names:
        assert hasattr(cz, n), n
    assert cz.version == jcz.version
    public = {n for n in jcz.__dir__() if not n.startswith('_')}
    subpackages = {n for n in public
                   if isinstance(getattr(jcz, n), types.ModuleType)
                   and getattr(jcz, n).__name__ == 'compressjs_tpu.' + n}
    assert public - subpackages <= set(cz.__dir__())


def test_config_matches_jax():
    from compressjs_tpu import config as jcfg
    from compressjs_tpu_torch import config as pcfg
    assert {k: vars(v) for k, v in pcfg.DEFAULTS.items()} == \
        {k: vars(v) for k, v in jcfg.DEFAULTS.items()}


# --- the bindings' checks ---------------------------------------------------

def test_bindings_check_state_and_shapes():
    data = np.frombuffer(b'abc', dtype=np.uint8)
    with pytest.raises(ValueError):
        native.lzp3_encode(data, np.zeros(4, dtype=np.int64))
    with pytest.raises(ValueError):
        native.ppm_encode(data, 256, -1, np.zeros(5, dtype=np.int32))
    with pytest.raises(ValueError):
        native.dmc_encode(data, 64, -1, 8, 128, np.zeros(5, np.int64))
    with pytest.raises(ValueError):
        native.order0_encode('fenwick', data, 256, -1, np.zeros(5, np.int64))
    with pytest.raises(ValueError):
        native.lzjb_encode(data, 1000, 1)
    with pytest.raises(ValueError):
        native.huff_decode(data, -1)
    # a corrupt LZJB-R body cannot write past the output it asked for
    st = RangeCoder(ArrayInputStream(b'')).export_dec_state(0)
    out = native.lzjbr_decode(np.full(64, 0xFF, np.uint8), st, 5)
    assert out.shape == (5,)
