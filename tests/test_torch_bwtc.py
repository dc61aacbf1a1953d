"""The BWTC codec on the host (compressjs_tpu_torch.host.bwtc) and
DeviceBWTCEncoder (parallel.pipeline) byte for byte against
``compressjs_tpu.codecs.bwtc`` and the JAX DeviceBWTCEncoder, with round
trips through both packages' decoders; the native block coder
(cz_bwtc_encode_block / cz_bwtc_decode_block) against its Python twin;
on the CPU."""

import bz2
import os
import threading

import numpy as np
import pytest
import torch

from compressjs_tpu.codecs import bwtc as jbwtc
from compressjs_tpu.parallel import pipeline as jpl
import compressjs_tpu_torch as cz
from compressjs_tpu_torch import native
from compressjs_tpu_torch.host import bwtc as hbwtc
from compressjs_tpu_torch.host.range_coder import RangeCoder
from compressjs_tpu_torch.host.stream import (ArrayInputStream, BufferStream,
                                              Stream)
from compressjs_tpu_torch.parallel import pipeline
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(800)]
    return b' '.join(words[i] for i in rng.integers(0, 800, n // 4))[:n]


def _input(kind):
    if kind == 'empty':
        return b''
    if kind == 'one':
        return b'x'
    if kind == 'text_5k':
        return _text_like(1, 5000)
    if kind == 'random_120k':
        return np.random.default_rng(2).integers(
            0, 256, 120000).astype(np.uint8).tobytes()
    if kind == 'text_250k':    # level 1: 2 full blocks and a tail
        return _text_like(3, 250000)
    raise ValueError(kind)


@pytest.fixture(scope='module')
def sample5():
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        return bz2.decompress(f.read())


@pytest.mark.parametrize('level', [1, 5, 6, 9])
@pytest.mark.parametrize('kind', ['empty', 'one', 'text_5k', 'random_120k',
                                  'text_250k'])
def test_host_codec_matches_jax(kind, level):
    data = _input(kind)
    got = bytes(hbwtc.BWTC.compress_file(data, None, level))
    want = bytes(jbwtc.BWTC.compress_file(data, None, level))
    assert got == want
    assert bytes(hbwtc.BWTC.decompress_file(want)) == data
    assert bytes(jbwtc.BWTC.decompress_file(got)) == data


def test_sample5_level9(sample5):
    got = bytes(hbwtc.BWTC.compress_file(sample5, None, 9))
    assert got == bytes(jbwtc.BWTC.compress_file(sample5, None, 9))
    assert bytes(hbwtc.BWTC.decompress_file(got)) == sample5


class _ByteSink(Stream):
    """An output stream without write_array: the codec codes each block
    body with the Python twin."""

    def __init__(self):
        self.data = bytearray()

    def write_byte(self, byte):
        self.data.append(byte & 0xFF)


class _ByteSource(Stream):
    """An input stream that is no ArrayInputStream: the decoder decodes
    each block body with the Python twin."""

    def __init__(self, data):
        self.data, self.pos = bytes(data), 0

    def read_byte(self):
        if self.pos >= len(self.data):
            return -1
        self.pos += 1
        return self.data[self.pos - 1]


@pytest.mark.parametrize('level', [1, 9])
@pytest.mark.parametrize('n', [0, 3000, 20000])
def test_python_coder_twin(level, n):
    """The whole codec with the Python block coder (DefSum at level 1,
    Fenwick at 9) on inputs of up to 20 KB."""
    data = _text_like(n, n)
    want = bytes(jbwtc.BWTC.compress_file(data, None, level))
    sink = _ByteSink()
    assert hbwtc.BWTC.compress_file(data, sink, level) is sink
    assert bytes(sink.data) == want
    out = _ByteSink()
    hbwtc.BWTC.decompress_file(_ByteSource(want), out)
    assert bytes(out.data) == data


@pytest.mark.parametrize('fast', [True, False])
def test_native_block_coder_equals_twin(fast):
    """cz_bwtc_encode_block and cz_bwtc_decode_block continue a coder
    that Python coded a byte on, exactly as the Python model loop does."""
    rng = np.random.default_rng(int(fast))
    asize = 30
    mtf = np.minimum(rng.zipf(1.4, 30000) - 1, asize - 1).astype(np.int32)
    mtf[1000:9000] = 0                     # one long zero run

    def start():
        out = BufferStream()
        enc = RangeCoder(out)
        enc.encode_start(0x80, 1)
        enc.encode_byte(7)
        return out, enc

    out_n, enc_n = start()
    st = enc_n.export_enc_state()
    out_n.write_array(native.bwtc_encode_block(mtf, asize, fast, st))
    enc_n.import_enc_state(st)
    out_p, enc_p = start()
    hbwtc._encode_block_plain(enc_p, mtf, asize, fast)
    assert enc_n.export_enc_state().tolist() == \
        enc_p.export_enc_state().tolist()
    enc_n.encode_finish()
    enc_p.encode_finish()
    stream = bytes(out_n.get_buffer())
    assert stream == bytes(out_p.get_buffer())

    def decoder(src):
        dec = RangeCoder(src)
        dec.decode_start(True)
        assert dec.decode_byte() == 7
        return dec

    got_p = hbwtc._decode_block_plain(decoder(_ByteSource(stream[1:])),
                                      asize, fast, len(mtf))
    np.testing.assert_array_equal(got_p, mtf)
    src = ArrayInputStream(stream[1:])
    dec = decoder(src)
    st = dec.export_dec_state(src.pos)
    got_n = native.bwtc_decode_block(src.data, st, asize, fast, len(mtf))
    np.testing.assert_array_equal(got_n, mtf)
    with pytest.raises(ValueError):     # the long zero run overruns
        native.bwtc_decode_block(src.data, dec.export_dec_state(src.pos),
                                 asize, fast, 1500)


def test_device_encoder_matches_jax_and_host():
    """DeviceBWTCEncoder(device='cpu') at level 1 on 2 full blocks and a
    tail: the JAX DeviceBWTCEncoder's bytes and the host codec's."""
    data = _input('text_250k')
    got = bytes(cz.DeviceBWTCEncoder(1, device='cpu').compress(data))
    assert got == bytes(jpl.DeviceBWTCEncoder(1).compress(data))
    assert got == bytes(hbwtc.BWTC.compress_file(data, None, 1))
    assert bytes(jbwtc.BWTC.decompress_file(got)) == data


def test_device_encoder_uses_device_bwt(monkeypatch):
    """The full blocks take the device transform (twice the same block:
    one result, keyed by content), the tail the host one, and no worker
    outlives the call."""
    calls = []
    real = pipeline.bk.bwt_eof_block

    def spy(block, n):
        calls.append(n)
        return real(block, n)

    monkeypatch.setattr(pipeline.bk, 'bwt_eof_block', spy)
    block = np.frombuffer(_text_like(4, 100000), np.uint8)
    data = np.concatenate([block, block, block[:777]])
    before = threading.active_count()
    got = bytes(cz.DeviceBWTCEncoder(1, device='cpu').compress(data))
    assert threading.active_count() == before
    assert calls == [100000]
    assert got == bytes(jbwtc.BWTC.compress_file(data, None, 1))


def test_device_encoder_immune_to_job_order(monkeypatch):
    """The codec's transform pool may run the hook's jobs in any order:
    with every job deferred and the first two swapped, each block still
    gets its own transform."""
    import concurrent.futures as cf

    class LazyFuture(cf.Future):
        def __init__(self, owner):
            super().__init__()
            self._owner = owner

        def result(self, timeout=None):
            self._owner.drain()
            return super().result(timeout)

    class SwappedExecutor:
        def __init__(self, *a, **k):
            self._q = []

        def submit(self, fn, *args):
            f = LazyFuture(self)
            self._q.append((f, fn, args))
            return f

        def drain(self):
            q, self._q = self._q, []
            if len(q) > 1:
                q[0], q[1] = q[1], q[0]
            for f, fn, args in q:
                f.set_result(fn(*args))

        def shutdown(self, *a, **k):
            self.drain()

    data = _input('text_250k')
    want = bytes(jbwtc.BWTC.compress_file(data, None, 1))
    monkeypatch.setattr(hbwtc, 'ThreadPoolExecutor', SwappedExecutor)
    assert bytes(cz.DeviceBWTCEncoder(1, device='cpu').compress(data)) \
        == want


def test_device_encoder_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        cz.DeviceBWTCEncoder(9)
    for level in (0, 10):
        with pytest.raises(ValueError):
            cz.DeviceBWTCEncoder(level, device='cpu')


def test_no_model_over_bitstream():
    """NoModel's fixed-width codes through a BitStream, against the JAX
    package's pair, and back."""
    from compressjs_tpu.models.no_model import NoModel as JaxNoModel
    from compressjs_tpu.utils.stream import BitStream as JaxBitStream
    from compressjs_tpu.utils.stream import BufferStream as JaxBuffer
    from compressjs_tpu_torch.host.no_model import NoModel
    from compressjs_tpu_torch.host.stream import ArrayInputStream, BitStream
    symbols = np.random.default_rng(4).integers(0, 300, 500).tolist()
    out, jout = BufferStream(), JaxBuffer()
    bits, jbits = BitStream(out), JaxBitStream(jout)
    model, jmodel = NoModel(bits, 300), JaxNoModel(jbits, 300)
    for sym in symbols:
        model.encode(sym)
        jmodel.encode(sym)
    bits.flush()
    jbits.flush()
    got = bytes(out.get_buffer())
    assert got == bytes(jout.get_buffer())
    back = NoModel(BitStream(ArrayInputStream(got)), 300)
    assert [back.decode() for _ in symbols] == symbols
