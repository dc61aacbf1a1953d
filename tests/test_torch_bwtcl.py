"""The BWTC-L codec: the host copy (compressjs_tpu_torch.host.bwtcl)
against ``compressjs_tpu.codecs.bwtcl``, its Python twins against the
native runtime, the lane block encode and decode
(ops.device_lane) against the JAX package's, and the entry points
``bwtcl_compress_device`` / ``bwtcl_decompress_device`` with
device='cpu' (each kernel's plain version) against the JAX host bytes
and back.  Inputs come from numpy seeds and the in-repo golden.  Every
comparison is exact."""

import bz2
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.codecs import bwtcl as jbwtcl
from compressjs_tpu.ops import device_lane as jdl
import compressjs_tpu_torch as cz
from compressjs_tpu_torch import native
from compressjs_tpu_torch.host import bwtcl as hbwtcl
from compressjs_tpu_torch.ops import device_lane as dl
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
    if kind == 'text_130k':    # level 1: a full block and a tail
        return _text_like(1, 130000)
    if kind == 'random_20k':   # all 256 byte values: the Python lane coder
        return np.random.default_rng(2).integers(
            0, 256, 20000).astype(np.uint8).tobytes()
    raise ValueError(kind)


@pytest.fixture(scope='module')
def sample5():
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        return bz2.decompress(f.read())


@pytest.mark.parametrize('level', [1, 2])
@pytest.mark.parametrize('kind', ['empty', 'one', 'text_130k', 'random_20k'])
def test_host_codec_matches_jax(kind, level):
    data = _input(kind)
    want = bytes(jbwtcl.BWTCL.compress_file(data, None, level))
    got = bytes(hbwtcl.BWTCL.compress_file(data, None, level))
    assert got == want
    assert bytes(hbwtcl.BWTCL.decompress_file(got)) == data


@pytest.mark.parametrize('asize,n', [(3, 0), (20, 1), (60, 3000),
                                     (255, 2000)])
def test_python_lane_coder_equals_native(asize, n):
    """The lane coder's Python twin (FenwickModel over RangeCoder) and the
    native order-0 entries give the same bytes and decode each other."""
    rng = np.random.default_rng(asize)
    syms = np.minimum(rng.zipf(1.4, n) - 1, asize).astype(np.int32)
    nat = hbwtcl._encode_lane(syms, asize)
    twin = hbwtcl._encode_lane(syms, asize, plain=True)
    np.testing.assert_array_equal(nat, twin)
    np.testing.assert_array_equal(hbwtcl._decode_lane(nat, asize, n), syms)
    np.testing.assert_array_equal(
        hbwtcl._decode_lane(nat, asize, n, plain=True), syms)
    np.testing.assert_array_equal(nat, jbwtcl._encode_lane(syms, asize))


def test_order0_fenwick_matches_jax_native():
    from compressjs_tpu import native as jnative
    rng = np.random.default_rng(6)
    data = np.minimum(rng.zipf(1.3, 5000) - 1, 40).astype(np.uint8)
    st = np.array([0, 1 << 31, 7, 0, 1], np.int64)
    jst = st.copy()
    got = native.order0_fenwick_encode(data, 41, 40, st)
    want = jnative.order0_fenwick_encode(data, 41, 40, jst)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(st, jst)
    with pytest.raises(ValueError):
        native.order0_fenwick_encode(data, 40, -1, st.copy())


@pytest.mark.parametrize('kind', ['text_130k', 'random_20k'])
def test_rle2_symbols_twin_and_undo(kind):
    block = np.frombuffer(_input(kind), np.uint8)[:100000]
    U, _ = native.bwt_eof(block)
    used = np.zeros(256, bool)
    used[block] = True
    syms, asize = hbwtcl.rle2_symbols(U, used)
    twin, _ = hbwtcl.rle2_symbols(U, used, plain=True)
    jsyms, jasize = jbwtcl.rle2_symbols(U, used)
    np.testing.assert_array_equal(syms, twin)
    np.testing.assert_array_equal(syms, jsyms)
    assert asize == jasize
    mtf = hbwtcl.rle2_undo(syms, len(block))
    np.testing.assert_array_equal(mtf, jbwtcl.rle2_undo(syms, len(block)))
    with pytest.raises(ValueError):
        hbwtcl.rle2_undo(syms, len(block) + 1)


@pytest.fixture(scope='module')
def lane_block(sample5):
    """sample5's first 100,000 bytes through the JAX lane encode."""
    block = np.frombuffer(sample5[:100000], np.uint8)
    used = np.zeros(256, bool)
    used[block] = True
    alphabet = np.flatnonzero(used)
    remap = np.zeros(256, np.int32)
    remap[alphabet] = np.arange(len(alphabet))
    want = [np.asarray(x) for x in jdl.encode_block_lanes(
        jnp.asarray(block), 100000, 128, jnp.asarray(remap),
        jnp.int32(len(alphabet)))]
    return block, alphabet, remap, want


def test_encode_block_lanes_matches_jax(lane_block):
    """bs = 100,000 at 128 lanes: pidx, S, lane lengths, the flat bytes,
    their total and the largest token count."""
    block, alphabet, remap, want = lane_block
    got = dl.encode_block_lanes(torch.from_numpy(block.copy()), 100000, 128,
                                torch.from_numpy(remap).to(torch.int64),
                                len(alphabet))
    for name, g, w in zip(('pidx', 'S', 'lens', 'flat', 'total', 'max_tok'),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_decode_block_lanes_matches_jax(lane_block):
    block, alphabet, _, (pidx, S, lens, flat, total, _) = lane_block
    _, _, lane_cap = dl.lane_caps(100000, 128)
    paymat = np.zeros((128, lane_cap), np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)])
    for l in range(128):
        paymat[l, :lens[l]] = flat[offs[l]:offs[l + 1]]
    sym_map = np.zeros(256, np.int64)
    sym_map[:len(alphabet)] = alphabet
    out, n = dl.decode_block_lanes(torch.from_numpy(paymat), 100000, 128,
                                   int(S), int(pidx), len(alphabet),
                                   torch.from_numpy(sym_map))
    jout, jn = jdl.decode_block_lanes(
        jnp.asarray(paymat), 100000, 128, jnp.int32(int(S)),
        jnp.int32(int(pidx)), jnp.int32(len(alphabet)),
        jnp.asarray(sym_map.astype(np.int32)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert int(n) == int(jn) == 100000
    np.testing.assert_array_equal(out.numpy(), block)


@pytest.mark.parametrize('W,lens', [(5, [3, 0, 5, 1]), (4, [0, 0, 0, 0]),
                                    (7, [7, 7, 2, 0])])
def test_ragged_concat_matches_jax(W, lens):
    rng = np.random.default_rng(W)
    byts = rng.integers(0, 256, (len(lens), W)).astype(np.uint8)
    lens = np.array(lens, np.int32)
    got, total = dl.ragged_concat(torch.from_numpy(byts),
                                  torch.from_numpy(lens), 30)
    want, jtotal = jdl.ragged_concat(jnp.asarray(byts), jnp.asarray(lens), 30)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(total) == int(jtotal)


@pytest.mark.parametrize('n', [100000, 150000])
def test_device_encode_matches_jax_host(sample5, n):
    """One level-1 block, and one block and a 50,000-byte tail."""
    data = sample5[:n]
    want = bytes(jbwtcl.BWTCL.compress_file(data, None, 1))
    got = bytes(cz.bwtcl_compress_device(data, None, 1, device='cpu'))
    assert got == want
    assert pipeline.bwtcl_compress_device.last_stats == {
        'device_blocks': 1, 'host_blocks': n // 100000 - 1 + (n % 100000 > 0),
        'overflow_blocks': 0}


def test_device_encode_few_symbols_takes_the_host(sample5):
    """A block of fewer RLE2 symbols than lanes records fewer lanes in the
    format, so it takes the host encoder and still equals it (the JAX
    device path writes 128 lane sizes for it)."""
    data = bytes(100000) + sample5[:100000]
    want = bytes(jbwtcl.BWTCL.compress_file(data, None, 1))
    assert bytes(cz.bwtcl_compress_device(data, None, 1,
                                          device='cpu')) == want
    assert pipeline.bwtcl_compress_device.last_stats == {
        'device_blocks': 1, 'host_blocks': 1, 'overflow_blocks': 0}


def test_device_decode_round_trips(sample5):
    data = sample5[:120000]
    host = bytes(hbwtcl.BWTCL.compress_file(data, None, 1))
    assert bytes(cz.bwtcl_decompress_device(host, device='cpu')) == data
    assert pipeline.bwtcl_decompress_device.last_stats == {
        'device_blocks': 1, 'host_blocks': 1, 'overflow_blocks': 0}
    dev = bytes(cz.bwtcl_compress_device(data[:100000], None, 1,
                                         device='cpu'))
    assert bytes(cz.bwtcl_decompress_device(dev, device='cpu')) == \
        data[:100000]


def test_device_decode_any_lane_count(monkeypatch, sample5):
    """A stream written with 40 lanes decodes on the device path too."""
    monkeypatch.setattr(hbwtcl, 'LANES', 40)
    data = sample5[:100000]
    comp = bytes(hbwtcl.BWTCL.compress_file(data, None, 1))
    monkeypatch.undo()
    assert bytes(cz.bwtcl_decompress_device(comp, device='cpu')) == data
    assert pipeline.bwtcl_decompress_device.last_stats['device_blocks'] == 1


def test_device_decode_rejects_bad_magic():
    with pytest.raises(ValueError):
        cz.bwtcl_decompress_device(b'bwtP\x81\x01\x00', device='cpu')


def test_bwtcl_compress_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        cz.bwtcl_compress_device(b'abc')
    assert bytes(cz.bwtcl_compress_device(b'abc', device='cpu')) == \
        bytes(jbwtcl.BWTCL.compress_file(b'abc', None, 9))


def test_bwtcl_decompress_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    comp = bytes(hbwtcl.BWTCL.compress_file(b'abc', None, 9))
    with pytest.raises(RuntimeError):
        cz.bwtcl_decompress_device(comp)
    assert bytes(cz.bwtcl_decompress_device(comp, device='cpu')) == b'abc'
