"""compressjs_tpu_torch.ops.block_kernels against the JAX package's
ops.jax_kernels (and the Pallas MTF kernel in interpret mode), on the
CPU.  All of it is integer code: equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.ops import jax_kernels as jk
from compressjs_tpu.ops import pallas_kernels as pk
from compressjs_tpu_torch.ops import _cuda
from compressjs_tpu_torch.ops import block_kernels as bk
from tests import _cpu_share  # noqa: F401 -- caps torch's threads


def _text_like(rng, n):
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9)))
             for _ in range(300)]
    out = b' '.join(words[i] for i in rng.integers(0, 300, n))
    return np.frombuffer(out[:n], dtype=np.uint8).copy()


def _block(kind):
    """(bytes, n) of one named test block; n <= 4096 keeps the JAX
    compiles short."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == 'random':
        b = rng.integers(0, 256, 4096)
    elif kind == 'text':
        b = _text_like(rng, 4096)
    elif kind == 'repeated':
        b = np.full(4096, 7)
    elif kind == 'ab':
        b = np.frombuffer(b'ab' * 2048, dtype=np.uint8)
    elif kind == 'abc':
        b = np.frombuffer(b'abc' * 333, dtype=np.uint8)
    elif kind == 'abcabd':
        b = np.frombuffer(b'abcabd' * 333 + b'a', dtype=np.uint8)
    elif kind == 'one':
        b = np.array([42])
    elif kind == 'two':
        b = np.array([9, 3])
    else:
        raise ValueError(kind)
    b = np.array(b, dtype=np.uint8)
    return b, b.shape[0]


KINDS = ['random', 'text', 'repeated', 'ab', 'abc', 'abcabd', 'one', 'two']


@pytest.mark.parametrize('kind', KINDS)
def test_cyclic_suffix_sort(kind):
    b, n = _block(kind)
    want = np.asarray(jk.cyclic_suffix_sort(jnp.asarray(b), n))
    got = bk.cyclic_suffix_sort(torch.from_numpy(b), n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('kind', KINDS)
def test_bwt_block(kind):
    b, n = _block(kind)
    U_j, p_j = jk.bwt_block(jnp.asarray(b), n)
    U_t, p_t = bk.bwt_block(torch.from_numpy(b), n)
    np.testing.assert_array_equal(U_t.numpy(), np.asarray(U_j))
    assert int(p_t) == int(p_j)


def test_cyclic_suffix_sort_rejects_oversized_block():
    with pytest.raises(ValueError):
        bk.cyclic_suffix_sort(torch.zeros(1 << 20, dtype=torch.uint8),
                              1 << 20)


def _dense(width, n, seed):
    """MTF-like dense symbols < width: skewed, with runs."""
    rng = np.random.default_rng(seed)
    d = np.minimum(rng.zipf(1.4, n) - 1, width - 1)
    return d.astype(np.int32)


@pytest.mark.parametrize('width,n', [(64, 1500), (256, 2 * 512 + 77)])
def test_chunk_start_positions(width, n):
    """The plain start lists (position -> symbol) are the inverse of the
    JAX package's start positions (symbol -> position); symbols past
    `width` never occur, so they sit after the first `width` entries."""
    d = _dense(width, n, width)
    n_chunks = -(-n // 512)
    pad = np.zeros(n_chunks * 512, dtype=np.int32)
    pad[:n] = d
    want = np.asarray(jk._chunk_start_positions(
        jnp.asarray(pad.reshape(n_chunks, 512)), n_chunks, 512, width))
    got = bk._chunk_start_lists(
        torch.from_numpy(pad.reshape(n_chunks, 512))).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(np.argsort(want, axis=1), got[:, :width])


@pytest.mark.parametrize('width,n,seed', [(64, 1500, 1), (64, 3 * 512, 2),
                                          (256, 3077, 3), (256, 700, 4)])
def test_mtf_encode(width, n, seed):
    """The MTF encode on a CPU tensor (the kernels' plain version),
    against the XLA scan and the Pallas kernel in interpret mode."""
    d = _dense(width, n, seed)
    want = np.asarray(jk.mtf_encode(jnp.asarray(d), n, 512, width))
    pallas = np.asarray(pk.mtf_encode_pallas(jnp.asarray(d), n, 512, width,
                                             interpret=True))
    np.testing.assert_array_equal(pallas, want)
    t = torch.from_numpy(d)
    np.testing.assert_array_equal(bk.mtf_encode(t, n).numpy(), want)


def test_mtf_scan_cpu_takes_plain_version():
    d = torch.from_numpy(_dense(256, 1000, 5))
    lists = bk._chunk_start_lists(bk._pad_chunks(d, 1000))
    before = _cuda.launches['mtf_scan']
    out = bk.mtf_encode(d, 1000)
    assert _cuda.launches['mtf_scan'] == before
    np.testing.assert_array_equal(out.numpy(),
                                  bk.mtf_scan_plain(d, lists).numpy())


def _mtf_seq(kind, n):
    rng = np.random.default_rng(len(kind))
    if kind == 'zipf_runs':
        s = np.minimum(rng.zipf(1.3, n) - 1, 40)
        s[100:400] = 0           # one long zero run (many digits)
        s[-7:] = 0               # a run reaching the end of the block
        return s
    if kind == 'all_zero':
        return np.zeros(n, dtype=np.int64)
    if kind == 'no_zero':
        return rng.integers(1, 200, n)
    raise ValueError(kind)


@pytest.mark.parametrize('kind', ['zipf_runs', 'all_zero', 'no_zero'])
def test_rle2_encode(kind):
    n = 2500
    seq = _mtf_seq(kind, n).astype(np.int32)
    eob = 201
    s_j, c_j, f_j = jk.rle2_encode(jnp.asarray(seq), n, jnp.int32(eob))
    s_t, c_t, f_t = bk.rle2_encode(torch.from_numpy(seq), n, eob)
    assert s_t.dtype == torch.int16
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert int(c_t) == int(c_j)
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


@pytest.mark.parametrize('kind', ['text', 'abc'])
def test_encode_block_core(kind):
    b, n = _block(kind)
    used = np.zeros(256, dtype=bool)
    used[b] = True
    alpha = np.nonzero(used)[0]
    remap = np.zeros(256, dtype=np.int32)
    remap[alpha] = np.arange(len(alpha))
    eob = len(alpha) + 1
    want = jk.encode_block_core(jnp.asarray(b), n, jnp.asarray(remap),
                                jnp.int32(eob), 256)
    got = bk.encode_block_core(torch.from_numpy(b), n,
                               torch.from_numpy(remap).long(), eob)
    assert int(got[0]) == int(want[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(got[2]) == int(want[2])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def test_mtf_scan_refuses_other_devices():
    """Only a CPU tensor takes the plain version; elsewhere the wrapper
    launches its kernels or raises."""
    d = torch.empty(1000, dtype=torch.int32, device='meta')
    with pytest.raises(RuntimeError):
        bk.mtf_encode(d, 1000)


@pytest.fixture(scope='module')
def group_setup():
    """The setup of the JAX package's device Huffman stage test: one
    block's RLE2 symbols, its optimised tables padded to (6, 260) and its
    selectors, on generated data."""
    from compressjs_tpu.ops import huffman_stages as hs
    from compressjs_tpu.ops import mtf as mtf_host
    from compressjs_tpu.ops import rle as rle_host
    rng = np.random.default_rng(9)
    d = np.minimum(rng.zipf(1.3, 20000), 255).astype(np.uint8)
    alpha = mtf_host.used_alphabet(d)
    m = mtf_host.mtf_encode(d, alpha)
    eob = len(alpha) + 1
    syms = rle_host.mtf_rle2_encode(m, eob)
    freq = np.bincount(syms, minlength=eob + 1)
    lm, sel = hs.optimize_groups(syms.astype(np.int64), eob + 1, freq)
    L = np.full((6, 260), 255, dtype=np.int32)
    L[:lm.shape[0], :eob + 1] = lm
    L[:lm.shape[0], eob + 1:] = 0
    cm = np.stack([hs.canonical_codes(lm[g]) for g in range(lm.shape[0])])
    C = np.zeros((6, 260), dtype=np.int32)
    C[:cm.shape[0], :eob + 1] = cm
    pad = np.full(len(syms) + 7, eob, dtype=np.int16)
    pad[:len(syms)] = syms
    selpad = np.zeros(-(-pad.shape[0] // 50), dtype=np.int32)
    selpad[:len(sel)] = sel
    return pad, len(syms), L, C, selpad, eob


@pytest.mark.parametrize('cut', [0, 1, 777])
def test_device_huffman_group_helpers_match_jax(group_setup, cut):
    """group_costs_dev, chunk_freqs_dev and payload_pack_dev element for
    element against the JAX functions (the payload's bytes past `total`
    and `total` included), also with `count` short of the symbols."""
    pad, count, L, C, selpad, eob = group_setup
    count -= cut
    t = torch.from_numpy
    want = np.asarray(jk.group_costs_dev(jnp.asarray(pad), jnp.int32(count),
                                         jnp.asarray(L)))
    got = bk.group_costs_dev(t(pad), count, t(L))
    assert got.dtype == torch.int32 and got.numpy().shape == want.shape
    assert (got.numpy() == want).all()
    want = np.asarray(jk.chunk_freqs_dev(jnp.asarray(pad), jnp.int32(count),
                                         6, jnp.asarray(selpad), eob + 1))
    got = bk.chunk_freqs_dev(t(pad), torch.tensor(count), 6, t(selpad),
                             eob + 1)
    assert got.numpy().shape == want.shape and (got.numpy() == want).all()
    wp, wt = jk.payload_pack_dev(jnp.asarray(pad), jnp.int32(count),
                                 jnp.asarray(selpad), jnp.asarray(L),
                                 jnp.asarray(C))
    gp, gt = bk.payload_pack_dev(t(pad), count, t(selpad), t(L), t(C))
    assert int(gt) == int(wt)
    assert gp.dtype == torch.uint8
    assert gp.numpy().tobytes() == np.asarray(wp).tobytes()


def _scan_input(wrapper, n, seed):
    rng = np.random.default_rng(seed)
    if wrapper == '_seg_start':
        return torch.from_numpy(rng.random(n) < 0.3)
    return torch.from_numpy(rng.integers(0, 1 << 40, n))


@pytest.mark.parametrize('wrapper', ['_seg_start', '_max_scan'])
def test_seg_scan_cpu_takes_plain_version(wrapper):
    """A CPU tensor takes torch.cummax: no kernel call is counted."""
    x = _scan_input(wrapper, 3 * bk.SCAN_TILE + 5, 7)
    before = _cuda.launches['seg_scan']
    got = getattr(bk, wrapper)(x)
    assert _cuda.launches['seg_scan'] == before
    vals = (torch.where(x, torch.arange(x.shape[0]), 0)
            if wrapper == '_seg_start' else x)
    assert torch.equal(got, torch.cummax(vals, 0).values)


@pytest.mark.parametrize('wrapper,dtype', [('_seg_start', torch.bool),
                                           ('_max_scan', torch.int64)])
def test_seg_scan_refuses_other_devices(wrapper, dtype):
    x = torch.empty(1000, dtype=dtype, device='meta')
    before = _cuda.launches['seg_scan']
    with pytest.raises(RuntimeError):
        getattr(bk, wrapper)(x)
    assert _cuda.launches['seg_scan'] == before
