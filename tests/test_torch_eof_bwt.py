"""The EOF-terminated BWT of the BWTC codec: the port's tensor build
(ops.block_kernels.eof_suffix_sort and bwt_eof_block,
ops.block_decode.inverse_bwt_eof_block) element for element against
``compressjs_tpu.ops.jax_kernels``, and its host forms (the native
entries cz_bwt_eof, cz_inverse_bwt_eof, cz_mtf_encode and cz_mtf_decode,
host.bwt.bwtransform / unbwtransform and host.mtf) against their twins
and the JAX package's host transforms, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressjs_tpu.ops import bwt as jbwt
from compressjs_tpu.ops import jax_kernels as jk
from compressjs_tpu_torch import native
from compressjs_tpu_torch.host import bwt as hbwt
from compressjs_tpu_torch.host import mtf as hmtf
from compressjs_tpu_torch.ops import block_decode as bd
from compressjs_tpu_torch.ops import block_kernels as bk
from tests import _cpu_share  # noqa: F401 -- caps torch's threads


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(300)]
    return np.frombuffer(b' '.join(words[i] for i in rng.integers(
        0, 300, n // 3))[:n], np.uint8)


def _input(kind):
    rng = np.random.default_rng(len(kind))
    return {
        'zeros': np.zeros(3000, np.uint8),   # needs the seed's sentinel
        'ab': np.frombuffer(b'ab' * 700, np.uint8),
        'ba': np.frombuffer(b'ba' * 700, np.uint8),   # suffix 0 sorts last
        'aaab': np.frombuffer(b'aaab' * 500, np.uint8),
        'random': rng.integers(0, 256, 3000).astype(np.uint8),
        'text': _text_like(1, 3000),
        'n1': np.array([7], np.uint8),
        'n2': np.array([200, 3], np.uint8),
        'n4097': _text_like(2, 4097),
    }[kind]


KINDS = ['zeros', 'ab', 'ba', 'aaab', 'random', 'text', 'n1', 'n2', 'n4097']


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize('kind', KINDS)
def test_eof_suffix_sort(kind):
    T = _input(kind)
    n = T.shape[0]
    got = bk.eof_suffix_sort(_t(T), n).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jk.eof_suffix_sort(jnp.asarray(T), n)))
    np.testing.assert_array_equal(got, hbwt.suffix_array(T, n))


@pytest.mark.parametrize('kind', KINDS)
def test_bwt_eof_block(kind):
    T = _input(kind)
    n = T.shape[0]
    U, pidx = bk.bwt_eof_block(_t(T), n)
    jU, jp = jk.bwt_eof_block(jnp.asarray(T), n)
    np.testing.assert_array_equal(U.numpy(), np.asarray(jU))
    assert int(pidx) == int(jp)
    want = np.zeros(n, np.uint8)
    assert hbwt.bwtransform(T, want, np.zeros(n, np.int32), n) == int(pidx)
    np.testing.assert_array_equal(U.numpy(), want)


@pytest.mark.parametrize('kind', KINDS)
def test_inverse_bwt_eof_block(kind):
    T = _input(kind)
    n = T.shape[0]
    U = np.zeros(n, np.uint8)
    pidx = jbwt.bwtransform(T, U, np.zeros(n, np.int32), n)
    assert pidx == n or kind != 'ba'     # the last step is never walked
    got = bd.inverse_bwt_eof_block(_t(U), n, pidx).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jk.inverse_bwt_eof_block(jnp.asarray(U), n, jnp.int32(pidx))))
    np.testing.assert_array_equal(got, T)


def test_rejects_oversized_block():
    with pytest.raises(ValueError):
        bk.eof_suffix_sort(torch.zeros(1 << 20, dtype=torch.uint8), 1 << 20)


@pytest.mark.parametrize('kind', KINDS)
def test_native_bwt_eof_equals_twins(kind):
    """cz_bwt_eof and cz_inverse_bwt_eof against the numpy twins and the
    JAX package's host transform (which takes its numpy path below 4097
    bytes and its native one above)."""
    T = _input(kind)
    n = T.shape[0]
    U, A = np.zeros(n, np.uint8), np.zeros(n, np.int32)
    pidx = hbwt.bwtransform_plain(T, U, A, n)
    np.testing.assert_array_equal(A, jbwt.suffix_array(T, n))
    Uj = np.zeros(n, np.uint8)
    assert jbwt.bwtransform(T, Uj, np.zeros(n, np.int32), n) == pidx
    np.testing.assert_array_equal(U, Uj)
    Un, pn = native.bwt_eof(T)
    assert pn == pidx
    np.testing.assert_array_equal(Un, U)
    np.testing.assert_array_equal(native.inverse_bwt_eof(U, pidx), T)
    back = np.zeros(n, np.uint8)
    hbwt.unbwtransform_plain(U, back, np.zeros(n, np.int32), n, pidx)
    np.testing.assert_array_equal(back, T)
    back[:] = 0
    hbwt.unbwtransform(U, back, np.zeros(n, np.int32), n, pidx)
    np.testing.assert_array_equal(back, T)


@pytest.mark.parametrize('n', [0, 5, 2049, 20000])
def test_native_mtf_equals_twins(n):
    rng = np.random.default_rng(n)
    alphabet = np.sort(rng.choice(256, 40, replace=False)).astype(np.uint8)
    data = alphabet[np.minimum(rng.zipf(1.5, n) - 1, 39)]
    idx = hmtf.mtf_encode_plain(data, alphabet)
    np.testing.assert_array_equal(native.mtf_encode(data, alphabet), idx)
    np.testing.assert_array_equal(hmtf.mtf_encode(data, alphabet), idx)
    np.testing.assert_array_equal(hmtf.mtf_decode_plain(idx, alphabet),
                                  data)
    np.testing.assert_array_equal(native.mtf_decode(idx, alphabet), data)
    np.testing.assert_array_equal(hmtf.mtf_decode(idx, alphabet), data)


def test_native_entries_reject_bad_input():
    with pytest.raises(ValueError):
        native.bwt_eof(np.zeros(0, np.uint8))
    for pidx in (0, 4):
        with pytest.raises(ValueError):
            native.inverse_bwt_eof(np.zeros(3, np.uint8), pidx)
    with pytest.raises(ValueError):
        native.mtf_encode(np.array([1, 9], np.uint8),
                          np.array([1, 2], np.uint8))
    with pytest.raises(ValueError):
        native.mtf_decode(np.array([0, 2], np.int32),
                          np.array([1, 2], np.uint8))
    with pytest.raises(ValueError):
        native.bwtc_encode_block(np.array([0, 3], np.int32), 3, True,
                                 np.zeros(5, np.int64))
