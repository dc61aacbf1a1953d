"""compressjs_tpu_torch's Huffman length allocator (the CUDA kernel's
plain version on the CPU), batched code lengths and canonical codes
against the JAX package's ops.device_entropy, the allocator's Pallas
kernel in interpret mode.  Integer code: equality is exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compressjs_tpu.ops import device_entropy as de_j
from compressjs_tpu_torch.ops import _cuda
from compressjs_tpu_torch.ops import device_entropy as de_t

N = de_t.N


def _fib(m):
    f = [1, 1]
    while len(f) < m:
        f.append(f[-1] + f[-2])
    return np.array(f[:m])


def _tables(style):
    """(arrs (B, N) int32 of sorted frequencies, ms (B,) int32)."""
    rng = np.random.default_rng(sum(map(ord, style)))
    if style == 'fib':        # depth > 20 unlimited: relocating fill
        freqs = [_fib(22), _fib(27), np.concatenate([_fib(29),
                                                     np.ones(150, int)])]
    elif style == 'flat':
        freqs = [np.full(m, 5) for m in (3, 64, 255, 258)]
    elif style == 'tiny':
        freqs = [np.array([7]), np.array([3, 9]), np.array([1, 2, 3]),
                 np.array([0, 0, 4])]
    elif style == 'random':
        freqs = [rng.integers(0, 3000, m) for m in (5, 17, 130, 258)]
    elif style == 'zipf':
        freqs = [np.minimum(rng.zipf(1.2, m), 900001 // m)
                 for m in (40, 200, 258)]
    elif style == 'sparse':
        freqs = []
        for m in (20, 258):
            f = np.zeros(m, dtype=np.int64)
            f[rng.choice(m, m // 5, replace=False)] = \
                rng.integers(1, 100000, m // 5)
            freqs.append(f)
    else:
        raise ValueError(style)
    arrs = np.zeros((len(freqs), N), dtype=np.int32)
    for i, f in enumerate(freqs):
        arrs[i, :len(f)] = np.sort(f)
    return arrs, np.array([len(f) for f in freqs], dtype=np.int32)


STYLES = ['fib', 'flat', 'tiny', 'random', 'zipf', 'sparse']


@pytest.mark.parametrize('style', STYLES)
def test_alloc_lengths_matches_pallas_and_xla(style):
    """The allocator's plain version (scalar loops) equals the Pallas
    kernel in interpret mode and the lax build, slot for slot."""
    arrs, ms = _tables(style)
    pallas = np.asarray(de_j.alloc_lengths_pallas(
        jnp.asarray(arrs), jnp.asarray(ms), interpret=True))
    xla = np.asarray(jax.vmap(de_j.alloc_lengths_dev)(
        jnp.asarray(arrs), jnp.asarray(ms)))
    got = de_t.alloc_lengths(torch.from_numpy(arrs),
                             torch.from_numpy(ms)).numpy()
    for i, m in enumerate(ms):
        np.testing.assert_array_equal(got[i, :m], pallas[i, :m])
        np.testing.assert_array_equal(got[i, :m], xla[i, :m])
    np.testing.assert_array_equal(got, pallas)


def test_alloc_lengths_fib_reaches_limit():
    arrs, ms = _tables('fib')
    got = de_t.alloc_lengths(torch.from_numpy(arrs), torch.from_numpy(ms))
    assert int(got[0, :ms[0]].max()) == de_t.MAX_LEN


def test_alloc_lengths_cpu_takes_plain_version():
    arrs, ms = _tables('random')
    before = _cuda.launches['alloc_lengths']
    de_t.alloc_lengths(torch.from_numpy(arrs), torch.from_numpy(ms))
    assert _cuda.launches['alloc_lengths'] == before


def _freq_rows(style, m):
    rng = np.random.default_rng(len(style) + m)
    rows = np.zeros((3, N), dtype=np.int32)
    for i in range(3):
        if style == 'random':
            rows[i, :m] = rng.integers(0, 5000, m)
        elif style == 'zipf':
            rows[i, :m] = np.minimum(rng.zipf(1.3, m), 900001 // m)
        else:
            rows[i, :m] = rng.permutation(_fib(m) if m <= 29 else
                                          np.concatenate([_fib(29),
                                                          np.ones(m - 29,
                                                                  int)]))
    return rows


@pytest.mark.parametrize('style,m', [('random', 3), ('random', 258),
                                     ('zipf', 100), ('fib', 40)])
def test_code_lengths_batch(style, m):
    freqs = _freq_rows(style, m)
    want = np.asarray(de_j.code_lengths_batch(jnp.asarray(freqs), m,
                                              'pallas_interpret'))
    got = de_t.code_lengths_batch(torch.from_numpy(freqs), m).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('style,m', [('random', 3), ('random', 258),
                                     ('zipf', 100)])
def test_canonical_codes_dev(style, m):
    freqs = _freq_rows(style, m)
    lens = np.array(de_j.code_lengths_batch(jnp.asarray(freqs), m))
    got = de_t.canonical_codes_dev(torch.from_numpy(lens), m).numpy()
    for i in range(lens.shape[0]):
        want = np.asarray(de_j.canonical_codes_dev(jnp.asarray(lens[i]),
                                                   jnp.int32(m)))
        np.testing.assert_array_equal(got[i], want)


def test_alloc_lengths_refuses_other_devices():
    arrs = torch.empty(2, N, dtype=torch.int32, device='meta')
    ms = torch.empty(2, dtype=torch.int32, device='meta')
    with pytest.raises(RuntimeError):
        de_t.alloc_lengths(arrs, ms)
