"""compressjs_tpu_torch.ops.device_entropy's group optimisation and
payload packing against the JAX package's ops.device_entropy on the
CPU, the allocator's Pallas kernel in interpret mode.  Integer code:
equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.ops import device_entropy as de_j
from compressjs_tpu_torch.ops import device_entropy as de_t
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

N = de_t.N


def _syms(n_syms, m, pad_to, seed):
    """Padded RLE2-like symbol stream (RUNA/RUNB heavy), eob padding."""
    rng = np.random.default_rng(seed)
    syms = np.minimum(rng.zipf(1.5, n_syms) - 1, m - 2)
    buf = np.full(pad_to, m - 1, dtype=np.int16)
    buf[:n_syms] = syms
    buf[n_syms - 1] = m - 1
    freq = np.bincount(buf[:n_syms], minlength=N).astype(np.int32)
    return buf, freq


def test_chunk_hist_dev():
    buf, _ = _syms(1234, 90, 1300, 0)
    want = np.asarray(de_j.chunk_hist_dev(jnp.asarray(buf), 1234, 26))
    got = de_t.chunk_hist_dev(torch.from_numpy(buf), 1234, 26).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('n_syms', [120, 700, 3000, 20000])
def test_optimize_groups_dev(n_syms):
    m = 100
    pad_to = n_syms + 37
    buf, freq = _syms(n_syms, m, pad_to, n_syms)
    n_chunks = -(-pad_to // 50)
    want = de_j.optimize_groups_dev(jnp.asarray(buf), jnp.int32(n_syms),
                                    n_chunks, jnp.asarray(freq),
                                    jnp.int32(m), 'pallas_interpret')
    lens, g, sel, codes = de_t.optimize_groups_dev(
        torch.from_numpy(buf), n_syms, n_chunks, torch.from_numpy(freq), m)
    assert g == int(want[1])
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want[3]))


@pytest.mark.parametrize('n_syms,m', [(4321, 80), (777, 258)])
def test_payload_pack_words_dev(n_syms, m):
    pad_to = n_syms + 29
    buf, freq = _syms(n_syms, m, pad_to, m)
    n_chunks = -(-pad_to // 50)
    lens, g, sel, codes = de_j.optimize_groups_dev(
        jnp.asarray(buf), jnp.int32(n_syms), n_chunks, jnp.asarray(freq),
        jnp.int32(m))
    want, want_bits = de_j.payload_pack_words_dev(
        jnp.asarray(buf), jnp.int32(n_syms), sel, lens, codes,
        de_j.payload_cap_bytes(pad_to))
    got, bits = de_t.payload_pack_words_dev(
        torch.from_numpy(buf), n_syms, torch.from_numpy(np.array(sel)),
        torch.from_numpy(np.array(lens)),
        torch.from_numpy(np.array(codes)))
    assert bits == int(want_bits)
    assert got.shape[0] == (bits + 7) // 8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want)[:got.shape[0]])
