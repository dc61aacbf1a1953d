"""compressjs_tpu_torch.ops.compose and the composition ladder
`device_huffman._power_k` against the JAX package's Pallas kernel (in
interpret mode on the CPU) and its XLA windowed build, over whole (G,
cap) arrays, clipped tail values included.  Integer code: equality is
exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.ops import device_huffman as jdh
from compressjs_tpu.ops.pallas_compose import compose_windowed as pallas
from compressjs_tpu_torch.ops import compose as cm
from compressjs_tpu_torch.ops import device_huffman as dh
from tests import _cpu_share  # noqa: F401 -- caps torch's threads


def _case(seed, G, cap, blo, bhi):
    """(a, b) int32 maps: a jumps inside the window, b inside and outside
    it on both sides (clipped into [0, cap))."""
    rng = np.random.default_rng(seed)
    pos = np.arange(cap)[None, :]
    a = np.minimum(pos + rng.integers(blo, bhi + 1, (G, cap)), cap - 1)
    b = np.clip(pos + rng.integers(-blo - 5, 2 * bhi, (G, cap)), 0, cap - 1)
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize('G,cap,blo,bhi,tr', [
    (6, 8192, 2, 40, 8),
    (3, 16384, 16, 320, 16),
    (2, 8192, 1, 20, 8),
    (6, 8192, 32, 640, 8),
    (6, 8192, 33, 635, 8),
    (1, 4096, 5, 100, 32),
])
def test_compose_matches_pallas_and_xla(G, cap, blo, bhi, tr):
    a, b = _case(G * cap + bhi, G, cap, blo, bhi)
    got = cm.compose_windowed(torch.from_numpy(a), torch.from_numpy(b),
                              blo, bhi).numpy()
    want = np.asarray(pallas(jnp.asarray(a), jnp.asarray(b), blo, bhi, tr))
    np.testing.assert_array_equal(got, want)
    xla = np.asarray(jdh._compose_windowed(jnp.asarray(a), jnp.asarray(b),
                                           blo, bhi, cap))
    np.testing.assert_array_equal(got, xla)


@pytest.mark.parametrize('G,cap,blo,bhi', [(1, 100, 1, 20), (3, 37, 4, 80)])
def test_compose_tiny_cap_matches_xla(G, cap, blo, bhi):
    """Caps the Pallas tile cannot take: the port has no other build."""
    a, b = _case(cap, G, cap, blo, bhi)
    got = cm.compose_windowed(torch.from_numpy(a), torch.from_numpy(b),
                              blo, bhi).numpy()
    want = np.asarray(jdh._compose_windowed(jnp.asarray(a), jnp.asarray(b),
                                            blo, bhi, cap))
    np.testing.assert_array_equal(got, want)


def test_compose_rejects_bad_window():
    a = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError):
        cm.compose_windowed(a, a, 5, 2)
    with pytest.raises(ValueError):
        cm.compose_windowed(a, a[:1], 1, 20)


@pytest.mark.parametrize('k', [2, 5, 10, 25, 50])
def test_power_k_matches_jax_windowed(monkeypatch, k):
    monkeypatch.setenv('COMPRESSJS_TPU_COMPOSE', 'windowed')
    rng = np.random.default_rng(3)
    cap, G = 16384, 3
    nxt = np.minimum(np.arange(cap)[None, :] + rng.integers(1, 21, (G, cap)),
                     cap - 1).astype(np.int32)
    want = np.asarray(jdh._power_k(jnp.asarray(nxt), cap, k))
    got = dh._power_k(torch.from_numpy(nxt), k).numpy()
    np.testing.assert_array_equal(got, want)
