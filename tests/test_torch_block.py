"""The whole block: compressjs_tpu_torch's encode_block_full against the
JAX package's, on the CPU, fed the same arrays through
convert.block_inputs.  Every output element must be equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.ops import device_entropy as de_j
from compressjs_tpu_torch.convert import block_inputs
from compressjs_tpu_torch.ops import device_entropy as de_t
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

N_BLOCK = 3000


def _block(kind, n=N_BLOCK):
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == 'text':
        words = [bytes(rng.integers(97, 123, rng.integers(1, 9)))
                 for _ in range(200)]
        b = np.frombuffer(b' '.join(words[i] for i in
                                    rng.integers(0, 200, n))[:n], np.uint8)
    elif kind == 'random':
        b = rng.integers(0, 256, n)
    elif kind == 'periodic':
        b = np.frombuffer((b'abcab' * n)[:n], np.uint8)
    elif kind == 'repeated':
        b = np.full(n, 200)
    elif kind == 'skewed':     # few symbols, long runs: RUNA/RUNB heavy
        b = np.repeat(rng.integers(0, 4, n // 20 + 1), 20)[:n] + 65
    else:
        raise ValueError(kind)
    return np.array(b, dtype=np.uint8)


def _meta(block):
    used = np.zeros(256, dtype=bool)
    used[block] = True
    alpha = np.nonzero(used)[0]
    remap = np.zeros(256, dtype=np.int32)
    remap[alpha] = np.arange(len(alpha))
    return remap, len(alpha) + 1


@pytest.mark.parametrize('kind,n', [('text', N_BLOCK), ('random', N_BLOCK),
                                    ('periodic', N_BLOCK),
                                    ('repeated', N_BLOCK),
                                    ('skewed', N_BLOCK), ('text', 150)])
def test_encode_block_full(kind, n):
    block = _block(kind, n)
    remap, eob = _meta(block)
    want = [np.asarray(x) for x in de_j.encode_block_full(
        jnp.asarray(block), n, jnp.asarray(remap), jnp.int32(eob), 256,
        'xla', 'pallas_interpret')]
    w_pidx, w_pay, w_bits, w_lens, w_g, w_sel, w_count, w_freq = want
    blk, remap_t, eob_t = block_inputs(block, remap, eob, 'cpu')
    pidx, pay, bits, lens, g, sel, count, freq = de_t.encode_block_full(
        blk, n, remap_t, eob_t)
    assert int(pidx) == int(w_pidx)
    assert bits == int(w_bits)
    np.testing.assert_array_equal(pay.numpy(), w_pay[:(bits + 7) // 8])
    np.testing.assert_array_equal(lens.numpy(), w_lens)
    assert g == int(w_g)
    np.testing.assert_array_equal(sel.numpy(), w_sel)
    assert count == int(w_count)
    np.testing.assert_array_equal(freq.numpy(), w_freq)


def test_block_inputs():
    block = _block('text', 100)
    remap, eob = _meta(block)
    blk, remap_t, eob_t = block_inputs(block, remap, eob, 'cpu')
    assert blk.dtype == torch.uint8 and blk.device.type == 'cpu'
    np.testing.assert_array_equal(blk.numpy(), block)
    np.testing.assert_array_equal(remap_t.numpy(), remap)
    assert eob_t == eob and isinstance(eob_t, int)
