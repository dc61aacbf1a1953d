"""compressjs_tpu_torch.ops.block_decode (RLE2 undo, MTF undo, inverse
BWT, RLE1 undo) and the whole block decode against the JAX package's
``ops.jax_kernels`` and ``ops.device_huffman``, on the CPU, from seeded
inputs.  Integer code: equality is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.codecs import bzip2 as jbz
from compressjs_tpu.ops import device_huffman as jdh
from compressjs_tpu.ops import jax_kernels as jk
from compressjs_tpu.ops import rle as jrle
from compressjs_tpu_torch import convert
from compressjs_tpu_torch.ops import block_decode as bd
from compressjs_tpu_torch.ops import device_huffman as dh
from tests import _cpu_share  # noqa: F401 -- caps torch's threads


def _rle2_case(kind):
    """(syms, count, out_cap): RUNA/RUNB-heavy symbol streams with
    literals, padding past count."""
    rng = np.random.default_rng(len(kind))
    if kind == 'digits':
        s = np.where(rng.random(3000) < 0.7, rng.integers(0, 2, 3000),
                     rng.integers(2, 40, 3000))
        return s, 2900, 60000
    if kind == 'literals':
        return rng.integers(2, 258, 5000), 5000, 6000
    if kind == 'long_run':          # one run of 2^16 + 5 zeros
        digits = [int(c) for c in bin(65536 + 5 + 1)[3:]][::-1]
        return np.array([3] + digits + [4, 2] + [0] * 10), \
            len(digits) + 3, 70000
    raise ValueError(kind)


@pytest.mark.parametrize('kind', ['digits', 'literals', 'long_run'])
def test_rle2_decode(kind):
    syms, count, out_cap = _rle2_case(kind)
    syms = syms.astype(np.int32)
    jo, jt = jk.rle2_decode(jnp.asarray(syms), out_cap, jnp.int32(count))
    po, pt = bd.rle2_decode(torch.from_numpy(syms), out_cap, count)
    assert int(pt) == int(jt)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))


@pytest.mark.parametrize('n', [1, 511, 512, 5000])
def test_mtf_decode(n):
    rng = np.random.default_rng(n)
    idx = np.minimum(rng.zipf(1.4, n + 7) - 1, 255).astype(np.int32)
    idx[3::97] = 256      # past the list: the JAX masked-select semantics
    want = np.asarray(jk.mtf_decode(jnp.asarray(idx), n))
    got = bd.mtf_decode(torch.from_numpy(idx), n).numpy()
    np.testing.assert_array_equal(got, want)


def _mtf_undo_case(kind):
    """(indices, n): seeded MTF index streams."""
    rng = np.random.default_rng(len(kind))
    idx = np.minimum(rng.zipf(1.3, 5000) - 1, 255).astype(np.int32)
    if kind == 'ragged':            # a last chunk of 397 indices
        return idx, 4493
    if kind == 'planted':           # past the list
        idx[3::97] = 256
        idx[5::89] = 1000
        return idx, 5000
    if kind == 'negative':          # before the list
        idx[2::61] = -1
        idx[9::71] = -300
        return idx, 4999
    if kind == 'padded_tail':       # zeros past the total, as bwt_column
        idx[3000:] = 0              # decodes the whole capacity
        return idx, 5000
    raise ValueError(kind)


@pytest.mark.parametrize('kind', ['ragged', 'planted', 'negative',
                                  'padded_tail'])
def test_mtf_decode_plain(kind):
    idx, n = _mtf_undo_case(kind)
    want = np.asarray(jk.mtf_decode(jnp.asarray(idx), n))
    got = bd.mtf_decode_plain(torch.from_numpy(idx), n).numpy()
    np.testing.assert_array_equal(got, want)


def _bwt_case(kind):
    rng = np.random.default_rng(len(kind))
    if kind == 'text':
        b = rng.choice(np.frombuffer(b'etaoin shrdlu', np.uint8), 3000)
    elif kind == 'periodic':        # the LF orbit is shorter than n
        b = np.frombuffer(b'abcabd' * 400, np.uint8)
    elif kind == 'repeated':
        b = np.full(777, 9, np.uint8)
    elif kind == 'one':
        b = np.array([42], np.uint8)
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(b, dtype=np.uint8)


@pytest.mark.parametrize('kind', ['text', 'periodic', 'repeated', 'one'])
@pytest.mark.parametrize('pad', [0, 300])
def test_inverse_bwt_block_masked(kind, pad):
    block = _bwt_case(kind)
    n = block.shape[0]
    U, pidx = jk.bwt_block(jnp.asarray(block), n)
    cap = n + pad
    Up = np.zeros(cap, np.uint8)
    Up[:n] = np.asarray(U)
    want = np.asarray(jk.inverse_bwt_block_masked(
        jnp.asarray(Up), cap, jnp.int32(n), jnp.int32(int(pidx))))
    got = bd.inverse_bwt_block_masked(torch.from_numpy(Up), cap,
                                      torch.tensor(n), int(pidx)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:n], block)


def _rle1_cases():
    rng = np.random.default_rng(1)
    cases = [
        np.frombuffer(b'aaaaXbbbb\x00cc', np.uint8),
        np.frombuffer(b'aaaa\x05', np.uint8),
        np.frombuffer(b'aaaaaaaa', np.uint8),  # count byte == run byte
        rng.integers(0, 4, 5000).astype(np.uint8),
        np.repeat(np.arange(30, dtype=np.uint8), rng.integers(1, 600, 30)),
    ]
    data = np.repeat(rng.integers(0, 256, 2000).astype(np.uint8),
                     rng.choice([1, 2, 4, 5, 9, 300], 2000))
    blk, _ = jrle.rle1_encode(data, 0, 100000 - 19)
    cases.append(blk)
    return cases


@pytest.mark.parametrize('i', range(6))
def test_rle1_decode_dev(i):
    c = _rle1_cases()[i]
    ref = jrle.rle1_decode(c)
    padded = np.zeros(len(c) + 5, np.uint8)
    padded[:len(c)] = c
    cap = len(ref) + 8
    jo, jt = jk.rle1_decode_dev(jnp.asarray(padded), cap, jnp.int32(len(c)))
    po, pt = bd.rle1_decode_dev(torch.from_numpy(padded), cap, len(c))
    assert int(pt) == int(jt) == len(ref)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    exact, total = bd.rle1_decode_dev(torch.from_numpy(padded), None, len(c))
    assert int(total) == len(ref)
    np.testing.assert_array_equal(exact.numpy(), ref)


def test_decode_block_full_dev():
    """One whole -1 block through both packages: bytes, count, end bit."""
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9)))
             for _ in range(300)]
    data = b' '.join(words[i] for i in rng.integers(0, 300, 4000))[:20000]
    comp = np.frombuffer(bytes(jbz.compress_file(data, props=1)), np.uint8)
    r = jbz._BitReader(comp)
    r.read_bits(32)
    assert r.read_bits(48) == jbz.WHOLEPI
    r.read_bits(32)
    optr, s2b, selectors, groups = jbz._parse_block_header(r, 100000)
    byte0, bit0 = r.pos >> 3, r.pos & 7
    tabs = jdh.tables_for_device(groups, len(groups))
    s2b_arr = np.zeros(256, np.uint8)
    s2b_arr[:len(s2b)] = s2b
    sel = np.asarray(selectors, dtype=np.int32)
    nbits = (comp.shape[0] - byte0) * 8
    args = (bit0, nbits, len(selectors))
    # caps sized to the block, as a caller that knows its size may pass
    dbuf_cap, out_cap = len(data) + 8, 2 * len(data)
    jo, jc, je = jdh.decode_block_full_dev(
        jnp.asarray(comp[byte0:]), *args, len(groups), dbuf_cap, out_cap,
        *tabs, jnp.asarray(sel), jnp.int32(len(selectors)),
        jnp.int32(len(s2b) + 1), jnp.asarray(s2b_arr), jnp.int32(optr))
    po, pc, pe = dh.decode_block_full_dev(
        torch.from_numpy(comp[byte0:].copy()), *args, dbuf_cap, out_cap,
        *convert.decode_tables(*[np.asarray(x) for x in tabs], 'cpu'),
        torch.from_numpy(sel), len(selectors), len(s2b) + 1,
        torch.from_numpy(s2b_arr), optr)
    assert int(pc) == int(jc) == len(data)
    assert int(pe) == int(je)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    assert po.numpy()[:int(pc)].tobytes() == data
