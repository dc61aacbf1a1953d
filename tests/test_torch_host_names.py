"""The host names the port took over from the JAX package last, each held
against its JAX counterpart on the same inputs, on the CPU: the `BWT`
namespace's `suffixsort`, `bwtransform2` and `inverse_bwt_cyclic` (on
both sides of the native runtime's 4096-byte threshold), the native
suffix and rotation sorts against their SA-IS references, the
incremental `CRC32`, `freeze`, `Bzip2`'s `compress_block_bits`, the host
op helpers, and the ``coders`` / ``models`` / ``utils`` import paths.
Ports of tests/test_bwt.py, tests/test_runtime.py::test_crc32_vectors
and tests/test_aux.py::test_freeze_blocks_mutation."""

import os

import numpy as np
import pytest

import compressjs_tpu as jcz
import compressjs_tpu_torch as cz
from compressjs_tpu import native as jnative
from compressjs_tpu.codecs import bzip2 as jbz
from compressjs_tpu.ops import huffman_stages as jhs
from compressjs_tpu.ops import mtf as jmtf
from compressjs_tpu.ops import rle as jrle
from compressjs_tpu.utils import crc32 as jcrc
from compressjs_tpu.utils.freeze import freeze as jfreeze
from compressjs_tpu_torch import native
from compressjs_tpu_torch.host import bzip2 as pbz
from compressjs_tpu_torch.host import huffman_stages as hs
from compressjs_tpu_torch.host import mtf as pmtf
from compressjs_tpu_torch.host import rle as prle
from compressjs_tpu_torch.utils import CRC32, crc32, freeze
from tests.test_bwt import CYCLIC_CASES, _adversarial_cases, sufcheck
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')
SIZES = [1, 2, 17, 1000, 4096, 4097, 20000]


@pytest.fixture(scope='module')
def sample5():
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        return np.asarray(jcz.Bzip2.decompress_file(f.read()),
                          dtype=np.uint8)


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 101, rng.integers(1, 6), np.uint8))
             for _ in range(50)]
    s = b' '.join(words[i] for i in rng.integers(0, 50, n))[:n]
    return np.frombuffer(s, dtype=np.uint8)


# --- BWT ------------------------------------------------------------------

@pytest.mark.parametrize('inp,out,idx', CYCLIC_CASES)
def test_bwtransform2_vectors(inp, out, idx):
    T = np.frombuffer(inp.encode('ascii'), dtype=np.uint8)
    U = np.zeros(len(T), dtype=np.uint8)
    pidx = cz.BWT.bwtransform2(T, U, len(T), 256)
    assert U.tobytes().decode('ascii') == out
    assert pidx == idx


@pytest.mark.parametrize('s,pidx', [
    (b'Mary had a little lamb, its fleece was white as snow' * 8
     + b'Nary had a little lamb, its fleece was white as snow', 99),
    (b'abab', 1)])
def test_bwtransform2_repeated_text(s, pidx):
    T = np.frombuffer(s, dtype=np.uint8)
    U, V = np.zeros(len(T), np.uint8), np.zeros(len(T), np.uint8)
    assert cz.BWT.bwtransform2(T, U, len(T), 256) == pidx
    assert jcz.BWT.bwtransform2(T, V, len(T), 256) == pidx
    assert U.tobytes() == V.tobytes()
    assert cz.BWT.inverse_bwt_cyclic(U, len(T), pidx).tobytes() == s


@pytest.mark.parametrize('n', SIZES)
def test_cyclic_bwt_matches_jax(n):
    T = _text(n, n)
    U, V = np.zeros(n, np.uint8), np.zeros(n, np.uint8)
    pidx = cz.BWT.bwtransform2(T, U, n, 256)
    assert pidx == jcz.BWT.bwtransform2(T, V, n, 256)
    assert U.tobytes() == V.tobytes()
    # a longer buffer: only U[:n] is read
    padded = np.concatenate([U, np.full(7, 0x41, np.uint8)])
    got = cz.BWT.inverse_bwt_cyclic(padded, n, pidx)
    assert got.tobytes() == jcz.BWT.inverse_bwt_cyclic(padded, n,
                                                       pidx).tobytes()
    assert got.tobytes() == T.tobytes()


@pytest.mark.parametrize('n', SIZES)
def test_suffixsort_matches_jax(n):
    T = _text(n, 100 + n)
    SA, SB = np.zeros(n + 3, np.int32), np.zeros(n + 3, np.int32)
    assert cz.BWT.suffixsort(T, SA, n, 256) == 0
    assert jcz.BWT.suffixsort(T, SB, n, 256) == 0
    np.testing.assert_array_equal(SA, SB)
    sufcheck(T, SA[:n], n)
    np.testing.assert_array_equal(cz.BWT.suffix_array(T), SA[:n])
    np.testing.assert_array_equal(cz.BWT.cyclic_suffix_array(T),
                                  jcz.BWT.cyclic_suffix_array(T))


def test_cyclic_roundtrip_random():
    rng = np.random.RandomState(3)
    for n in [1, 2, 3, 5, 17, 256, 1000]:
        T = rng.randint(0, 8, size=n).astype(np.uint8)
        U = np.zeros(n, dtype=np.uint8)
        pidx = cz.BWT.bwtransform2(T, U, n, 256)
        assert cz.BWT.inverse_bwt_cyclic(U, n, pidx).tobytes() == \
            T.tobytes(), n


# --- the native sorts -----------------------------------------------------

def test_native_available():
    assert native.available() is True


def test_two_stage_suffix_sort_matches_sais():
    for t in _adversarial_cases():
        T = np.frombuffer(t, dtype=np.uint8)
        got = native.suffix_sort(T)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, native.suffix_sort_sais(T))
        np.testing.assert_array_equal(got, jnative.suffix_sort(T))


def test_cyclic_rotation_sort_matches_doubled_string():
    for t in _adversarial_cases():
        T = np.frombuffer(t, dtype=np.uint8)
        u1, p1 = native.bwt_cyclic(T)
        u2, p2 = native.bwt_cyclic_ref(T)
        u3, p3 = jnative.bwt_cyclic_ref(T)
        assert p1 == p2 == p3, t[:40]
        assert u1.tobytes() == u2.tobytes() == u3.tobytes(), t[:40]


def test_two_stage_sorters_on_sample_text(sample5):
    T = sample5[:120000]
    want = jnative.suffix_sort(T)
    np.testing.assert_array_equal(native.suffix_sort(T), want)
    np.testing.assert_array_equal(native.suffix_sort_sais(T), want)
    u1, p1 = native.bwt_cyclic(T)
    u2, p2 = native.bwt_cyclic_ref(T)
    assert p1 == p2 and u1.tobytes() == u2.tobytes()


@pytest.mark.parametrize('entry', ['suffix_sort', 'suffix_sort_sais',
                                   'bwt_cyclic_ref'])
def test_native_sorts_reject_bad_sizes(entry):
    with pytest.raises(ValueError):
        getattr(native, entry)(np.zeros(0, np.uint8))


@pytest.mark.parametrize('maxlen', [9, 12, 20])
def test_huff_code_lengths_maxlen(maxlen):
    freq = (np.random.default_rng(maxlen).zipf(1.3, 258) % 100000) + 1
    got = native.huff_code_lengths(freq, maxlen)
    np.testing.assert_array_equal(got, jnative.huff_code_lengths(freq,
                                                                  maxlen))
    assert got.max() <= maxlen
    np.testing.assert_array_equal(native.huff_code_lengths(freq),
                                  jnative.huff_code_lengths(freq, 20))


# --- CRC32 and freeze -----------------------------------------------------

def test_crc32_vectors():
    c = CRC32()
    for b in b'123456789':
        c.update_crc(b)
    assert c.get_crc() == 0xFC891918
    assert crc32.crc32_bzip2(b'123456789') == 0xFC891918
    c2 = CRC32()
    c2.update(b'12345')
    c2.update(b'6789')
    c2.update(b'')
    assert c2.get_crc() == 0xFC891918
    assert crc32.crc32_raw(b'123456789') == jcrc.crc32_raw(b'123456789')


@pytest.mark.parametrize('value', [0x00, 0x5A, 0xFF])
def test_update_crc_run_matches_byte_loop(value):
    for count in list(range(201)) + [10 ** 5]:
        run, loop, ref = CRC32(), CRC32(), jcrc.CRC32()
        for c in (run, loop, ref):
            c.update(b'prefix')
        run.update_crc_run(value, count)
        ref.update_crc_run(value, count)
        loop.update(bytes([value]) * count)
        assert run.get_crc() == loop.get_crc() == ref.get_crc(), count


def test_freeze_blocks_mutation():
    ns = freeze.freeze({'x': 1, 'y': 2})
    assert ns.x == 1 and 'y' in ns
    with pytest.raises(AttributeError):
        ns.x = 5
    with pytest.raises(AttributeError):
        del ns.y
    with pytest.raises(AttributeError):
        ns.z


def test_freeze_matches_jax():
    class Obj:
        A = 1
        _hidden = 2

    for src in ({'a': 1, 'b': [2]}, Obj):
        got, want = freeze.freeze(src), jfreeze(src)
        assert sorted(got.keys()) == sorted(want.keys())
        assert list(got) == list(want)
        assert all(getattr(got, k) == getattr(want, k) for k in want)


# --- the Bzip2 codec and the host op helpers ------------------------------

@pytest.mark.parametrize('n', [1, 300, 5000])
def test_compress_block_bits_matches_jax(n, sample5):
    block = sample5[7 * n:8 * n].copy()
    got = pbz.compress_block_bits(block)
    np.testing.assert_array_equal(got, jbz.compress_block_bits(block))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_host_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    block = rng.integers(0, 40 + 100 * seed, 3000).astype(np.uint8)
    np.testing.assert_array_equal(pmtf.used_alphabet(block),
                                  jmtf.used_alphabet(block))
    lens = rng.integers(0, 1 << (10 * seed + 5), 500)
    np.testing.assert_array_equal(prle.runab_digits_length(lens),
                                  jrle.runab_digits_length(lens))
    mtf_seq = np.where(rng.random(4000) < 0.6, 0,
                       rng.integers(0, 60, 4000)).astype(np.int32)
    np.testing.assert_array_equal(prle.mtf_rle2_encode(mtf_seq, 62),
                                  jrle.mtf_rle2_encode(mtf_seq, 62))
    syms = prle.mtf_rle2_encode(mtf_seq, 62)
    lm = rng.integers(1, 21, (4, 63)).astype(np.uint8)
    np.testing.assert_array_equal(hs.assign_selectors(lm, syms),
                                  jhs.assign_selectors(lm, syms))
    assert (hs.MIN_GROUPS, hs.MAX_GROUPS) == (jhs.MIN_GROUPS,
                                               jhs.MAX_GROUPS)
    packed = rng.integers(0, 3, 5000).astype(np.uint8)
    for a, b in zip(prle.rle1_encode(packed, 0, 4000),
                    jrle.rle1_encode(packed, 0, 4000)):
        np.testing.assert_array_equal(a, b)


def test_import_paths_reexport_host():
    from compressjs_tpu_torch import coders, host, models, utils
    assert coders.RangeCoder is host.range_coder.RangeCoder
    assert coders.allocate_huffman_code_lengths is \
        host.huffman_allocator.allocate_huffman_code_lengths
    assert models.MTFModel is cz.MTFModel
    assert utils.CRC32 is host.crc32.CRC32
    assert utils.stream is host.stream and utils.util is host.util
    assert utils.EOF == jcz.utils.EOF
