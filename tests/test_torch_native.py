"""compressjs_tpu_torch's native host runtime (``native``, and the host
modules that call it) against the JAX package's host functions and
against the port's own plain numpy twins, exactly."""

import bz2

import numpy as np
import pytest

from compressjs_tpu import native as native_ref
from compressjs_tpu.codecs import bzip2 as bzip2_ref
from compressjs_tpu.ops import bwt as bwt_ref
from compressjs_tpu.ops import huffman_stages as hs_ref
from compressjs_tpu.ops import rle as rle_ref
from compressjs_tpu_torch import native
from compressjs_tpu_torch.host import bwt, mtf_rle2, rle1
from compressjs_tpu_torch.host import bzip2_decode as hd
from compressjs_tpu_torch.host import bzip2_parse as bp
from compressjs_tpu_torch.host import huffman_stages as hs

CASES = ['runs', 'cut_runs', 'edge4', 'constant', 'periodic', 'one_byte']


def _case(name):
    """(input bytes, RLE1 block size) of each case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == 'runs':           # runs of 1-600
        vals = rng.integers(0, 6, 400).astype(np.uint8)
        return np.repeat(vals, rng.integers(1, 601, 400)), 9000
    if name == 'cut_runs':       # long runs cut at small block edges
        vals = rng.integers(0, 3, 300).astype(np.uint8)
        return np.repeat(vals, rng.choice([4, 5, 255, 256, 300, 600],
                                          300)), 777
    if name == 'edge4':          # a 4-run whose count byte misses the block
        return np.array([1, 2, 3, 3, 3, 3, 3, 4, 5] * 300, np.uint8), 6
    if name == 'constant':
        return np.full(5000, 7, dtype=np.uint8), 3000
    if name == 'periodic':
        return np.frombuffer(b'abcabd' * 900, np.uint8), 4000
    return np.array([42], np.uint8), 100


def _split(split, data, bs):
    out, start = [], 0
    while start < data.shape[0]:
        block, used = split(data, start, bs)
        out.append((block, used))
        if used == 0:
            break
        start += used
    return out


def _blocks(name):
    """The case's RLE1 blocks (the JAX split), at most three."""
    data, bs = _case(name)
    return [b for b, _ in _split(rle_ref.rle1_encode, data, bs)][:3]


def _symbols(block):
    """(syms, freq, alphabet) of a block by the JAX host path."""
    U = np.zeros(block.shape[0], np.uint8)
    bwt_ref.bwtransform2(block, U, block.shape[0], 256)
    alphabet = np.flatnonzero(np.bincount(block, minlength=256)) \
        .astype(np.uint8)
    syms, freq = bzip2_ref.mtf_rle2(U, alphabet, len(alphabet))
    return syms, freq, alphabet


@pytest.mark.parametrize('name', CASES)
def test_rle1_split(name):
    data, bs = _case(name)
    got = _split(rle1.rle1_encode, data, bs)
    for split in (rle_ref.rle1_encode, rle1.rle1_encode_plain):
        want = _split(split, data, bs)
        assert len(got) == len(want)
        for (b, u), (wb, wu) in zip(got, want):
            np.testing.assert_array_equal(b, wb)
            assert u == wu


def test_rle1_defers_edge_4run():
    """A 4-run that would end a block without its count byte moves its
    4th byte to the next block."""
    data, bs = _case('edge4')
    block, used = rle1.rle1_encode(data, 0, bs)
    assert block.tolist() == [1, 2, 3, 3, 3] and used == 5


@pytest.mark.parametrize('name', CASES)
def test_bwt(name):
    for block in _blocks(name) + [np.frombuffer(b'ab' * 40, np.uint8)]:
        n = block.shape[0]
        U, U_ref, U_plain = (np.zeros(n, np.uint8) for _ in range(3))
        pidx = bwt.bwtransform2(block, U, n)
        assert pidx == bwt_ref.bwtransform2(block, U_ref, n, 256) \
            == bwt.bwtransform2_plain(block, U_plain, n)
        np.testing.assert_array_equal(U, U_ref)
        np.testing.assert_array_equal(U, U_plain)


@pytest.mark.parametrize('name', CASES)
def test_mtf_rle2(name):
    for block in _blocks(name):
        U = np.zeros(block.shape[0], np.uint8)
        bwt_ref.bwtransform2(block, U, block.shape[0], 256)
        alphabet = np.flatnonzero(np.bincount(block, minlength=256)) \
            .astype(np.uint8)
        got = mtf_rle2.mtf_rle2(U, alphabet, len(alphabet))
        for fn in (bzip2_ref.mtf_rle2, mtf_rle2.mtf_rle2_plain):
            want = fn(U, alphabet, len(alphabet))
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        assert got[0].dtype == np.uint16 and got[1].dtype == np.int64


@pytest.mark.parametrize('name', CASES)
def test_code_lengths_and_codes(name):
    rng = np.random.default_rng(4)
    freqs = [np.ones(3, np.int64), np.array([0, 0, 5]),
             rng.integers(0, 1000, 258), np.array([1, 1, 2, 3, 5, 8, 13])]
    for block in _blocks(name):
        freqs.append(_symbols(block)[1])
    for f in freqs:
        m = len(f)
        got = hs.code_lengths_from_freqs(f, m)
        np.testing.assert_array_equal(got, hs_ref.code_lengths_from_freqs(
            f, m))
        np.testing.assert_array_equal(got, hs.code_lengths_plain(f, m))
        np.testing.assert_array_equal(hs.canonical_codes(got),
                                      hs_ref.canonical_codes(got))


@pytest.mark.parametrize('name', CASES)
def test_group_stages(name):
    """group_costs, chunk_freqs, payload packing and selector coding on
    each block's symbols under the tables the JAX refinement builds."""
    for block in _blocks(name):
        syms, freq, alphabet = _symbols(block)
        m = len(alphabet) + 2
        lens, sel = hs_ref.optimize_groups(syms.astype(np.int64), m, freq,
                                           ref_ties=False)
        g = lens.shape[0]
        costs = hs.group_costs(lens, syms)
        np.testing.assert_array_equal(costs, hs_ref.group_costs(lens, syms))
        np.testing.assert_array_equal(costs, hs.group_costs_plain(lens,
                                                                  syms))
        freqs = hs.chunk_freqs(syms, sel, g, m)
        np.testing.assert_array_equal(freqs, hs_ref.chunk_freqs(
            syms, sel, g, m))
        np.testing.assert_array_equal(freqs, hs.chunk_freqs_plain(
            syms, sel, g, m))
        codes = np.stack([hs.canonical_codes(row) for row in lens])
        got = hs.payload_bytes(syms, sel, lens, codes)
        for fn in (hs_ref.payload_bytes, hs.payload_bytes_plain):
            want = fn(syms, sel, lens, codes)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        bits = hs.selector_mtf_bits(sel, g)
        np.testing.assert_array_equal(bits, hs_ref.selector_mtf_bits(sel, g))
        np.testing.assert_array_equal(bits, hs.selector_mtf_bits_plain(sel,
                                                                       g))
        for row in lens:
            np.testing.assert_array_equal(hs.emit_table_deltas(row),
                                          hs_ref.emit_table_deltas(row))


@pytest.mark.parametrize('ref_ties', [False, True])
@pytest.mark.parametrize('name', CASES)
def test_optimize_groups(name, ref_ties):
    for block in _blocks(name):
        syms, freq, alphabet = _symbols(block)
        m = len(alphabet) + 2
        want = hs_ref.optimize_groups(syms.astype(np.int64), m, freq,
                                      ref_ties=ref_ties)
        for fn in (hs.optimize_groups, hs.optimize_groups_plain):
            got = fn(syms, m, freq, ref_ties)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_optimize_groups_long_stream(seed):
    """Six groups, both tie rules, on a zipf stream long enough for the
    refinement's every split."""
    rng = np.random.default_rng(seed)
    m = 40
    syms = np.minimum(rng.zipf(1.4, 20000), m - 2).astype(np.uint16)
    syms[-1] = m - 1
    freq = np.bincount(syms, minlength=m).astype(np.int64)
    for ref_ties in (False, True):
        want = hs_ref.optimize_groups(syms.astype(np.int64), m, freq,
                                      ref_ties=ref_ties)
        got = hs.optimize_groups(syms, m, freq, ref_ties)
        assert got[0].shape[0] == 6
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_optimize_groups_takes_ref_ties_explicitly():
    syms = np.array([1, 2, 3], np.uint16)
    with pytest.raises(TypeError):
        hs.optimize_groups(syms, 4, np.bincount(syms, minlength=4))


def test_native_rejects_bad_input():
    lens = np.ones((2, 4), np.uint8)
    with pytest.raises(ValueError):
        native.group_costs(np.array([5], np.uint16), lens)
    with pytest.raises(ValueError):
        native.chunk_freqs(np.zeros(60, np.uint16), np.zeros(1, np.uint8),
                           2, 4)
    with pytest.raises(ValueError):
        native.selector_mtf(np.array([0, 7], np.uint8), 2)
    with pytest.raises(ValueError):
        native.mtf_rle2(np.zeros(3, np.uint8), np.zeros(0, np.uint8))
    with pytest.raises(ValueError):
        native.mtf_rle2(np.array([1, 9], np.uint8), np.array([1], np.uint8))
    with pytest.raises(ValueError):
        mtf_rle2.mtf_rle2(np.zeros(3, np.uint8), np.zeros(1, np.uint8), 2)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A build that cannot run raises on the first native call; nothing
    falls back to the numpy twins."""
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(native, 'CXX', str(tmp_path / 'no-such-g++'))
    with pytest.raises(RuntimeError, match='no-such-g\\+\\+'):
        rle1.rle1_encode(np.arange(10, dtype=np.uint8), 0, 100)
    with pytest.raises(RuntimeError):
        hs.code_lengths_from_freqs(np.ones(4, np.int64), 4)
    assert native._lib is None


def test_build_reports_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / 'bad.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(native, 'SOURCE', str(bad))
    with pytest.raises(RuntimeError, match='bad.cpp'):
        native.lib()


def test_build_lands_in_hashed_dir():
    native.lib()
    path = native.build_info['path']
    assert '/_build/host-' in path and path.endswith('.so')
    assert native.build_info['cpu'] == native.cpu_model()


# -- the host block decode: bz2_block_full, bz2_decode_block,
# inverse_bwt and rle1_decode ------------------------------------------

DECODE_CASES = ['random', 'periodic', 'runs']


def _decode_case(name):
    """(input bytes, its one-block stdlib bz2 -1 stream as uint8)."""
    rng = np.random.default_rng(10 + DECODE_CASES.index(name))
    if name == 'random':
        data = rng.integers(0, 256, 60000).astype(np.uint8).tobytes()
    elif name == 'periodic':
        data = b'abcabd' * 12000
    else:
        vals = rng.integers(0, 8, 2000).astype(np.uint8)
        data = np.repeat(vals, rng.choice([1, 3, 4, 5, 255, 600], 2000)
                         ).tobytes()[:90000]
    return data, np.frombuffer(bz2.compress(data, 1), np.uint8)


def _after_magic(comp):
    """(bit after the first block's magic and CRC, dbuf size)."""
    r = bp._BitReader(comp)
    dbuf_size = bp._start(r)
    r.read_bits(48)
    r.read_bits(32)
    return r.pos, dbuf_size


def _block_full_plain(comp, pos, dbuf_size):
    """Twin of bz2_block_full: the Python header parse and symbol loop."""
    r = bp._BitReader(comp)
    r.seek_bit(pos)
    orig_ptr, s2b, sel, groups = bp._parse_block_header(r, dbuf_size)
    dbuf = hd.decode_symbols_plain(r, s2b, sel, groups, dbuf_size)
    return dbuf, orig_ptr, r.pos


@pytest.mark.parametrize('name', DECODE_CASES)
def test_bz2_block_full(name):
    data, comp = _decode_case(name)
    pos, dbuf_size = _after_magic(comp)
    got = native.bz2_block_full(comp, pos, dbuf_size)
    for want in (native_ref.bz2_block_full(comp, pos, dbuf_size),
                 _block_full_plain(comp, pos, dbuf_size)):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    # the column inverts to the block stdlib bz2 packed
    assert rle1.rle1_decode(bwt.inverse_bwt(got[0], got[1])).tobytes() \
        == data


@pytest.mark.parametrize('name', DECODE_CASES)
def test_bz2_decode_block(name):
    _, comp = _decode_case(name)
    pos, dbuf_size = _after_magic(comp)
    r = bp._BitReader(comp)
    r.seek_bit(pos)
    _, s2b, sel, groups = bp._parse_block_header(r, dbuf_size)
    sym_start = r.pos
    got = hd.decode_symbols(r, s2b, sel, groups, dbuf_size)
    got_end = r.pos
    r.seek_bit(sym_start)
    np.testing.assert_array_equal(
        got, hd.decode_symbols_plain(r, s2b, sel, groups, dbuf_size))
    assert r.pos == got_end
    s2b_256 = np.zeros(256, np.uint8)
    s2b_256[:len(s2b)] = s2b
    want, want_end = native_ref.bz2_decode_block(
        comp, sym_start, np.array(sel, np.uint8), *hd._group_tables(groups),
        len(s2b), s2b_256, dbuf_size)
    np.testing.assert_array_equal(got, want)
    assert got_end == want_end


@pytest.mark.parametrize('name', DECODE_CASES + ['one_byte', 'ragged'])
def test_inverse_bwt(name):
    if name in DECODE_CASES:
        block = rle1.rle1_encode(
            np.frombuffer(_decode_case(name)[0], np.uint8), 0, 99981)[0]
    elif name == 'one_byte':
        block = np.array([42], np.uint8)
    else:   # a column that is no BWT of anything: still a permutation
        block = np.random.default_rng(3).integers(0, 3, 777) \
            .astype(np.uint8)
    U = np.zeros(block.shape[0], np.uint8)
    pidx = bwt.bwtransform2(block, U, block.shape[0])
    for p in (pidx, block.shape[0] - 1):
        got = bwt.inverse_bwt(U, p)
        np.testing.assert_array_equal(got, bwt.inverse_bwt_plain(U, p))
        np.testing.assert_array_equal(got, native_ref.inverse_bwt(U, p))
    if name != 'ragged':
        np.testing.assert_array_equal(bwt.inverse_bwt(U, pidx), block)


@pytest.mark.parametrize('name', CASES)
def test_rle1_decode(name):
    data, bs = _case(name)
    for block in _blocks(name):
        got = rle1.rle1_decode(block)
        np.testing.assert_array_equal(got, rle1.rle1_decode_plain(block))
        np.testing.assert_array_equal(
            got, native_ref.rle1_decode(block, block.shape[0] * 256 + 256))
        np.testing.assert_array_equal(got, rle_ref.rle1_decode(block))
    # the blocks of the whole split undo to the input
    whole = [b for b, _ in _split(rle1.rle1_encode, data, bs)]
    np.testing.assert_array_equal(
        np.concatenate([rle1.rle1_decode(b) for b in whole]), data)


@pytest.mark.parametrize('where', ['payload', 'tables', 'selectors',
                                   'orig_ptr'])
def test_corrupt_block(where):
    """A corrupt block gives None from bz2_block_full and ValueError from
    the host block decode exactly where the JAX package's do."""
    _, comp = _decode_case('runs')
    pos, dbuf_size = _after_magic(comp)
    bad = comp.copy()
    if where == 'orig_ptr':     # origPtr 0xFFFFFF, past any block
        bits = np.unpackbits(bad)
        bits[pos + 1:pos + 25] = 1
        bad = np.packbits(bits)
    else:
        at = {'payload': len(comp) // 2, 'tables': pos // 8 + 60,
              'selectors': pos // 8 + 40}[where]
        bad[at] ^= 0x5A
    got = native.bz2_block_full(bad, pos, dbuf_size)
    want = native_ref.bz2_block_full(bad, pos, dbuf_size)
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]

    def outcome(read, reader):
        r = reader(bad)
        bp._start(r)
        try:
            res = read(r, dbuf_size)
        except ValueError:
            return 'ValueError'
        return res[0].tobytes(), res[1:]

    assert outcome(hd._read_block_header, bp._BitReader) == \
        outcome(bzip2_ref._read_block_header, bzip2_ref._BitReader)
    assert outcome(hd._decode_one_block, bp._BitReader) == \
        outcome(bzip2_ref._decode_one_block, bzip2_ref._BitReader)


def test_decode_entries_reject_bad_input():
    U = np.frombuffer(b'banana', np.uint8)
    for pidx in (-1, 6):
        with pytest.raises(ValueError):
            native.inverse_bwt(U, pidx)
        with pytest.raises(ValueError):
            bwt.inverse_bwt_plain(U, pidx)
    with pytest.raises(ValueError):
        native.rle1_decode(np.array([7, 7, 7, 7, 200], np.uint8), 100)
    _, comp = _decode_case('periodic')
    pos, dbuf_size = _after_magic(comp)
    r = bp._BitReader(comp)
    r.seek_bit(pos)
    _, s2b, sel, groups = bp._parse_block_header(r, dbuf_size)
    tables = hd._group_tables(groups)
    s2b_256 = np.zeros(256, np.uint8)
    s2b_256[:len(s2b)] = s2b
    args = (comp, r.pos, np.array(sel, np.uint8), *tables, len(s2b),
            s2b_256, dbuf_size)
    native.bz2_decode_block(*args)
    bad_sel = np.array(sel, np.uint8)
    bad_sel[0] = len(groups)          # names no table
    bad_len = tables[1].copy()
    bad_len[0] = 21                   # longer than bzip2 allows
    for i, bad in ((2, bad_sel), (4, bad_len), (5, tables[2][:, :24]),
                   (9, s2b_256[:255])):
        with pytest.raises(ValueError):
            native.bz2_decode_block(*args[:i], bad, *args[i + 1:])
