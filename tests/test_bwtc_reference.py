"""The benchmark's plain BWTC reference (``benchmark/reference/bwtc.py``):
it decodes the JAX codec's BWTC-P and BWTC-L goldens, the port's host
codec and ``bwtcp_compress_device`` streams, flags broken streams, and
loads nothing of JAX or either package.  Also the roofline count of the
BWTC-P cell's fused Fenwick model and range coder."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bwtcl as hbwtcl
from compressjs_tpu_torch.host import bwtcp as hbwtcp
from compressjs_tpu_torch.parallel import pipeline
from benchmark import harness, traffic as tr
from benchmark.reference import bwtc as ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'benchmark', 'data')


@pytest.fixture(scope='module')
def corpus():
    return tr.load_corpus('data/sample5_bzip2_9.bz2')


def _golden(name):
    with open(os.path.join(DATA, name), 'rb') as f:
        return f.read()


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(800)]
    return b' '.join(words[i] for i in rng.integers(0, 800, n // 4))[:n]


def repeated(n, period=64):
    """A text-like pattern repeated to n bytes: its blocks BWT into long
    runs, ~900 RLE2 symbols a block, so that the plain Fenwick model and
    coder of ``device='cpu'`` take seconds."""
    pat = _text_like(5, period)
    return (pat * (n // period + 1))[:n]


def _input(kind, level):
    rng = np.random.default_rng(level)
    if kind == 'one_byte':
        return b'x'
    if kind == 'single_symbol_run':
        return b'q' * 70_000
    if kind == 'all_256':
        return bytes(rng.permutation(np.tile(np.arange(256, dtype=np.uint8),
                                             40)))
    if kind == 'random':
        return rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
    if kind == 'text':
        return _text_like(level, 250_000)
    if kind == 'one_block':
        return _text_like(level + 1, level * 100_000)
    raise ValueError(kind)


# -- the goldens --------------------------------------------------------------

def test_reference_decodes_the_bwtcp_golden(corpus):
    d = ref.decode(_golden('bwtcp_9_sample5_first_1000000.bin'))
    assert d.data == corpus[:1_000_000]
    assert d.level == 9 and d.block_lengths == [900_000, 100_000]


def test_port_host_codec_makes_the_bwtcp_golden(corpus):
    piece = np.frombuffer(corpus[:1_000_000], np.uint8)
    assert bytes(hbwtcp.BWTCP.compress_file(piece, None, 9)) == \
        _golden('bwtcp_9_sample5_first_1000000.bin')


def test_reference_decodes_the_bwtcl_golden(corpus):
    d = ref.decode_bwtcl(_golden('bwtcl_9_sample5_first_1000000.bin'))
    assert d.data == corpus[:1_000_000]
    assert d.level == 9 and d.block_lengths == [900_000, 100_000]


# -- streams of the port ------------------------------------------------------

@pytest.mark.parametrize('level', [6, 9])
@pytest.mark.parametrize('kind', ['one_byte', 'single_symbol_run', 'all_256',
                                  'random', 'text', 'one_block'])
def test_reference_decodes_host_codec_streams(kind, level):
    data = _input(kind, level)
    d = ref.decode(bytes(hbwtcp.BWTCP.compress_file(data, None, level)))
    assert d.data == data and d.level == level
    dl = ref.decode_bwtcl(bytes(hbwtcl.BWTCL.compress_file(data, None,
                                                           level)))
    assert dl.data == data and dl.level == level


def test_reference_decodes_an_empty_file():
    assert ref.decode(bytes(hbwtcp.BWTCP.compress_file(b'', None, 9))) \
        .data == b''


@pytest.mark.parametrize('level', [6, 9])
def test_reference_decodes_device_streams(level):
    """``bwtcp_compress_device`` with each kernel's plain version: one
    whole block on the device path and a tail on the host."""
    data = repeated(level * 100_000 + 30_000)
    out = bytes(cz.bwtcp_compress_device(data, None, level, device='cpu'))
    assert pipeline.bwtcp_compress_device.last_stats == {
        'device_blocks': 1, 'host_blocks': 1, 'overflow_blocks': 0}
    d = ref.decode(out)
    assert d.data == data and d.block_lengths == [level * 100_000, 30_000]


@pytest.mark.parametrize('workers', [1, 2])
def test_reference_decodes_blocks_apart(workers):
    data = _text_like(11, 1_400_000)
    d = ref.decode(bytes(hbwtcp.BWTCP.compress_file(data, None, 6)),
                   workers=workers)
    assert d.data == data and d.block_lengths == [600_000, 600_000,
                                                  200_000]


# -- broken streams -----------------------------------------------------------

@pytest.fixture(scope='module')
def stream():
    data = _text_like(4, 200_000)
    return data, bytes(hbwtcp.BWTCP.compress_file(data, None, 9))


def _differs(data, s, decode=ref.decode, level=9):
    """True where the reference refuses `s`, or decodes it to other bytes
    than `data` or to another level (the judge's format error)."""
    try:
        d = decode(s)
    except ref.FormatError:
        return True
    return d.data != data or d.level != level


def _level_at(s):
    """The level byte's index: after the magic and the size varint."""
    i = 4
    while not s[i] & 0x80:
        i += 1
    return i + 1


# the container (magic 0-3, size 4-6, level 7, block count 8, block size
# 9-11), the block's coder stream from 12: its header, its body, its end
# (the byte count).  A range coder's stream has slack the format does not
# fix (its free first byte, 0 or 1 after a carry; the code's last bits):
# a change there may decode to the same file, and the judge then passes
# it, rightly.
@pytest.mark.parametrize('where', [0, 3, 4, 6, 7, 8, 9, 11, 13, 16, 40, 100,
                                   997, 10_000, 33_333, -100, -9, -3, -2,
                                   -1])
def test_one_altered_byte_is_flagged(stream, where):
    data, s = stream
    assert s[12] == 0 and _level_at(s) == 7
    for bit in (0x01, 0x10, 0x80):
        b = bytearray(s)
        b[where] ^= bit
        assert _differs(data, bytes(b)), bit


def test_free_byte_past_a_carry_is_flagged(stream):
    """The coder's first byte is 0, or 1 where a carry reached it."""
    data, s = stream
    for v, flagged in ((1, False), (2, True), (0x80, True), (0xFF, True)):
        b = bytearray(s)
        b[12] = v
        assert _differs(data, bytes(b)) == flagged, v


@pytest.mark.parametrize('cut', [1, 3, 5, 1000])
def test_truncated_stream_is_a_format_error(stream, cut):
    with pytest.raises(ref.FormatError):
        ref.decode(stream[1][:-cut])


def test_bytes_after_the_end_are_a_format_error(stream):
    with pytest.raises(ref.FormatError):
        ref.decode(stream[1] + b'\0')


@pytest.mark.parametrize('level', [0, 1, 5, 6, 7, 8, 10])
def test_wrong_level_byte_is_flagged(level):
    # a stream whose block holds 900,000 bytes, labelled another level
    data = _text_like(6, 900_000)
    s = bytearray(hbwtcp.BWTCP.compress_file(data, None, 9))
    assert s[_level_at(s)] == 9
    s[_level_at(s)] = level
    assert _differs(data, bytes(s))


def test_bwtcl_broken_streams_are_flagged():
    data = _text_like(9, 120_000)
    s = bytes(hbwtcl.BWTCL.compress_file(data, None, 1))
    b = bytearray(s)
    b[len(b) // 2] ^= 0x01
    assert _differs(data, bytes(b), ref.decode_bwtcl, level=1)
    with pytest.raises(ref.FormatError):
        ref.decode_bwtcl(s[:-2])
    with pytest.raises(ref.FormatError):
        ref.decode_bwtcl(s.replace(b'bwtL', b'bwtP', 1))


def test_low_levels_are_refused():
    s = bytes(hbwtcp.BWTCP.compress_file(_text_like(2, 5000), None, 5))
    with pytest.raises(ref.FormatError):
        ref.decode(s)


def test_reference_imports_nothing_of_the_program():
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'import benchmark.reference.bwtc; '
            'print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))')
    r = subprocess.run([sys.executable, '-c', code, ROOT],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    tops = set(r.stdout.split())
    assert 'numpy' in tops
    assert not tops & {'jax', 'jaxlib', 'compressjs_tpu',
                       'compressjs_tpu_torch', 'torch'}


# -- the cell's roofline count ------------------------------------------------

def test_fenwick_code_roofline_counts():
    m = harness.load_file_module('metrics', 'fenwick_code_roofline_pct')
    # 8 lanes, 1,000 symbols, 500 bytes coded: 2,000 B read, 500 B
    # written, 8 states of 16 B read and written
    assert m.bytes_of_call(1000, 500, 8) == 2000 + 500 + 256
    valid = torch.zeros((2, 10), dtype=torch.bool)
    valid[0, :7] = True
    valid[1, :3] = True
    init = torch.zeros((2, 5), dtype=torch.int64)
    init[:, 4] = torch.tensor([40, 50])
    out = (None, None, torch.tensor([140, 70]))
    args = (None, valid, None, 258, 0xFF00, 0x100, init, 99)
    assert int(m.BYTES[m.SPANS[0]](args, {}, out)) == \
        m.bytes_of_call(10, 120, 2)


# -- the cell's format module -------------------------------------------------

@pytest.fixture
def fmt(monkeypatch):
    from benchmark.formats import bwtcp
    monkeypatch.setattr(bwtcp, 'JUDGE_WORKERS', 1)
    monkeypatch.setattr(bwtcp, '_offcard', [0])
    return bwtcp


def test_format_judges_each_output(fmt):
    config = tr.load_json('configs', 'bwtcp-9-wikitext')
    data = _text_like(12, 150_000)
    file = {'data': data}
    s = bytes(hbwtcp.BWTCP.compress_file(data, None, 9))
    sound = {'format_errors': 0, 'files_differing': 0, 'golden_differs': 0,
             'offcard_blocks': 0}
    assert fmt.judge(config, 'encode', file, s) == sound
    b = bytearray(s)
    b[len(b) // 2] ^= 0x01
    assert fmt.judge(config, 'encode', file, bytes(b)) == dict(
        sound, format_errors=1, files_differing=1)
    assert fmt.judge(config, 'encode', file, data)['format_errors'] == 1
    other = bytes(hbwtcp.BWTCP.compress_file(data[1:], None, 9))
    assert fmt.judge(config, 'encode', file, other) == dict(
        sound, files_differing=1)


def test_format_counts_full_blocks_off_the_card(fmt, monkeypatch):
    """A token cap too small for any block: the full block is coded again
    on the host, and the first judge after the calls counts it."""
    monkeypatch.setattr(pipeline, '_bwtcp_tok_cap', lambda bs: 100)
    config = dict(tr.load_json('configs', 'bwtcp-9-wikitext'), level=6)
    data = repeated(650_000)
    out = fmt.entry(config, 'encode', 'cpu')(data)
    assert pipeline.bwtcp_compress_device.last_stats == {
        'device_blocks': 0, 'host_blocks': 1, 'overflow_blocks': 1}
    got = fmt.judge(config, 'encode', {'data': data}, out)
    assert got['offcard_blocks'] == 1 and got['files_differing'] == 0
    assert fmt.judge(config, 'encode', {'data': data}, out)[
        'offcard_blocks'] == 0
