"""compressjs_tpu_torch's parallel Huffman walk (ops/device_huffman.py)
and host header parse (host/bzip2_parse.py) against the JAX package's
``ops.device_huffman`` and ``codecs.bzip2``, on the CPU.  Blocks are the
first block of streams that ``compressjs_tpu.codecs.bzip2`` writes from
seeded data.  Integer code: equality is exact."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from compressjs_tpu.codecs import bzip2 as jbz
from compressjs_tpu.ops import device_huffman as jdh
from compressjs_tpu_torch import convert
from compressjs_tpu_torch.host import bzip2_parse as bp
from compressjs_tpu_torch.ops import device_huffman as dh
from tests import _cpu_share  # noqa: F401 -- caps torch's threads


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9)))
             for _ in range(500)]
    out = b' '.join(words[i] for i in rng.integers(0, 500, n))
    return out[:n]


def _data(kind):
    rng = np.random.default_rng(len(kind))
    if kind == 'text':
        return _text_like(1, 40000)
    if kind == 'all_bytes':
        return bytes(range(256)) * 60
    if kind == 'runs':
        vals = rng.integers(0, 256, 400).astype(np.uint8)
        return np.repeat(vals, rng.choice([1, 4, 5, 70, 300], 400)).tobytes()
    if kind == 'random':
        return rng.integers(0, 256, 30000).astype(np.uint8).tobytes()
    raise ValueError(kind)


KINDS = ['text', 'all_bytes', 'runs', 'random']


def _first_block(data, level=1):
    """(stream, header parse, symbol start bit) of the first block; the
    JAX package's and the port's header parses must agree."""
    comp = np.frombuffer(bytes(jbz.compress_file(data, props=level)),
                         dtype=np.uint8)
    parsed = []
    for mod in (jbz, bp):
        r = mod._BitReader(comp)
        dbuf = mod._start(r)
        assert r.read_bits(48) == 0x314159265359
        r.read_bits(32)
        parsed.append((mod._parse_block_header(r, dbuf), r.pos))
    (jh, jpos), (ph, ppos) = parsed
    assert jpos == ppos
    assert jh[:3] == ph[:3]
    for jg, pg in zip(jh[3], ph[3]):
        assert jg == pg
    return comp, jh, ppos


@pytest.mark.parametrize('kind', KINDS)
def test_tables_for_device(kind):
    _, (_, _, _, groups), _ = _first_block(_data(kind))
    want = jdh.tables_for_device(groups, len(groups))
    got = dh.tables_for_device(groups, len(groups))
    for w, g, t in zip(want, got, convert.decode_tables(
            *[np.asarray(x) for x in want], 'cpu')):
        assert g.dtype == np.int32 and t.dtype == torch.int32
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(t.numpy(), g)


@pytest.mark.parametrize('bit0', range(8))
def test_payload_words_and_window_vals(bit0):
    """Bytes with the top bit set would leak past bit 31 of the int64
    word math without its mask."""
    rng = np.random.default_rng(bit0)
    raw = rng.integers(0, 256, 300).astype(np.uint8)
    raw[::7] = 0xFF
    raw[1::11] = 0x80
    nbits = 2048 - 8
    n_words = (nbits + 20 + 31) // 32 + 1
    jw = jdh.payload_words(jnp.asarray(raw), n_words)
    pw = dh.payload_words(torch.from_numpy(raw), n_words)
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw).astype(np.int64))
    want = np.asarray(jdh._window_vals(jw, bit0, nbits))
    got = dh._window_vals(pw, bit0, nbits).numpy()
    np.testing.assert_array_equal(got, want)


def _walk_tables(comp, header, sym_start, nbits_cap, s_cap):
    _, s2b, selectors, groups = header
    tabs = jdh.tables_for_device(groups, len(groups))
    sel = np.zeros(s_cap, dtype=np.int32)
    sel[:len(selectors)] = selectors[:s_cap]
    payload = comp[sym_start >> 3:]
    return payload, sym_start & 7, tabs, sel, len(selectors), len(s2b) + 1


@pytest.mark.parametrize('kind', KINDS)
def test_group_lengths(kind):
    comp, header, sym_start = _first_block(_data(kind))
    payload, bit0, tabs, _, _, _ = _walk_tables(comp, header, sym_start,
                                                4096, 64)
    jw = jdh.payload_words(jnp.asarray(payload), 200)
    val = jdh._window_vals(jw, bit0, 4096)
    limits, _, _, mins = convert.decode_tables(
        *[np.asarray(x) for x in tabs], 'cpu')
    got = dh._group_lengths(torch.from_numpy(np.array(val)), limits,
                            mins).numpy()
    for g in range(limits.shape[0]):
        want = np.asarray(jdh._group_lengths(val, tabs[0][g], tabs[3][g]))
        np.testing.assert_array_equal(got[g], want)


def _chase_reference(F, sel, sub):
    """The JAX walk's chase, step by step: record p, then
    p <- F[sel[step // sub], p]; chunk c starts at step c * sub."""
    cap = F.shape[1]
    flat = F.reshape(-1)
    p, rec = 0, []
    for step in range(sel.shape[0] * sub):
        rec.append(p)
        p = int(flat[int(sel[step // sub]) * cap + p])
    return np.array(rec[::sub], dtype=np.int32)


@pytest.mark.parametrize('kind', ['text', 'random'])
def test_selector_chase_matches_jax_starts(kind):
    comp, header, sym_start = _first_block(_data(kind))
    cap = 1 << 16
    payload, bit0, tabs, sel, _, _ = _walk_tables(comp, header, sym_start,
                                                  cap, 1024)
    ttabs = convert.decode_tables(*[np.asarray(x) for x in tabs], 'cpu')
    _, _, nxt = dh._next_maps(torch.from_numpy(payload.copy()), bit0, cap,
                              ttabs[0], ttabs[3])
    F_jax = np.asarray(jdh._power_k(jnp.asarray(nxt.numpy()), cap, 10))
    want = _chase_reference(F_jax, sel, 5)
    sel_t = torch.from_numpy(sel)
    got = dh.selector_chase(torch.from_numpy(F_jax), sel_t, 5).numpy()
    np.testing.assert_array_equal(got, want)
    # the port's own F gives the same chunk starts
    F = dh._power_k(nxt, 10)
    np.testing.assert_array_equal(dh.selector_chase(F, sel_t, 5).numpy(),
                                  want)


def _both_walks(comp, header, sym_start, nbits_cap, s_cap,
                jax_power_k=None):
    """Both packages' walks; the JAX walk at its own default composition
    power unless jax_power_k is given, the port's at its only one."""
    payload, bit0, tabs, sel, n_sel, eob = _walk_tables(
        comp, header, sym_start, nbits_cap, s_cap)
    k = {} if jax_power_k is None else {'power_k': jax_power_k}
    js, jc, je = jdh.huffman_walk_dev(
        jnp.asarray(payload), bit0, nbits_cap, s_cap, len(tabs[3]), *tabs,
        jnp.asarray(sel), jnp.int32(n_sel), jnp.int32(eob), **k)
    ps, pc, pe = dh.huffman_walk_dev(
        torch.from_numpy(payload.copy()), bit0, nbits_cap, s_cap,
        *convert.decode_tables(*[np.asarray(x) for x in tabs], 'cpu'),
        torch.from_numpy(sel), n_sel, eob)
    return (np.asarray(js), int(jc), int(je)), (ps.numpy(), int(pc), int(pe))


@pytest.mark.parametrize('kind', ['text', 'random'])
def test_power_k_50_matches_jax(monkeypatch, kind):
    """F = nxt^50 of a real block, every entry, against the JAX
    package's windowed build."""
    monkeypatch.setenv('COMPRESSJS_TPU_COMPOSE', 'windowed')
    comp, header, sym_start = _first_block(_data(kind))
    cap = 1 << 14
    payload, bit0, tabs, _, _, _ = _walk_tables(comp, header, sym_start,
                                                cap, 64)
    ttabs = convert.decode_tables(*[np.asarray(x) for x in tabs], 'cpu')
    _, _, nxt = dh._next_maps(torch.from_numpy(payload.copy()), bit0, cap,
                              ttabs[0], ttabs[3])
    want = np.asarray(jdh._power_k(jnp.asarray(nxt.numpy()), cap, 50))
    np.testing.assert_array_equal(dh._power_k(nxt, 50).numpy(), want)


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('padded', [False, True])
def test_huffman_walk_power_k_matches_jax(kind, padded):
    """The port's walk against the JAX walk at the port's composition
    power, which chases all of a padded s_cap where the port stops at
    n_selectors."""
    comp, header, sym_start = _first_block(_data(kind))
    nbits_cap = (comp.shape[0] - (sym_start >> 3)) * 8
    s_cap = len(header[2])
    if padded:
        s_cap = bp._pow2_at_least(s_cap + 1, 64)
    (js, jc, je), (ps, pc, pe) = _both_walks(
        comp, header, sym_start, nbits_cap, s_cap,
        jax_power_k=dh.POWER_K_DEFAULT)
    assert jc > 0 and pc == jc and pe == je
    np.testing.assert_array_equal(ps[:pc], js[:jc])


@pytest.mark.parametrize('kind', KINDS)
def test_huffman_walk_matches_jax(kind):
    comp, header, sym_start = _first_block(_data(kind))
    nbits_cap = (comp.shape[0] - (sym_start >> 3)) * 8
    (js, jc, je), (ps, pc, pe) = _both_walks(comp, header, sym_start,
                                             nbits_cap, len(header[2]))
    assert jc > 0 and pc == jc and pe == je
    np.testing.assert_array_equal(ps[:pc], js[:jc])


def test_huffman_walk_padded_caps():
    """Power-of-two caps, as the stream decoder gives, change nothing."""
    comp, header, sym_start = _first_block(_data('text'))
    nbits = (comp.shape[0] - (sym_start >> 3)) * 8
    nbits_cap = bp._pow2_at_least(nbits + 555, 1 << 12)
    s_cap = bp._pow2_at_least(len(header[2]) + 37, 64)
    (js, jc, je), (ps, pc, pe) = _both_walks(comp, header, sym_start,
                                             nbits_cap, s_cap)
    assert pc == jc and pe == je
    np.testing.assert_array_equal(ps[:pc], js[:jc])


def _jax_package_chase(F, sel, sub):
    """The chunk starts that the JAX package's `huffman_walk_dev` chases
    over a given F: the walk runs eagerly with `_power_k` returning F, and
    its second `lax.scan` (the 50-step walk, which takes the starts as its
    carry) is recorded and skipped."""
    G, cap = F.shape
    n = sel.shape[0]
    real = jax.lax
    seen = []

    def scan(f, init, xs=None, length=None, **kw):
        if seen:                       # the walk: record its starts
            seen.append(np.asarray(init))
            z = jnp.zeros((jdh.GROUP_SIZE, n), jnp.int32)
            return init, (z, z)
        seen.append(None)              # the chase itself runs
        return real.scan(f, init, xs, length=length, **kw)

    lax = types.SimpleNamespace(**{k: getattr(real, k) for k in dir(real)
                                   if not k.startswith('__')})
    lax.scan = scan
    orig = jdh._power_k, jdh.lax
    jdh._power_k = lambda nxt, nbits_cap, k: jnp.asarray(F)
    jdh.lax = lax
    try:
        with jax.disable_jit():
            jdh.huffman_walk_dev.__wrapped__(
                jnp.zeros(cap // 8 + 16, jnp.uint8), 0, cap, n, G,
                jnp.zeros((G, jdh.MAX_CODE_BITS + 2), jnp.int32),
                jnp.zeros((G, jdh.MAX_CODE_BITS + 1), jnp.int32),
                jnp.zeros((G, 258), jnp.int32), jnp.ones(G, jnp.int32),
                jnp.asarray(sel), n, 1, jdh.GROUP_SIZE // sub)
    finally:
        jdh._power_k, jdh.lax = orig
    return seen[1]


def _chase_case(case):
    """(F (G, cap) int32, sel int32, sub) for the edge cases of a chase
    that stages F's windows ahead of the chain."""
    rng = np.random.default_rng(len(case))
    G, cap, n, sub = 6, 1 << 15, 200, 1
    lo, hi = 50, 1001            # one chunk moves 50..1000 bits
    if case == 'clamped_tail':   # the last chunks sit at cap - 1
        cap, n = 1 << 14, 120
    elif case == 'longest_steps':  # every code 20 bits: 1000 a chunk
        lo, hi, n = 1000, 1001, 30
    elif case == 'sub5':
        sub, lo, hi = 5, 10, 201
    elif case == 'cap_below_window':
        cap, n = 1000, 30
    elif case == 'cap_ragged':   # not a multiple of a window, nor of 4
        cap, n = 5001, 80
    pos = np.arange(cap)[None, :]
    F = np.minimum(pos + rng.integers(lo, hi, (G, cap)), cap - 1)
    sel = rng.integers(0, G, n)
    if case == 'alternating':
        sel = np.arange(n) % G
    elif case == 'selector_past_G':
        sel[::7] = G
        sel[3::11] = G + 40
    return F.astype(np.int32), sel.astype(np.int32), sub


CHASE_CASES = ['clamped_tail', 'longest_steps', 'alternating',
               'selector_past_G', 'cap_below_window', 'cap_ragged', 'sub5']


@pytest.mark.parametrize('case', CHASE_CASES)
def test_selector_chase_plain_edge_cases_match_jax(case):
    """The chase's plain version (the card kernel's reference) equals the
    JAX package's chase on the inputs where a staged chase could go wrong:
    a chain stuck at cap - 1, the longest steps, groups alternating over
    all six rows, selectors past G (clamped into F), caps below a window
    or not a multiple of it, and five steps per selector."""
    F, sel, sub = _chase_case(case)
    want = _jax_package_chase(F, sel, sub)
    got = dh.selector_chase_plain(torch.from_numpy(F), torch.from_numpy(sel),
                                  sub).numpy()
    np.testing.assert_array_equal(got, want)
    if case != 'selector_past_G':   # the step-by-step loop does not clamp
        np.testing.assert_array_equal(got, _chase_reference(F, sel, sub))
    if case == 'clamped_tail':
        assert (got[-5:] == F.shape[1] - 1).all()


def _lens_walk(val, lens, starts, sel, bases, permutes):
    """The chunk walk read step by step from stage 1's code lengths
    (G, nbits_cap): chunk c from starts[c] (0 past len(starts))."""
    cap = val.shape[0]
    syms = np.empty((sel.shape[0], dh.GROUP_SIZE), np.int64)
    ends = np.empty_like(syms)
    for c, g in enumerate(sel.tolist()):
        pos = int(starts[c]) if c < starts.shape[0] else 0
        for t in range(dh.GROUP_SIZE):
            ln = int(lens[g, pos])
            j = (int(val[pos]) >> (dh.MAX_CODE_BITS - ln)) - int(bases[g, ln])
            syms[c, t] = int(permutes[g, min(max(j, 0), 257)])
            ends[c, t] = pos + ln
            pos = min(pos + ln, cap - 1)
    return syms.reshape(-1), ends.reshape(-1)


def _random_tables(seed, G, nbits_cap, s_cap):
    """Random payload and tables whose min_len is above 1 and whose
    limits make some offsets fit no code; n_selectors below s_cap."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, nbits_cap // 8 + 4).astype(np.uint8)
    limits = np.full((G, dh.MAX_CODE_BITS + 2), -1, np.int32)
    for g in range(G):
        for L in range(1, dh.MAX_CODE_BITS + 2):
            limits[g, L] = rng.choice([-1, int(rng.integers(
                0, 1 << min(L, 20))), dh.BIG_LIMIT])
    mins = rng.integers(2, 6, G).astype(np.int32)
    bases = rng.integers(-300, 300, (G, 21)).astype(np.int32)
    perms = rng.integers(0, 258, (G, 258)).astype(np.int32)
    n_sel = s_cap - 7
    sel = np.zeros(s_cap, np.int32)
    sel[:n_sel] = rng.integers(0, G, n_sel)
    return [torch.from_numpy(x) for x in (payload, limits, bases, perms,
                                          mins, sel)] + [n_sel]


@pytest.mark.parametrize('seed,G', [(0, 2), (1, 6), (2, 3), (3, 6)])
def test_chunk_walk_plain_reads_stage1_lengths(seed, G):
    """The plain chunk walk finds each step's code length at its offset;
    it equals the walk that reads stage 1's lengths there, on the whole
    symbol and end arrays, chunks past n_selectors included."""
    payload, limits, bases, perms, mins, sel, n_sel = _random_tables(
        seed, G, 4096, 64)
    val, lens, nxt = dh._next_maps(payload, seed % 8, 4096, limits, mins)
    starts = dh.selector_chase(dh._power_k(nxt, dh.POWER_K_DEFAULT),
                               sel[:n_sel], 1)
    syms, ends = dh.chunk_walk_plain(val, sel, starts, limits, bases, perms,
                                     mins)
    want_s, want_e = _lens_walk(val.numpy(), lens.numpy(), starts.numpy(),
                                sel.numpy(), bases.numpy(), perms.numpy())
    np.testing.assert_array_equal(syms.numpy(), want_s)
    np.testing.assert_array_equal(ends.numpy(), want_e)


def test_walk_on_cpu_runs_plain_versions(monkeypatch):
    """For CPU tensors the walk's stages are the plain versions: nothing
    is built or launched."""
    from compressjs_tpu_torch.ops import _cuda

    def no_kernels():
        raise AssertionError('a CPU walk asked for the CUDA library')

    monkeypatch.setattr(_cuda, 'lib', no_kernels)
    before = dict(_cuda.launches)
    payload, limits, bases, perms, mins, sel, n_sel = _random_tables(
        4, 6, 4096, 64)
    val, nxt = dh.walk_maps(payload, 5, 4096, limits, mins)
    want_val, _, want_nxt = dh._next_maps(payload, 5, 4096, limits, mins)
    assert torch.equal(val, want_val) and torch.equal(nxt, want_nxt)
    starts = sel[:n_sel] * 7
    got = dh.chunk_walk(val, sel, starts, limits, bases, perms, mins)
    want = dh.chunk_walk_plain(val, sel, starts, limits, bases, perms, mins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    comp, header, sym_start = _first_block(_data('text'))
    nbits_cap = (comp.shape[0] - (sym_start >> 3)) * 8
    _both_walks(comp, header, sym_start, nbits_cap, len(header[2]))
    assert _cuda.launches == before


def test_walk_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain versions; elsewhere the wrappers
    launch their kernels or raise."""
    m = torch.empty(4096, dtype=torch.int32, device='meta')
    tabs = [torch.empty(s, dtype=torch.int32, device='meta')
            for s in ((6, 22), (6, 21), (6, 258), (6,))]
    with pytest.raises(RuntimeError):
        dh.walk_maps(m.to(torch.uint8), 0, 4096, tabs[0], tabs[3])
    with pytest.raises(RuntimeError):
        dh.chunk_walk(m, m[:64], m[:10], *tabs)
