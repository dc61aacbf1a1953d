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
from compressjs_tpu_torch.host import huffman_allocator as ha
from compressjs_tpu_torch.ops import _cuda
from compressjs_tpu_torch.ops import device_entropy as de_t
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

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
    err = torch.zeros(1, dtype=torch.int32)
    got = de_t.code_lengths_batch(torch.from_numpy(freqs), m, err).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(err) == 0


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


def _fused_rows(m, B):
    """B frequency rows over m symbols, in symbol order: row 0 Fibonacci
    (past 29 symbols, the first 29 repeated, which forces the 20-bit
    limit), the others uniform and zipf."""
    rng = np.random.default_rng(10 * m + B)
    rows = np.zeros((B, N), dtype=np.int32)
    rows[0, :m] = rng.permutation(np.resize(_fib(min(m, 29)), m))
    for i in range(1, B):
        rows[i, :m] = (rng.integers(0, 900001 // m, m) if i % 2 else
                       np.minimum(rng.zipf(1.3, m), 900001 // m))
    return rows


@pytest.mark.parametrize('B', [1, 2, 6])
@pytest.mark.parametrize('m', [3, 4, 258])
def test_code_lengths_plain_matches_jax(m, B):
    """The fused table build's plain version (sort, allocate, scatter
    back) equals the JAX build with the Pallas allocator in interpret
    mode."""
    freqs = _fused_rows(m, B)
    want = np.asarray(de_j.code_lengths_batch(jnp.asarray(freqs), m,
                                              'pallas_interpret'))
    lens, flags = de_t.code_lengths_plain(torch.from_numpy(freqs), m)
    np.testing.assert_array_equal(lens.numpy(), want)
    assert flags.tolist() == [0] * B
    if m == 258:
        assert int(lens[0].max()) == de_t.MAX_LEN


def test_code_lengths_plain_flags_keys_it_cannot_sort():
    freqs = _fused_rows(258, 3)
    freqs[1, 7] = 1 << 22      # past the (freq << 9 | sym) key
    freqs[2, 0] = -1
    lens, flags = de_t.code_lengths_plain(torch.from_numpy(freqs), 258)
    assert flags.tolist() == [0, 1, 1]
    want, _ = de_t.code_lengths_plain(torch.from_numpy(freqs[:1]), 258)
    assert torch.equal(lens[:1], want)


def _flag_every_table(monkeypatch):
    plain = de_t.alloc_lengths_plain

    def flagged(arrs, ms):
        out, flags = plain(arrs, ms)
        return out, torch.ones_like(flags)

    monkeypatch.setattr(de_t, 'alloc_lengths_plain', flagged)


def test_code_lengths_batch_defers_its_flag(monkeypatch):
    """A flagged table sets the caller's flag tensor, which stays set,
    and the build does not raise; the sorted-table allocator still raises
    at once."""
    freqs = torch.from_numpy(_fused_rows(40, 2))
    err = torch.zeros(1, dtype=torch.int32)
    de_t.code_lengths_batch(freqs, 40, err)
    assert int(err) == 0
    _flag_every_table(monkeypatch)
    de_t.code_lengths_batch(freqs, 40, err)
    assert int(err) == 1
    de_t.code_lengths_batch(freqs, 40, err)
    assert int(err) == 1
    with pytest.raises(RuntimeError):
        de_t.alloc_lengths(*[torch.from_numpy(x) for x in _tables('tiny')])


@pytest.mark.parametrize('n_syms', [700, 20000])
def test_optimize_groups_raises_on_flagged_table(monkeypatch, n_syms):
    """The per-block flag, read with the Lloyd loop's cost, raises before
    any table or payload leaves the group optimisation."""
    rng = np.random.default_rng(n_syms)
    m = 100
    buf = np.minimum(rng.zipf(1.5, n_syms + 13) - 1, m - 2).astype(np.int16)
    buf[n_syms - 1:] = m - 1
    freq = np.bincount(buf[:n_syms], minlength=N).astype(np.int32)
    args = (torch.from_numpy(buf), n_syms, -(-buf.shape[0] // 50),
            torch.from_numpy(freq), m)
    de_t.optimize_groups_dev(*args)
    _flag_every_table(monkeypatch)
    with pytest.raises(RuntimeError, match='loop bound'):
        de_t.optimize_groups_dev(*args)


def test_encode_raises_on_flagged_table(monkeypatch):
    from compressjs_tpu_torch import compress_file_device
    data = bytes(np.random.default_rng(5).integers(97, 103, 3000,
                                                   dtype=np.uint8))
    _flag_every_table(monkeypatch)
    with pytest.raises(RuntimeError, match='loop bound'):
        compress_file_device(data, level=1, device='cpu')


_scalar_first = ha._first


def _warp_first(array, i, nodes_to_move):
    """A model of the card allocator's `first_node`
    (csrc/alloc_lengths.cu): where a[i] % m > i, two 32-lane probes (32
    points spread over [lo, i], then the slots of the bracket the first
    hit closes) find the smallest k with a[k] % m > i; otherwise the
    scalar binary search runs.  Returns (k, whether a probe's hits were
    not a run up to its end, which flags the table)."""
    m = len(array)
    limit = i

    def hit(k):
        return array[k] % m > limit

    if not (i >= nodes_to_move and hit(i)):
        return _scalar_first(array, i, nodes_to_move), False
    lo = max(nodes_to_move, 0)
    stride = (limit - lo + 32) >> 5
    probe = [lo + lane * stride for lane in range(32)
             if lo + lane * stride <= limit]
    hits = [hit(k) for k in probe]
    flagged = False
    if not any(hits):
        bottom, top = probe[-1], limit
    else:
        f = hits.index(True)
        flagged |= not all(hits[f:])
        top = probe[f]
        bottom = lo - 1 if f == 0 else top - stride
    fine = list(range(bottom + 1, top))
    hits = [hit(k) for k in fine]
    if any(hits):
        g = hits.index(True)
        flagged |= not all(hits[g:])
        return fine[g], flagged
    return top, flagged


def test_warp_search_model_matches_scalar_search(monkeypatch):
    """Every search the allocator makes on ~300 tables of all alphabet
    sizes gives the same index through the card's two-probe warp search
    (modelled on the host) as through the scalar gallop and binary
    search, and never trips the warp search's flag: the predicate is
    monotone where the probes look."""
    calls = []

    def both(array, i, nodes_to_move):
        k = _scalar_first(array, i, nodes_to_move)
        assert _warp_first(array, i, nodes_to_move) == (k, False)
        calls.append(k)
        return k

    monkeypatch.setattr(ha, '_first', both)
    rng = np.random.default_rng(17)
    for m in range(3, 259, 5):
        for freqs in (rng.integers(0, 900001 // m + 1, m),
                      np.minimum(rng.zipf(1.2, m), 900001 // m),
                      np.resize(_fib(29), m), np.r_[np.zeros(m - 1, int), 5],
                      rng.integers(0, 3, m), rng.integers(0, 2, m) * 1000 + 1):
            ha.allocate_huffman_code_lengths(sorted(freqs.tolist()),
                                             de_t.MAX_LEN)
    assert len(calls) > 5000
