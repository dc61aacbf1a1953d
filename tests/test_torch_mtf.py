"""A host model of the MTF kernels' warp design (csrc/mtf_scan.cu,
csrc/mtf_undo.cu), held against the JAX package's ``jk.mtf_encode`` and
``jk.mtf_decode``, and the port's plain start lists held against the JAX
package's and against the model's.

The model keeps a warp's list as the kernels do: position `lane` in
front[lane], positions 32 + 7 * lane + k in tail[lane, k].  A ballot is a
boolean vector over the 32 lanes, ffs its first set lane, a shuffle an
index into a lane vector.  Only the steps that change the list run (the
kernels stage them in shared memory, in order): a symbol that differs
from the one before it, a non-zero index; an index of 0 outputs what the
last step before it moved.  The encode's step searches the front 32 and
takes the deep path through the tail only when the ballot finds nothing,
the decode's takes it for j >= 32 or an index outside the list.  With
`check_lists` the model's list is compared with a scalar move-to-front
list after every step.  Integer code: equality is exact.
"""

import bz2
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.ops import jax_kernels as jk
from compressjs_tpu_torch.ops import block_decode as bd
from compressjs_tpu_torch.ops import block_kernels as bk
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

# the encode's chunks (any length gives the same codes) and the decode's
# (an index outside the list makes the decode depend on them: the JAX
# package's 512)
CHUNK, DCHUNK, TILE, TAIL, WIDTH = 512, 512, 16, 7, 256
LANES = np.arange(32)
TAIL_POS = 32 + TAIL * LANES[:, None] + np.arange(TAIL)[None, :]
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')

assert bk.CHUNK_LEN == CHUNK and bd.CHUNK_LEN == DCHUNK
assert bk.TILE_CHUNKS == bd.TILE_CHUNKS == TILE


class Warp:
    """One warp's list and the counts of its steps."""

    def __init__(self, lst):
        lst = np.asarray(lst, dtype=np.int64)
        self.front = lst[:32].copy()
        self.tail = lst[TAIL_POS].copy()
        self.steps = {'walked': 0, 'deep': 0}

    def as_list(self):
        out = np.empty(WIDTH, dtype=np.int64)
        out[:32] = self.front
        out[TAIL_POS] = self.tail
        return out

    def shift_in(self, j, v):
        """Positions 1..j take the value before them, position 0 takes v
        (the front and tail moves of the kernels' steps)."""
        up = np.concatenate([self.front[:1], self.front[:-1]])
        if j >= 32:
            carry = np.concatenate([[self.front[31]], self.tail[:-1, -1]])
            moved = np.concatenate([carry[:, None], self.tail[:, :-1]], 1)
            self.tail = np.where(TAIL_POS <= j, moved, self.tail)
            self.steps['deep'] += 1
        self.front = np.where(LANES <= j, up, self.front)
        self.front[0] = v

    def scan_step(self, s):
        """The encode's step for symbol s: returns its code."""
        self.steps['walked'] += 1
        hit = self.front == s                        # ballot
        if hit.any():
            j = int(np.argmax(hit))                  # ffs
            self.shift_in(j, s)
            return j
        m = self.tail == s
        owner = int(np.argmax(m.any(1)))             # ballot, ffs
        j = int(TAIL_POS[owner, np.argmax(m[owner])])
        self.shift_in(j, s)
        return j

    def undo_step(self, j):
        """The decode's step at a non-zero index j: the value moved."""
        self.steps['walked'] += 1
        if 0 < j < 32:
            moved = int(self.front[j])               # shuffle from lane j
            self.shift_in(j, moved)
            return moved
        moved = 0
        if 32 <= j < WIDTH:
            q = j - 32
            moved = int(self.tail[q // TAIL, q % TAIL])
        self.shift_in(j, moved)
        return moved


def scalar_step(lst, j, v):
    """Reference move-to-front on a Python list, the JAX masked-select
    semantics for an index outside it."""
    if j < 0:
        lst[0] = v
    else:
        del lst[min(j, WIDTH - 1)]
        lst.insert(0, v)


def encode_chunk(warp, syms, check_lists):
    """Codes of one chunk's symbols (its lanes past n left out)."""
    codes = np.zeros(len(syms), dtype=np.int64)
    ref = list(warp.as_list()) if check_lists else None
    for g in range(0, len(syms), 32):
        mine = syms[g:g + 32]
        prev = np.concatenate([[warp.front[0]], mine[:-1]])
        for q in np.flatnonzero(mine != prev):       # the walked lanes
            codes[g + q] = warp.scan_step(int(mine[q]))
            if check_lists:
                j = ref.index(int(mine[q]))
                assert codes[g + q] == j
                scalar_step(ref, j, int(mine[q]))
                assert list(warp.as_list()) == ref
    return codes


def undo_chunk(warp, idx, check_lists):
    """Values of one chunk's indices; an index 0 takes what the last
    non-zero index before it moved, or the front the chunk started from."""
    values = np.zeros(len(idx), dtype=np.int64)
    ref = list(warp.as_list()) if check_lists else None
    first = int(warp.front[0])
    walked = np.flatnonzero(idx != 0)
    for q in walked:
        values[q] = warp.undo_step(int(idx[q]))
        if check_lists:
            j = int(idx[q])
            v = ref[j] if 0 <= j < WIDTH else 0
            assert values[q] == v
            scalar_step(ref, j, v)
            assert list(warp.as_list()) == ref
    # how many non-zero indices sit at or before each index
    upto = np.cumsum(idx != 0)
    last = values[walked[np.maximum(upto - 1, 0)]] if len(walked) else 0
    zero = idx == 0
    values[zero] = np.where(upto > 0, last, first)[zero]
    return values


def bitonic_desc(keys):
    """The warp's bitonic sort: keys (32 lanes, 8 slots), key e = 8 * lane
    + r in keys[lane, r], the same compare-exchanges as csrc
    bitonic_desc; returns the 256 keys in order."""
    key = np.array(keys, dtype=np.int64)
    e = 8 * LANES[:, None] + np.arange(8)[None, :]
    k = 2
    while k <= WIDTH:
        j = k // 2
        while j > 0:
            desc = (e & k) == 0
            if j >= 8:
                other = key[LANES ^ (j // 8)]        # shuffle xor
                lower = ((LANES & (j // 8)) == 0)[:, None]
                key = np.where(lower == desc, np.maximum(key, other),
                               np.minimum(key, other))
            else:
                new = key.copy()
                for r in range(8):
                    if r & j:
                        continue
                    a, b = key[:, r], key[:, r + j]
                    d = desc[:, r]
                    new[:, r] = np.where(d, np.maximum(a, b),
                                         np.minimum(a, b))
                    new[:, r + j] = np.where(d, np.minimum(a, b),
                                             np.maximum(a, b))
                key = new
            j //= 2
        k *= 2
    return key.reshape(-1)


def encode_start_lists(data, n):
    """The start list of every chunk as csrc/mtf_scan.cu builds it: each
    tile's last occurrences, their exclusive max-scan over tiles from
    -(s+1), then per chunk the earlier chunks of its tile, the packed
    keys and the warp's sort.  Returns (agg, pre, lists)."""
    n_chunks = -(-n // CHUNK)
    n_tiles = -(-n_chunks // TILE)
    last = np.full((n_tiles * TILE, WIDTH), -1, dtype=np.int64)
    for i in range(n):
        last[i // CHUNK, data[i]] = i
    agg = last.reshape(n_tiles, TILE, WIDTH).max(1)
    pre = np.empty_like(agg)
    run = -1 - np.arange(WIDTH)
    for t in range(n_tiles):
        pre[t] = run
        run = np.maximum(run, agg[t])
    lists = np.empty((n_chunks, WIDTH), dtype=np.int64)
    s = 32 * np.arange(8)[None, :] + LANES[:, None]    # key[lane, r]
    for c in range(n_chunks):
        t, w = divmod(c, TILE)
        before = pre[t].copy()
        for v in range(w):
            before = np.maximum(before, last[t * TILE + v])
        keys = ((before[s] + 257) << 8) | (WIDTH - 1 - s)
        lists[c] = WIDTH - 1 - (bitonic_desc(keys) & (WIDTH - 1))
    return agg, pre, lists


def model_encode(data, n, check_lists=False):
    """(codes, step counts) of the encode kernel's model."""
    data = np.asarray(data[:n], dtype=np.int64)
    _, _, lists = encode_start_lists(data, n)
    codes = np.zeros(n, dtype=np.int64)
    steps = {'walked': 0, 'deep': 0}
    for c in range(lists.shape[0]):
        warp = Warp(lists[c])
        sl = slice(c * CHUNK, min(n, (c + 1) * CHUNK))
        codes[sl] = encode_chunk(warp, data[sl], check_lists)
        for key in steps:
            steps[key] += warp.steps[key]
    return codes, steps


def undo_start_lists(idx, n):
    """The chunks' permutations, each tile's composition of them, the
    list before each tile and the start list of every chunk, as
    csrc/mtf_undo.cu builds them."""
    n_chunks = -(-n // DCHUNK)
    n_tiles = -(-n_chunks // TILE)
    perm = np.tile(np.arange(WIDTH), (n_tiles * TILE, 1))
    for c in range(n_chunks):
        warp = Warp(np.arange(WIDTH))
        undo_chunk(warp, idx[c * DCHUNK:min(n, (c + 1) * DCHUNK)], False)
        perm[c] = warp.as_list()
    agg = np.empty((n_tiles, WIDTH), dtype=np.int64)
    for t in range(n_tiles):
        x = np.arange(WIDTH)
        for v in range(TILE - 1, -1, -1):
            x = perm[t * TILE + v][x]
        agg[t] = x
    tile_lists = np.empty_like(agg)
    cur = np.arange(WIDTH)
    for t in range(n_tiles):
        tile_lists[t] = cur
        cur = cur[agg[t]]
    lists = np.empty((n_chunks, WIDTH), dtype=np.int64)
    for c in range(n_chunks):
        t, w = divmod(c, TILE)
        x = np.arange(WIDTH)
        for v in range(w - 1, -1, -1):
            x = perm[t * TILE + v][x]
        lists[c] = tile_lists[t][x]
    return perm[:n_chunks], agg, tile_lists, lists


def model_decode(idx, n, check_lists=False):
    """(values, step counts of the decode launch) of the MTF-undo
    kernels' model."""
    idx = np.asarray(idx[:n], dtype=np.int64)
    _, _, _, lists = undo_start_lists(idx, n)
    values = np.zeros(n, dtype=np.int64)
    steps = {'walked': 0, 'deep': 0}
    for c in range(lists.shape[0]):
        warp = Warp(lists[c])
        sl = slice(c * DCHUNK, min(n, (c + 1) * DCHUNK))
        values[sl] = undo_chunk(warp, idx[sl], check_lists)
        for key in steps:
            steps[key] += warp.steps[key]
    return values, steps


def _sample5_block():
    """Dense BWT of sample5's first -9 block (the encode's MTF input)."""
    from compressjs_tpu_torch.host.rle1 import rle1_encode
    from compressjs_tpu_torch.host.bzip2 import block_meta
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        data = bz2.decompress(f.read())
    block, _ = rle1_encode(np.frombuffer(data, np.uint8), 0, 899981)
    _, _, remap = block_meta(block)
    U, _ = bk.bwt_block(torch.from_numpy(block), block.shape[0])
    return remap[U.numpy()].astype(np.int32)


def _cycle(period, n):
    """Symbols 0..period-1 over and over: after the first round every
    code is period - 1."""
    return (np.arange(n) % period).astype(np.int32)


def _encode_case(kind):
    """(symbols int32, n, width)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    if kind == 'runs':                   # j = 0 runs, group-long and longer
        d = np.repeat(rng.integers(0, 40, 60), rng.integers(1, 90, 60))
        return d.astype(np.int32), len(d), 64
    if kind == 'j31':
        return _cycle(32, 2000), 2000, 256
    if kind == 'j32':
        return _cycle(33, 2000), 2000, 256
    if kind == 'j255':
        return _cycle(256, 1800), 1800, 256
    if kind == 'width64':
        d = np.minimum(rng.zipf(1.3, 3000) - 1, 63)
        return d.astype(np.int32), 3000, 64
    if kind == 'short':                  # n < 32
        return np.array([5, 5, 3, 200, 5, 0, 0, 7], np.int32), 8, 256
    if kind == 'ragged':                 # a last chunk of 77
        d = np.minimum(rng.zipf(1.2, 3 * CHUNK + 77) - 1, 255)
        return d.astype(np.int32), 3 * CHUNK + 77, 256
    if kind == 'run_across_edges':       # one run over a group and a chunk
        d = rng.integers(0, 256, 17 * CHUNK + 40)
        d[CHUNK - 12:CHUNK + 18] = 9     # across the first chunk edge
        d[60:70] = 4                     # across the group edge at 64
        d[TILE * CHUNK - 3:TILE * CHUNK + 40] = 11   # across a tile edge
        return d.astype(np.int32), len(d), 256
    if kind == 'uniform':                # most steps take the deep path
        return rng.integers(0, 256, 4000).astype(np.int32), 4000, 256
    raise ValueError(kind)


ENCODE_CASES = ['runs', 'j31', 'j32', 'j255', 'width64', 'short', 'ragged',
                'run_across_edges', 'uniform']


@pytest.mark.parametrize('kind', ENCODE_CASES)
def test_encode_model_matches_jax(kind):
    d, n, width = _encode_case(kind)
    want = np.asarray(jk.mtf_encode(jnp.asarray(d), n, 512, width))
    got, steps = model_encode(d, n, check_lists=n <= 5000)
    np.testing.assert_array_equal(got, want)
    assert steps['walked'] == int((np.concatenate(
        [[0], d[:n]])[1:] != np.concatenate([[0], d[:n - 1]])).sum())
    if kind == 'j255':
        assert (want[256:] == 255).all() and steps['deep'] > 1000
    if kind in ('j31', 'j32'):
        assert want[-1] == int(kind[1:])


def _decode_case(kind):
    """(indices int32, n)."""
    rng = np.random.default_rng(sum(map(ord, kind)))
    idx = np.minimum(rng.zipf(1.3, 3000) - 1, 255).astype(np.int32)
    if kind == 'zipf':
        return idx, 3000
    if kind == 'deep':                   # j = 31, 32 and 255
        idx[::5] = 31
        idx[1::5] = 32
        idx[2::7] = 255
        return idx, 3000
    if kind == 'outside':                # -1 and 256, past and before
        idx[3::97] = 256
        idx[5::89] = -1
        idx[9::71] = 1000
        return idx, 2999
    if kind == 'short':
        return np.array([0, 3, 0, 0, 1, 40, 0], np.int32), 7
    if kind == 'ragged':                 # a last chunk of 397
        return idx, 2 * DCHUNK + 397
    if kind == 'zero_edges':             # zero runs over group, chunk and
        idx[60:70] = 0                   # tile edges, and the zero tail
        idx[500:530] = 0                 # bwt_column decodes
        idx = np.concatenate([idx, np.zeros(6000, np.int32)])
        idx[TILE * DCHUNK - 3:TILE * DCHUNK + 40] = 0
        return idx, 9000
    raise ValueError(kind)


DECODE_CASES = ['zipf', 'deep', 'outside', 'short', 'ragged', 'zero_edges']


@pytest.mark.parametrize('kind', DECODE_CASES)
def test_decode_model_matches_jax(kind):
    idx, n = _decode_case(kind)
    want = np.asarray(jk.mtf_decode(jnp.asarray(idx), n))
    got, steps = model_decode(idx, n, check_lists=n <= 5000)
    np.testing.assert_array_equal(got, want)
    assert steps['walked'] == int((idx[:n] != 0).sum())


def test_sample5_block_through_the_models():
    """sample5's first block: the encode model against the JAX encode,
    the decode model against the JAX decode of those codes (padded with
    zeros to the block capacity, as the walk hands them over), and the
    share of steps each walks and takes deep."""
    d = _sample5_block()
    n = d.shape[0]
    want = np.asarray(jk.mtf_encode(jnp.asarray(d), n, 512, 256))
    got, steps = model_encode(d, n)
    np.testing.assert_array_equal(got, want)
    assert steps['walked'] < 0.25 * n and steps['deep'] < 0.01 * n
    codes = np.zeros(900000, np.int32)
    codes[:n] = want
    dec, dsteps = model_decode(codes, 900000)
    np.testing.assert_array_equal(dec[:n], d)
    np.testing.assert_array_equal(
        dec, np.asarray(jk.mtf_decode(jnp.asarray(codes), 900000)))
    assert dsteps['walked'] == int((codes != 0).sum())


def test_bitonic_model_sorts():
    rng = np.random.default_rng(3)
    for _ in range(20):
        keys = rng.permutation(1 << 12)[:WIDTH].reshape(32, 8)
        np.testing.assert_array_equal(bitonic_desc(keys),
                                      np.sort(keys.reshape(-1))[::-1])


@pytest.mark.parametrize('kind', ['width64', 'ragged', 'run_across_edges',
                                  'uniform', 'short'])
def test_encode_start_lists_match_plain_and_jax(kind):
    """The model's start lists (tiles, prefix, warp sort) against the
    port's plain `_chunk_start_lists` and the JAX start positions, and
    its tile prefix against the plain exclusive scan."""
    d, n, width = _encode_case(kind)
    agg, pre, lists = encode_start_lists(d.astype(np.int64), n)
    chunks = bk._pad_chunks(torch.from_numpy(d), n)
    plain = bk._chunk_start_lists(chunks).numpy()
    np.testing.assert_array_equal(lists, plain)
    before = bk._last_before(bk._last_occurrences(chunks)).numpy()
    np.testing.assert_array_equal(pre, before[::TILE])
    jpos = np.asarray(jk._chunk_start_positions(
        jnp.asarray(chunks.numpy().astype(np.int32)), chunks.shape[0], CHUNK,
        width))
    np.testing.assert_array_equal(np.argsort(jpos, axis=1), plain[:, :width])


@pytest.mark.parametrize('kind', ['outside', 'ragged', 'zero_edges'])
def test_undo_start_lists_match_plain(kind):
    """The model's chunk permutations, tile lists and chunk start lists
    against the plain `_chunk_perms` and `_start_lists`."""
    idx, n = _decode_case(kind)
    perm, _, tile_lists, lists = undo_start_lists(idx.astype(np.int64), n)
    _, pperm = bd._chunk_perms(torch.from_numpy(idx), n)
    np.testing.assert_array_equal(perm, pperm.numpy())
    plain = bd._start_lists(pperm).numpy()
    np.testing.assert_array_equal(lists, plain)
    np.testing.assert_array_equal(tile_lists, plain[::TILE])
