"""Tensor build of the bzip2 block decode after the Huffman walk: RLE2
undo, MTF undo, inverse BWT and RLE1 undo (counterpart of the decode
half of ``compressjs_tpu.ops.jax_kernels``).

Where the JAX package used ``lax.associative_scan`` the port uses:

* a producer lookup, ``searchsorted`` of each output slot in the
  inclusive sum of per-input output counts, for the RLE expansions;
* Hillis-Steele doubling (ceil(log2 n) rounds, each composing every
  element with the one 2^r before it) for the composition scans of the
  RLE1 state machine and of the plain version's MTF chunk lists;
* list ranking by pointer doubling for the inverse BWT's orbit.

All functions take tensors on any device and return tensors on it; none
of them synchronises with the host unless its docstring says so.  MTF
undo runs three CUDA kernels (``csrc/mtf_undo.cu``) for a CUDA tensor.
"""

from __future__ import annotations

import torch

from . import _cuda

# MTF chunk length (fixed in csrc/mtf_undo.cu).  An index outside the list
# writes a 0 that the composition of chunk maps does not carry, so the
# decode of such input depends on the chunks: 512, as the JAX package.
CHUNK_LEN = 512
WIDTH = 256       # MTF list length
TILE_CHUNKS = 16  # chunks per tile of the start-list scan (csrc/mtf_undo.cu)


def _producers(out_cnt, out_cap):
    """For each output slot t < out_cap, the index i of the input that
    writes it (the first i whose inclusive output-count sum exceeds t),
    clamped into range; and the total output count (0-dim tensor)."""
    ends = torch.cumsum(out_cnt, 0)
    slots = torch.arange(out_cap, device=out_cnt.device)
    iat = torch.searchsorted(ends, slots, right=True)
    return iat.clamp_(max=out_cnt.shape[0] - 1), ends[-1]


def _scan_compose(maps, earlier_first):
    """Inclusive scan of (n, m) lookup tables under composition.  With
    earlier_first, out[i][s] = maps[i][...maps[0][s]] (the earlier table
    applied first); otherwise out[i][s] = maps[0][...maps[i][s]]."""
    n, d = maps.shape[0], 1
    while d < n:
        nxt = maps.clone()
        if earlier_first:
            nxt[d:] = torch.gather(maps[d:], 1, maps[:-d])
        else:
            nxt[d:] = torch.gather(maps[:-d], 1, maps[d:])
        maps, d = nxt, 2 * d
    return maps


def rle2_decode(syms, out_cap, count):
    """Invert RLE2: RUNA/RUNB digit groups become zero runs (bijective
    base 2), literal j+1 becomes j.  syms[:count] excludes the EOB.
    Returns (mtf indices int32[out_cap], total count)."""
    dev = syms.device
    n = syms.shape[0]
    s = syms.to(torch.int64)
    idx = torch.arange(n, device=dev)
    valid = idx < count
    is_digit = (s < 2) & valid
    # start of each digit group: 1 + index of the last non-digit at or
    # before i; the k-th non-digit records its index+1 in slot k
    non_digit = ~is_digit
    gid = torch.cumsum(non_digit, 0)
    mark = torch.zeros(n + 2, dtype=torch.int64, device=dev)
    mark.scatter_(0, torch.where(non_digit, gid, n + 1), idx + 1)
    grp_start = mark[gid]
    dpos = idx - grp_start
    contrib = torch.where(is_digit, (s + 1) << dpos.clamp(max=30), 0)
    csum = torch.cumsum(contrib, 0)
    grp_end = is_digit & torch.cat([non_digit[1:], non_digit.new_ones(1)])
    seg_base = torch.where(grp_start > 0,
                           csum[(grp_start - 1).clamp(min=0)], 0)
    run_len = torch.where(grp_end, csum - seg_base, 0)
    out_cnt = torch.where(is_digit, run_len, valid.to(torch.int64))
    iat, total = _producers(out_cnt, out_cap)
    val = torch.where(s[iat] < 2, 0, s[iat] - 1)
    out = torch.where(torch.arange(out_cap, device=dev) < total, val, 0)
    return out.to(torch.int32), total


def _mtf_at(lists, js, pos):
    """Move-to-front at index js[c] of each row (pos = arange(WIDTH)):
    (new lists, the values moved).  Position 0 takes the moved value and
    positions 1..js[c] the value before them.  An index outside the list
    moves value 0 to the front (an index past it shifts the whole row),
    as the JAX package's masked select does."""
    inside = (js >= 0) & (js < WIDTH)
    moved = torch.where(
        inside, lists.gather(1, js.clamp(0, WIDTH - 1)[:, None])[:, 0], 0)
    new = torch.where(pos[None, :] <= js[:, None], torch.roll(lists, 1, 1),
                      lists)
    new[:, 0] = moved
    return new, moved


def _start_lists(perm):
    """The list before each chunk, uint8 (n_chunks, WIDTH), from each
    chunk's permutation of the list: the list before chunk c is the one
    before c-1 permuted by c-1."""
    inclusive = _scan_compose(perm.to(torch.int64), earlier_first=False)
    lists = torch.empty_like(perm)
    lists[:1] = torch.arange(WIDTH, dtype=torch.uint8, device=perm.device)
    lists[1:] = inclusive[:-1]
    return lists


def _chunk_perms(indices, n):
    """(chunks, perm): indices[:n] as (n_chunks, CHUNK_LEN) int64 padded
    with 0, and each chunk's indices applied to the identity list, uint8
    (n_chunks, WIDTH)."""
    dev = indices.device
    n_chunks = -(-n // CHUNK_LEN)
    d = torch.zeros(n_chunks * CHUNK_LEN, dtype=torch.int64, device=dev)
    d[:n] = indices[:n]
    chunks = d.view(n_chunks, CHUNK_LEN)
    pos = torch.arange(WIDTH, device=dev)
    perm = torch.arange(WIDTH, dtype=torch.uint8, device=dev).expand(
        n_chunks, WIDTH)
    for t in range(CHUNK_LEN):
        perm, _ = _mtf_at(perm, chunks[:, t], pos)
    return chunks, perm


def mtf_decode_plain(indices, n):
    """Plain version of `mtf_decode`: two Python loops of CHUNK_LEN
    steps, each step moving every chunk's list at once, and the
    composition scan of `_start_lists` between them."""
    chunks, perm = _chunk_perms(indices, n)
    lists = _start_lists(perm)
    pos = torch.arange(WIDTH, device=indices.device)
    out = torch.empty((CHUNK_LEN, chunks.shape[0]), dtype=torch.uint8,
                      device=indices.device)
    for t in range(CHUNK_LEN):
        lists, out[t] = _mtf_at(lists, chunks[:, t], pos)
    return out.T.reshape(-1)[:n].to(torch.int32)


def mtf_decode(indices, n):
    """Invert MTF on indices[:n]: each chunk's effect on the list is a
    permutation fixed by its own indices, so all chunk permutations are
    built at once, the list before each chunk comes from a composition
    scan, and all chunks then decode at once.  Returns int32[n].

    For a CUDA tensor (contiguous 1-D int32) the stage is three launches
    of ``csrc/mtf_undo.cu``: the chunks' and tiles' permutations, the
    tiles' composition scan, and the decode, which rebuilds each chunk's
    start list itself; for a CPU tensor it runs `mtf_decode_plain`."""
    if indices.device.type == 'cpu':
        return mtf_decode_plain(indices, n)
    _cuda.require_cuda(indices, 'mtf_decode')
    if (indices.dim() != 1 or indices.dtype != torch.int32
            or not indices.is_contiguous()
            or not 0 <= n <= indices.shape[0]):
        raise ValueError('mtf_decode takes a contiguous 1-D int32 tensor '
                         'and 0 <= n <= its length')
    dev = indices.device
    n_chunks = -(-n // CHUNK_LEN)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    n_tiles = -(-n_chunks // TILE_CHUNKS)
    perm = torch.empty((n_chunks, WIDTH), dtype=torch.uint8, device=dev)
    agg = torch.empty((n_tiles, WIDTH), dtype=torch.uint8, device=dev)
    lists = torch.empty_like(agg)
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)
    _cuda.launches['mtf_undo'] += 1
    _cuda.check(lib.cz_mtf_undo_perm(indices.data_ptr(), perm.data_ptr(),
                                     agg.data_ptr(), n, n_chunks, stream),
                'mtf_undo')
    _cuda.launches['mtf_undo'] += 1
    _cuda.check(lib.cz_mtf_undo_prefix(agg.data_ptr(), lists.data_ptr(),
                                       n_tiles, stream), 'mtf_undo')
    _cuda.launches['mtf_undo'] += 1
    _cuda.check(lib.cz_mtf_undo_decode(indices.data_ptr(), perm.data_ptr(),
                                       lists.data_ptr(), out.data_ptr(), n,
                                       n_chunks, stream), 'mtf_undo')
    return out


def _lf_mapping(key):
    """(LF, order): order sorts key stably, LF is its inverse."""
    order = torch.sort(key, stable=True).indices
    lf = torch.empty_like(order)
    lf[order] = torch.arange(key.shape[0], device=key.device)
    return lf, order


def _orbit_ranks(lf, order, t0):
    """rank[v] = steps from v along LF to the predecessor u of t0, for
    every v on t0's orbit (u = order[t0], since LF[order[k]] = k).  List
    ranking by pointer doubling: u becomes a fixed point of rank 0, and
    each round adds the successor's rank and jumps twice as far.  After
    ceil(log2 n) rounds a v off the orbit holds a rank >= n, and t0 holds
    the orbit's length - 1."""
    n = lf.shape[0]
    u = order[t0]
    succ = lf.clone()
    succ[u] = u
    rank = torch.ones(n, dtype=torch.int64, device=lf.device)
    rank[u] = 0
    for _ in range(max(1, (n - 1).bit_length())):
        rank = rank + rank[succ]
        succ = succ[succ]
    return rank


def inverse_bwt_block_masked(U, cap, n, pidx):
    """Invert the cyclic BWT of U[:n] (n <= cap may be a 0-dim tensor)
    with origPtr pidx < n: returns uint8[cap], zero from index n on.

    The JAX package walks the orbit t0, LF(t0), ... n steps and writes
    it reversed.  Here each orbit element v lands at slot rank[v] of a
    first period; a periodic block's orbit is shorter than n (m = its
    length), and slot i of the output then repeats slot
    m - 1 - ((n - 1 - i) mod m) of that period, as the walk does."""
    dev = U.device
    idx = torch.arange(cap, device=dev)
    valid = idx < n
    key = torch.where(valid, U[:cap].to(torch.int64), 300)  # pads last
    lf, order = _lf_mapping(key)
    # 1-d indices: no host sync on the card
    t0 = torch.as_tensor(pidx, device=dev).clamp(0, cap - 1).view(1)
    rank = _orbit_ranks(lf, order, t0)
    period = torch.zeros(cap + 1, dtype=U.dtype, device=dev)
    period.scatter_(0, torch.where(valid & (rank < n), rank, cap), U[:cap])
    m = rank[t0] + 1
    src = m - 1 - torch.remainder(n - 1 - idx, m)
    return torch.where(valid, period[src], 0).to(U.dtype)


def inverse_bwt_block(U, n, pidx):
    """Invert the cyclic BWT of U[:n] with origPtr pidx < n: uint8[n]
    (counterpart of ``jax_kernels.inverse_bwt_block``)."""
    return inverse_bwt_block_masked(U, n, n, pidx)


_F_EQ = (1, 2, 3, 4, 0)   # RLE1 state after a byte equal to the last
_F_NE = (1, 1, 1, 1, 0)   # ... after a different byte


def rle1_decode_dev(block, out_cap, count):
    """Undo bzip2 RLE1 on block[:count]: after 4 equal bytes the next
    byte is a repeat count.  Whether byte i is a count byte is the state
    of a 5-state machine whose step depends only on b[i] == b[i-1]; its
    states come from a composition scan of the per-byte tables.
    Returns (out uint8[out_cap], total); out_cap=None sizes the output to
    the total (one host sync)."""
    dev = block.device
    n = block.shape[0]
    b = block.to(torch.int64)
    valid = torch.arange(n, device=dev) < count
    eq = torch.cat([b.new_zeros(1, dtype=torch.bool), b[1:] == b[:-1]])
    tables = torch.tensor([_F_NE, _F_EQ], dtype=torch.int64, device=dev)
    states = _scan_compose(tables[eq.to(torch.int64)],
                           earlier_first=True)[:, 1]
    is_count = (states == 0) & valid
    prev = torch.cat([b[:1], b[:-1]])
    out_cnt = torch.where(is_count, b, valid.to(torch.int64))
    vals = torch.where(is_count, prev, b)
    if out_cap is None:
        out_cap = int(out_cnt.sum())
    iat, total = _producers(out_cnt, out_cap)
    out = torch.where(torch.arange(out_cap, device=dev) < total, vals[iat],
                      0)
    return out.to(torch.uint8), total
