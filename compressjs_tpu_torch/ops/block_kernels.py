"""Tensor build of the bzip2 block transforms: rotation sort, BWT,
move-to-front and RLE2 (counterpart of ``compressjs_tpu.ops.jax_kernels``).

* `cyclic_suffix_sort` and `eof_suffix_sort` -- quad prefix doubling:
  each round sorts (rank, rank@k, rank@2k, rank@3k) and compresses ranks
  to group-start form, until all groups are singletons; the cyclic sort
  wraps around the block, the EOF-terminated one (the BWTC codec's,
  `bwt_eof_block`) reads rank -1 past its end.  ``torch.sort`` takes one key,
  so every multi-key sort is built from stable sorts, least significant
  key first, over keys packed into int64.
* `_seg_start` and `_max_scan` -- the inclusive max-scans of the sorts'
  group starts (every seed and round) and of `rle2_encode` (two a
  block).  For a CUDA tensor each is one call of ``csrc/seg_scan.cu``
  (counted in ``_cuda.launches['seg_scan']``; it replaces no Pallas
  kernel: the JAX package scans with ``lax.associative_scan``); for a
  CPU tensor `torch.cummax`, the plain version.
* `mtf_encode` -- chunked move-to-front: per-chunk start lists from a
  max-scan over last occurrences, then the chunks' scans.  For a CUDA
  tensor all of it is three launches of ``csrc/mtf_scan.cu`` (replacing
  the JAX package's Pallas ``_mtf_kernel`` and its start tables); for a
  CPU tensor the plain version `mtf_encode_plain` runs, one vector step
  per chunk position over every chunk's list at once.
* `rle2_encode` -- RUNA/RUNB zero-run digits by segment math.
* `group_costs_dev`, `chunk_freqs_dev` and `payload_pack_dev` -- the JAX
  package's Huffman group scans over a symbol stream that stays on the
  device (chunk costs under each table, per-group frequencies from the
  selectors, the packed payload), as plain tensor code: the JAX package
  computes them outside any Pallas kernel.

All functions take tensors on any device and return tensors on it.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..tracer import stage_timer, staged

CHUNK_LEN = 512          # MTF chunk length (fixed in csrc/mtf_scan.cu)
TILE_CHUNKS = 16         # chunks per tile of the start-list scan (the same)
MAX_BLOCK = 1 << 20      # ranks and indices must pack into 20 bits
GROUP_SIZE = 50          # symbols per Huffman selector
GROUP_ROW = 260          # width of a group's row of the table matrices
MAX_CODE_BITS = 20       # longest bzip2 Huffman code
SCAN_TILE = 4096         # elements a tile of csrc/seg_scan.cu (fixed there)


def _scan_launch(x, dtype, what):
    """One call of csrc/seg_scan.cu's entry for `x` (a contiguous 1-D
    CUDA tensor of `dtype`): (n,) int64 out."""
    _cuda.require_cuda(x, what)
    if x.dim() != 1 or x.dtype != dtype or not x.is_contiguous():
        raise ValueError('%s takes a contiguous 1-D %s tensor' % (what, dtype))
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=x.device)
    # each tile's maximum, written by the first launch
    agg = torch.empty(-(-n // SCAN_TILE), dtype=torch.int64, device=x.device)
    lib = _cuda.lib()
    entry = lib.cz_group_start if dtype == torch.bool else lib.cz_max_scan
    _cuda.launches['seg_scan'] += 1
    _cuda.check(entry(x.data_ptr(), n, out.data_ptr(), agg.data_ptr(),
                      _cuda.stream_handle(x.device)), 'seg_scan')
    return out


def _seg_start(diff):
    """Index of the current group's first element, per sorted slot:
    out[i] = max{j <= i : diff[j]}, 0 where there is none (int64).

    For a CUDA tensor (contiguous 1-D bool) it is one call of
    ``csrc/seg_scan.cu``'s `cz_group_start`, two launches (one for at
    most SCAN_TILE flags); for a CPU tensor `torch.cummax`; for a tensor
    anywhere else it raises."""
    if diff.device.type == 'cpu':
        pos = torch.arange(diff.shape[0])
        return torch.cummax(torch.where(diff, pos, 0), 0).values
    return _scan_launch(diff, torch.bool, '_seg_start')


def _max_scan(x):
    """Inclusive running maximum of a 1-D int64 tensor (any values; the
    callers' are positions in [0, 2^40)).

    For a CUDA tensor (contiguous) it is one call of ``csrc/seg_scan.cu``'s
    `cz_max_scan`, two launches (one for at most SCAN_TILE values); for a
    CPU tensor `torch.cummax`; for a tensor anywhere else it raises."""
    if x.device.type == 'cpu':
        return torch.cummax(x, 0).values
    return _scan_launch(x, torch.int64, '_max_scan')


def _tied_count(diff):
    """Number of elements in groups of size > 1, from sorted diff flags."""
    nxt = torch.cat([diff[1:], diff.new_ones(1)])
    stage_timer().add('host_syncs')
    return diff.shape[0] - int((diff & nxt).sum())


def _diff_flags(keys_sorted):
    """True where a sorted slot starts a new group of equal keys."""
    n = keys_sorted[0].shape[0]
    diff = torch.zeros(n, dtype=torch.bool, device=keys_sorted[0].device)
    stage_timer().add('host_syncs')     # a host scalar written to the card
    diff[0] = True
    for k in keys_sorted:
        diff[1:] |= k[1:] != k[:-1]
    return diff


def _lex_order(keys):
    """Permutation sorting by `keys` lexicographically (first key most
    significant); equal rows keep index order.  Stable sorts, least
    significant key first."""
    order = None
    for k in reversed(keys):
        cur = k if order is None else k[order]
        perm = torch.sort(cur, stable=True).indices
        order = perm if order is None else order[perm]
    return order


def _ranks_from_order(keys, order):
    """(group-start rank per position, tied count) of a sorted order."""
    diff = _diff_flags([k[order] for k in keys])
    start = _seg_start(diff)
    rank = torch.empty_like(start)
    rank[order] = start
    return rank, _tied_count(diff)


def _seed_ranks_start4(w0, w4, w8, w12):
    """Seed (rank, order, tied) from four uint32 context words held in
    int64.  Two words pack into one int64 key; the first word is offset
    by -2^31 so the signed order equals the unsigned one."""
    hi = (w0 - (1 << 31)) * (1 << 32) + w4
    lo = (w8 - (1 << 31)) * (1 << 32) + w12
    order = _lex_order([hi, lo])
    rank, tied = _ranks_from_order([hi, lo], order)
    return rank, order, tied


def _quad_double(rank, order, tied, n, k, shift):
    """Quad doubling rounds until all ranks are distinct (or k >= n for a
    periodic block).  shift(rank, d) is the rank d positions on, as a key
    in [0, 2^21) that orders as the rank does (the EOF-terminated sort's
    is rank + 1, and 0 past the end).  Returns (rank, order, tied)."""
    while tied > 0 and k < n:
        stage_timer().add('sort_rounds')
        r2 = shift(rank, k)
        r3 = shift(rank, 2 * k)
        r4 = shift(rank, 3 * k)
        # ranks are < 2^20: three keys fill 63 bits of one int64 key
        packed = (rank << 42) | (r2 << 21) | r3
        order = _lex_order([packed, r4])
        rank, tied = _ranks_from_order([packed, r4], order)
        k *= 4
    return rank, order, tied


def _check_length(n):
    if not 0 < n < MAX_BLOCK:
        raise ValueError('block length %d outside 1..%d' % (n, MAX_BLOCK - 1))


def cyclic_suffix_sort(block, n):
    """Sorted rotation start indices of block[:n] (uint8), ties between
    equal rotations broken by descending index."""
    _check_length(n)
    bu = block[:n].to(torch.int64)

    def word(d):
        return ((torch.roll(bu, -d) << 24) | (torch.roll(bu, -(d + 1)) << 16)
                | (torch.roll(bu, -(d + 2)) << 8) | torch.roll(bu, -(d + 3)))

    rank, order, tied = _seed_ranks_start4(word(0), word(4), word(8),
                                           word(12))
    rank, order, tied = _quad_double(rank, order, tied, n, 16,
                                     lambda r, d: torch.roll(r, -d))
    if tied > 0:
        # periodic block: order by (rank ascending, index descending)
        idx = torch.arange(n, device=block.device)
        order = torch.sort(rank * n + (n - 1 - idx)).indices
    return order


def eof_suffix_sort(block, n):
    """Suffix array of block[:n] (uint8) terminated by a virtual sentinel
    smaller than every byte: a suffix that is a prefix of another sorts
    first (counterpart of ``jax_kernels.eof_suffix_sort``).

    The ranks are seeded from twelve bytes of context, four keys of three
    9-bit fields (byte + 1, 0 for the sentinel past the end).  The
    sentinel field is needed: from bytes padded with 0 an all-zero block
    would tie a short suffix with a longer one, and the rounds, which
    look only at k = 12 * 4^t, could skip the k that separates them."""
    _check_length(n)
    idx = torch.arange(n, device=block.device)
    b1 = block[:n].to(torch.int64) + 1

    def shift(x, d, pad):
        return torch.where(idx < n - d, torch.roll(x, -d), pad)

    def key(d):
        return ((shift(b1, d, 0) << 18) | (shift(b1, d + 1, 0) << 9)
                | shift(b1, d + 2, 0))

    rank, order, tied = _seed_ranks_start4(key(0), key(3), key(6), key(9))
    rank, order, tied = _quad_double(rank, order, tied, n, 12,
                                     lambda r, d: shift(r + 1, d, 0))
    if tied > 0:
        # suffixes of distinct lengths always resolve; kept as the JAX
        # function keeps it (a stable argsort of the ranks)
        order = torch.sort(rank, stable=True).indices
    return order


@staged('ops.bwt_eof_block')
def bwt_eof_block(block, n):
    """EOF-terminated BWT of block[:n] (the BWTC codec's transform):
    (U uint8[n], pidx + 1) with U[0] = block[n-1], then the byte before
    each sorted suffix, the slot of suffix 0 (at pidx) skipped.  pidx + 1
    is a 0-dim tensor (no host sync)."""
    sa = eof_suffix_sort(block, n)
    pidx = torch.argmax((sa == 0).to(torch.int32))
    b = block[:n]
    prev = b[torch.where(sa == 0, n - 1, sa - 1)]
    idx = torch.arange(n, device=block.device)
    U = torch.where((idx > 0) & (idx <= pidx),
                    prev[(idx - 1).clamp(min=0)], b[n - 1])
    U = torch.where(idx > pidx, prev, U)
    return U, pidx + 1


@staged('ops.bwt_block')
def bwt_block(block, n):
    """Cyclic BWT of one block: (U uint8, pidx)."""
    order = cyclic_suffix_sort(block, n)
    prev = torch.where(order == 0, n - 1, order - 1)
    pidx = torch.argmax((order == 0).to(torch.int32))
    return block[:n][prev], pidx


def bwt_block_batch(blocks, n):
    """Cyclic BWT of each row of a (B, n) uint8 batch in one sort per
    round: (U (B, n) uint8, pidx (B,)), equal to `bwt_block` row by row.

    The rows are sorted as one array whose most significant key is the
    row, so each doubling round is the same few stable sorts as for one
    block, and rounds run until the slowest row resolves (a resolved
    row's distinct ranks keep their order in later rounds)."""
    B = blocks.shape[0]
    if not 0 < n < MAX_BLOCK or blocks.shape[1] != n:
        raise ValueError('blocks of length %d outside 1..%d'
                         % (n, MAX_BLOCK - 1))
    dev = blocks.device
    bu = blocks.to(torch.int64)
    row = torch.arange(B, device=dev).repeat_interleave(n)

    def roll(x, d):                  # x[b, (i + d) % n], flattened
        return torch.roll(x.view(B, n), -d, 1).reshape(-1)

    def word(d):
        return ((roll(bu, d) << 24) | (roll(bu, d + 1) << 16)
                | (roll(bu, d + 2) << 8) | roll(bu, d + 3))

    # ranks are group-start positions within the row (< 2^20); the row
    # joins the most significant key of each sort
    hi = (word(0) - (1 << 31)) * (1 << 32) + word(4)
    lo = (word(8) - (1 << 31)) * (1 << 32) + word(12)
    keys = [row, hi, lo]
    order = _lex_order(keys)
    base = row * n
    rank, tied = _ranks_from_order(keys, order)
    rank -= base
    k = 16
    while tied > 0 and k < n:
        stage_timer().add('sort_rounds')
        packed = (row << 40) | (rank << 20) | roll(rank, k)
        low = (roll(rank, 2 * k) << 20) | roll(rank, 3 * k)
        order = _lex_order([packed, low])
        rank, tied = _ranks_from_order([packed, low], order)
        rank -= base
        k *= 4
    if tied > 0:
        # periodic rows: order by (row, rank, index descending)
        idx = torch.arange(n, device=dev).repeat(B)
        order = torch.sort((base + rank) * n + (n - 1 - idx)).indices
    order = order.view(B, n) - base.view(B, n)
    prev = torch.where(order == 0, n - 1, order - 1)
    pidx = torch.argmax((order == 0).to(torch.int32), 1)
    return torch.gather(blocks, 1, prev), pidx


# ---------------------------------------------------------------------------
# move-to-front

def _last_occurrences(chunks):
    """(n_chunks, 256) int64: the global position of each symbol's last
    occurrence in each chunk, -1 where it does not occur."""
    n_chunks, chunk_len = chunks.shape
    dev = chunks.device
    gpos = torch.arange(n_chunks * chunk_len, device=dev).view(
        n_chunks, chunk_len)
    last_occ = torch.full((n_chunks, 256), -1, dtype=torch.int64,
                          device=dev)
    last_occ.scatter_reduce_(1, chunks.to(torch.int64), gpos, 'amax')
    return last_occ


def _last_before(last_occ):
    """Exclusive max-scan of `_last_occurrences` over chunks: each
    symbol's last position before each chunk, with never-seen symbols
    modelled as virtual occurrences at -(s+1) (so the first chunk's row is
    the identity order)."""
    width = last_occ.shape[1]
    virt = -1 - torch.arange(width, device=last_occ.device)
    shifted = torch.cat([(virt - width)[None, :], last_occ[:-1]], 0)
    return torch.maximum(torch.cummax(shifted, 0).values, virt[None, :])


def _chunk_start_lists(chunks):
    """(n_chunks, 256) uint8: the MTF list (position -> symbol) at each
    chunk's start.

    The list before chunk t is all symbols ordered by the position of
    their most recent occurrence in chunks[0:t] (most recent first), with
    never-seen symbols in identity order.  So the lists fall out of an
    exclusive max-scan of per-chunk last-occurrence vectors plus one
    rank-within-row sort (never-seen symbols tie at -1 after the first
    chunk; the stable sort keeps them in symbol order)."""
    before = _last_before(_last_occurrences(chunks))
    return torch.sort(-before, dim=1, stable=True).indices.to(torch.uint8)


def _pad_chunks(data, n):
    """data[:n] as (n_chunks, CHUNK_LEN) int64, padded with symbol 0."""
    n_chunks = -(-n // CHUNK_LEN)
    d = torch.zeros(n_chunks * CHUNK_LEN, dtype=torch.int64,
                    device=data.device)
    d[:n] = data[:n]
    return d.view(n_chunks, CHUNK_LEN)


def mtf_scan_plain(data, lists):
    """MTF indices (int32) of data[:n], n = data.shape[0], chunk c starting
    from list lists[c] (position -> symbol): one vector step per chunk
    position, over all chunks at once."""
    n = data.shape[0]
    chunks = _pad_chunks(data, n)
    rows = torch.arange(chunks.shape[0], device=data.device)
    lists = lists.to(torch.int64)
    pos = torch.empty_like(lists)
    pos.scatter_(1, lists, torch.arange(lists.shape[1], device=data.device)
                 .expand_as(lists).contiguous())
    out = torch.empty_like(chunks, dtype=torch.int32)
    for t in range(CHUNK_LEN):
        s = chunks[:, t]
        j = pos[rows, s]
        pos += (pos < j[:, None]).to(torch.int64)
        pos[rows, s] = 0
        out[:, t] = j.to(torch.int32)
    return out.view(-1)[:n]


def mtf_encode_plain(data, n):
    """Plain version of `mtf_encode`: the start lists by `torch` sorts
    and scans, then `mtf_scan_plain`."""
    d = data[:n]
    return mtf_scan_plain(d, _chunk_start_lists(_pad_chunks(d, n)))


@staged('ops.mtf_encode')
def mtf_encode(data, n):
    """MTF indices (int32) of data[:n] (dense symbols < 256) with the
    identity initial list, in chunks of CHUNK_LEN symbols that each start
    from the list the symbols before them leave.

    For a CUDA tensor (contiguous 1-D int32) the stage is three launches
    of ``csrc/mtf_scan.cu``: each tile's last occurrences, their
    exclusive max-scan over tiles, and the encode, which builds each
    chunk's start list itself; for a CPU tensor it runs
    `mtf_encode_plain`; for a tensor anywhere else it raises."""
    if data.device.type == 'cpu':
        return mtf_encode_plain(data, n)
    _cuda.require_cuda(data, 'mtf_encode')
    if (data.dim() != 1 or data.dtype != torch.int32
            or not data.is_contiguous() or not 0 <= n <= data.shape[0]):
        raise ValueError('mtf_encode takes a contiguous 1-D int32 tensor '
                         'and 0 <= n <= its length')
    dev = data.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    n_chunks = -(-n // CHUNK_LEN)
    n_tiles = -(-n_chunks // TILE_CHUNKS)
    agg = torch.empty((n_tiles, 256), dtype=torch.int32, device=dev)
    pre = torch.empty_like(agg)
    lib = _cuda.lib()
    stream = _cuda.stream_handle(dev)
    _cuda.launches['mtf_scan'] += 1
    _cuda.check(lib.cz_mtf_encode_tiles(data.data_ptr(), agg.data_ptr(), n,
                                        n_chunks, stream), 'mtf_scan')
    _cuda.launches['mtf_scan'] += 1
    _cuda.check(lib.cz_mtf_encode_prefix(agg.data_ptr(), pre.data_ptr(),
                                         n_tiles, stream), 'mtf_scan')
    _cuda.launches['mtf_scan'] += 1
    _cuda.check(lib.cz_mtf_encode(data.data_ptr(), pre.data_ptr(),
                                  out.data_ptr(), n, n_chunks, stream),
                'mtf_scan')
    return out


# ---------------------------------------------------------------------------
# RLE2 (RUNA/RUNB) symbol stream

def _bit_length(x):
    """Bit length of each non-negative int64 below 2^32."""
    return sum(((x >> b) > 0).to(torch.int64) for b in range(32))


def rle2_encode(mtf_seq, n, eob):
    """bzip2 symbol stream from MTF indices: zero runs become bijective
    base-2 RUNA/RUNB digits (digit i of run length L = bit i of L+1,
    digit count = bit_length(L+1) - 1), value j becomes symbol j+1, then
    EOB.  Returns (syms[n+1] int16 padded with eob, count, freq[260])."""
    dev = mtf_seq.device
    seq = mtf_seq[:n].to(torch.int64)
    idx = torch.arange(n, device=dev)
    is_zero = seq == 0
    # first index of the current zero run = 1 + last nonzero position
    run_start = _max_scan(torch.where(is_zero, 0, idx + 1))
    nxt_nonzero = torch.cat([seq[1:] != 0, is_zero.new_ones(1)])
    run_end = is_zero & nxt_nonzero
    run_len = torch.where(run_end, idx - run_start + 1, 0)
    k_digits = torch.where(run_end, _bit_length(run_len + 1) - 1, 0)

    out_count = torch.where(is_zero, k_digits, 1)
    offsets = torch.cumsum(out_count, 0) - out_count
    total = out_count.sum()

    # every producer (literal or run end) claims its first output slot
    # with a scatter-max; a running max then names each slot's producer
    out_idx = torch.arange(n + 1, device=dev)
    mark = torch.zeros(n + 2, dtype=torch.int64, device=dev)
    mark.scatter_reduce_(0, torch.where(out_count > 0, offsets, n + 1), idx,
                         'amax')
    iat = _max_scan(mark[:n + 1])
    digit = (out_idx - offsets[iat]).clamp(0, 31)
    s = seq[iat]
    sym = torch.where(s != 0, s + 1, ((run_len[iat] + 1) >> digit) & 1)
    syms = torch.where(out_idx < total, sym, eob)
    count = total + 1
    stage_timer().add('host_syncs', 2)  # bincount reads back min and max
    freq = torch.bincount(syms, minlength=260)[:260].to(torch.int32)
    freq[eob] -= (n + 1 - count).to(torch.int32)
    return syms.to(torch.int16), count, freq


def encode_block_core(block, n, remap, eob):
    """Rotation sort -> BWT -> dense-alphabet remap -> MTF -> RLE2 for
    one block.  Returns (pidx, syms, count, freq).  MTF runs through the
    CUDA kernel for a block on the card."""
    U, pidx = bwt_block(block, n)
    dense = remap[U.to(torch.int64)].to(torch.int32)
    mtf_seq = mtf_encode(dense, n)
    syms, count, freq = rle2_encode(mtf_seq, n, eob)
    return pidx, syms, count, freq


def group_costs_dev(syms, count, length_matrix):
    """(n_chunks, n_groups) int32 bit cost of coding each 50-symbol chunk
    of `syms` with each row of `length_matrix` (n_groups, 260); symbols
    at or past `count` cost 0."""
    syms = syms.to(torch.int64)
    n = syms.shape[0]
    g = length_matrix.shape[0]
    valid = torch.arange(n, device=syms.device) < count
    per_sym = torch.where(valid[None, :], length_matrix[:, syms],
                          torch.zeros((), dtype=length_matrix.dtype,
                                      device=syms.device))
    n_chunks = -(-n // GROUP_SIZE)
    per_sym = torch.nn.functional.pad(per_sym, (0, n_chunks * GROUP_SIZE - n))
    return per_sym.reshape(g, n_chunks, GROUP_SIZE).sum(dim=2).T \
        .to(torch.int32)


def chunk_freqs_dev(syms, count, n_groups, selectors, alphabet_size=None):
    """(n_groups, 260) int32 counts of the symbols before `count` in the
    group each chunk's selector names.  `alphabet_size` is not read (the
    rows are 260 wide), as in the JAX function."""
    syms = syms.to(torch.int64)
    n = syms.shape[0]
    idx = torch.arange(n, device=syms.device)
    sel = selectors.to(torch.int64)[idx // GROUP_SIZE]
    dump = n_groups * GROUP_ROW
    flat = torch.where(idx < count, sel * GROUP_ROW + syms,
                       torch.full((), dump, device=syms.device))
    flat = torch.where(flat > dump, dump, flat)   # past the rows: dropped
    counts = torch.bincount(flat, minlength=dump + 1)
    return counts[:dump].reshape(n_groups, GROUP_ROW).to(torch.int32)


def payload_pack_dev(syms, count, selectors, length_matrix, code_matrix):
    """The Huffman payload of the symbols before `count`, each coded with
    the (length, code) its chunk's selector picks from the (groups, 260)
    tables, MSB first: (uint8 bytes of ((n * 20 + 7) // 8) * 8 bits, zero
    past the payload; total bits as an int32 tensor)."""
    syms = syms.to(torch.int64)
    n = syms.shape[0]
    dev = syms.device
    idx = torch.arange(n, device=dev)
    sel = selectors.to(torch.int64)[idx // GROUP_SIZE]
    lens = torch.where(idx < count, length_matrix[sel, syms].to(torch.int64),
                       torch.zeros((), dtype=torch.int64, device=dev))
    codes = code_matrix[sel, syms].to(torch.int64)
    offsets = torch.cumsum(lens, 0) - lens
    total = lens.sum().to(torch.int32)
    max_bits = ((n * MAX_CODE_BITS + 7) // 8) * 8
    t = torch.arange(MAX_CODE_BITS, device=dev)
    shifts = lens[:, None] - 1 - t[None, :]
    bits = ((codes[:, None] >> shifts.clamp(min=0)) & 1).to(torch.uint8)
    positions = torch.where(shifts >= 0, offsets[:, None] + t[None, :],
                            torch.full((), max_bits, device=dev))
    out = torch.zeros(max_bits + 1, dtype=torch.uint8, device=dev)
    out[positions.reshape(-1)] = bits.reshape(-1)   # the last slot: a dump
    weights = 1 << (7 - torch.arange(8, device=dev))
    packed = (out[:max_bits].reshape(-1, 8).to(torch.int64)
              * weights[None, :]).sum(dim=1).to(torch.uint8)
    return packed, total
