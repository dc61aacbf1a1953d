"""Tensor build of the bzip2 static-Huffman entropy stage, so that a
block's symbols never leave device memory between RLE2 and the packed
payload (counterpart of ``compressjs_tpu.ops.device_entropy``).

* `alloc_lengths` -- the length-limited allocator on sorted tables: the
  CUDA kernel ``csrc/alloc_lengths.cu`` for a CUDA tensor, the scalar
  loops of ``host.huffman_allocator`` (its plain version) for a CPU
  tensor.
* `code_lengths_batch` -- whole table builds, the (freq<<9 | sym) sort,
  the allocator and the scatter back by symbol in one kernel launch on
  the card; its error flag waits in a device tensor for the caller.
* `canonical_codes_dev` -- the closed-form canonical codes.
* `optimize_groups_dev` -- the greedy split and Lloyd refinement, with
  the host encoder's tie-breaking, on per-50-symbol chunk histograms.
* `payload_pack_words_dev` -- Huffman codes packed into big-endian
  bytes.
* `encode_block_full` -- the whole block encode.

Group tables use G=6 slots (inactive groups cost +inf) of N=260
symbols masked by the alphabet size m.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..tracer import stage_timer, staged
from .block_kernels import encode_block_core
from ..host.huffman_allocator import allocate_huffman_code_lengths

N = 260            # static alphabet buffer (bzip2 max 258 + slack)
MAX_LEN = 20       # longest Huffman code
G = 6              # most coding groups
GROUP_SIZE = 50    # symbols per selector
_INF_COST = 0x3FFFFFFF
_BIG = 0x7FFFFFFF
_KEY_LIMIT = 1 << 22   # frequencies below it fit the (freq << 9 | sym) key


# ---------------------------------------------------------------------------
# length-limited allocator

def alloc_lengths_plain(arrs, ms):
    """Plain version of `alloc_lengths`: the scalar loops, table by
    table, on the host.  Returns (lengths (B, N) int32, flags (B,)
    int32): flags[b] = 1 where table b gave no valid code lengths (m
    outside 0..N, or a length outside 1..MAX_LEN)."""
    rows = arrs.cpu().tolist()
    flags = []
    for row, m in zip(rows, ms.cpu().tolist()):
        if not 0 <= m <= N:
            flags.append(1)
            continue
        head = row[:m]
        allocate_huffman_code_lengths(head, MAX_LEN)
        row[:m] = head
        flags.append(int(m > 0 and not 1 <= min(head) <= max(head)
                         <= MAX_LEN))
    return (torch.tensor(rows, dtype=torch.int32, device=arrs.device),
            torch.tensor(flags, dtype=torch.int32, device=arrs.device))


def _raise_if_flagged(flags, what):
    if flags.numel() and int(flags.max()):
        raise RuntimeError('%s: table(s) %s broke a loop bound of the '
                           'allocator' % (what, torch.nonzero(flags).view(
                               -1).tolist()))


def alloc_lengths(arrs, ms):
    """Code lengths for a batch of sorted tables: arrs (B, N) int32 whose
    first ms[b] slots of row b hold sorted frequencies; those slots
    become code lengths of at most MAX_LEN bits, the rest are kept.  The
    CUDA kernel (``csrc/alloc_lengths.cu`` cz_alloc_lengths) for a CUDA
    tensor, the plain version for a CPU tensor.  Reads the tables' error
    flags back and raises RuntimeError on a flagged table: the encode's
    table builds do not come here but go through `code_lengths_batch`,
    whose flag waits for the caller."""
    if arrs.device.type == 'cpu':
        out, flags = alloc_lengths_plain(arrs, ms)
        _raise_if_flagged(flags, 'alloc_lengths')
        return out
    _cuda.require_cuda(arrs, 'alloc_lengths')
    B = arrs.shape[0]
    if (arrs.shape != (B, N) or ms.shape != (B,)
            or arrs.dtype != torch.int32 or ms.dtype != torch.int32
            or ms.device != arrs.device or not arrs.is_contiguous()
            or not ms.is_contiguous()):
        raise ValueError('alloc_lengths takes (B, %d) and (B,) contiguous '
                         'int32 tensors on one device' % N)
    out = torch.empty_like(arrs)
    flags = torch.empty(B, dtype=torch.int32, device=arrs.device)
    lib = _cuda.lib()
    _cuda.launches['alloc_lengths'] += 1
    _cuda.check(lib.cz_alloc_lengths(arrs.data_ptr(), ms.data_ptr(),
                                     out.data_ptr(), flags.data_ptr(), B,
                                     MAX_LEN,
                                     _cuda.stream_handle(arrs.device)),
                'alloc_lengths')
    stage_timer().add('host_syncs')
    _raise_if_flagged(flags, 'alloc_lengths')
    return out


def _sym_sorted(values, m):
    """Sort (values << 9 | sym) along the last axis, slots >= m last.
    Returns (sorted values with zeros past m, symbol of each slot, valid
    mask).  Both fields fit: values <= 900,001 < 2^22."""
    sym = torch.arange(N, device=values.device)
    valid = sym < m
    merged = torch.where(valid, (values.to(torch.int64) << 9) | sym, _BIG)
    merged = torch.sort(merged, dim=-1).values
    return torch.where(valid, merged >> 9, 0), merged & 0x1FF, valid


def _unsort(values_sorted, sym_of_slot, valid):
    """Scatter per-slot values back to their symbols (zeros past m)."""
    out = torch.zeros(values_sorted.shape[:-1] + (N + 1,), dtype=torch.int32,
                      device=values_sorted.device)
    out.scatter_(-1, torch.where(valid, sym_of_slot, N),
                 torch.where(valid, values_sorted, 0).to(torch.int32))
    return out[..., :N]


def code_lengths_plain(freqs, m):
    """Plain version of the fused table build: `_sym_sorted`, then
    `alloc_lengths_plain`, then `_unsort`.  Returns (lengths by symbol
    (B, N) int32, flags (B,) int32); a table with a frequency the sort
    key cannot hold (outside 0..2^22 - 1) is flagged, as the kernel
    flags it."""
    f = freqs[:, :m].to(torch.int64)
    bad_key = ((f < 0) | (f >= _KEY_LIMIT)).any(1)
    arrs, sym_of_slot, valid = _sym_sorted(
        torch.where(bad_key[:, None], 0, freqs.to(torch.int64)), m)
    ms = torch.full((freqs.shape[0],), m, dtype=torch.int32)
    lens, flags = alloc_lengths_plain(arrs.to(torch.int32), ms)
    return (_unsort(lens, sym_of_slot, valid),
            flags | bad_key.to(torch.int32))


def code_lengths_batch(freqs, m, err):
    """Batched table builds: freqs (B, N) -> (B, N) int32 code lengths by
    symbol (zeros past the alphabet size m).

    A table the allocator cannot build sets `err`, a (1,) int32 tensor on
    freqs' device that the caller owns and reads when it fetches
    something anyway (never cleared here, never read here).  For a CUDA
    tensor the whole build is one launch of the kernel
    ``csrc/alloc_lengths.cu`` cz_code_lengths; for a CPU tensor it is
    the plain version."""
    if freqs.device.type == 'cpu':
        lens, flags = code_lengths_plain(freqs, m)
        if flags.numel():
            err |= flags.max()
        return lens
    _cuda.require_cuda(freqs, 'code_lengths_batch')
    if (freqs.dim() != 2 or freqs.shape[1] != N or not 0 <= m <= N
            or freqs.dtype != torch.int32 or not freqs.is_contiguous()):
        raise ValueError('code_lengths_batch takes (B, %d) contiguous int32 '
                         'frequencies and 0 <= m <= %d' % (N, N))
    if (err.shape != (1,) or err.dtype != torch.int32
            or err.device != freqs.device):
        raise ValueError('code_lengths_batch: err must be a (1,) int32 '
                         'tensor on the frequencies\' device')
    lens = torch.empty_like(freqs)
    lib = _cuda.lib()
    _cuda.launches['code_lengths'] += 1
    _cuda.check(lib.cz_code_lengths(freqs.data_ptr(), m, lens.data_ptr(),
                                    err.data_ptr(), freqs.shape[0], MAX_LEN,
                                    _cuda.stream_handle(freqs.device)),
                'code_lengths')
    return lens


def canonical_codes_dev(lengths, m):
    """Canonical codes of (..., N) code lengths, assigned in (length,
    symbol) order: code_i = (exclusive sum of 2^(MAX_LEN - l_j)) >>
    (MAX_LEN - l_i)."""
    lens_sorted, sym_of_slot, valid = _sym_sorted(lengths, m)
    weights = torch.where(valid, 1 << (MAX_LEN - lens_sorted), 0)
    prefix = torch.cumsum(weights, -1) - weights
    return _unsort(prefix >> (MAX_LEN - lens_sorted), sym_of_slot, valid)


# ---------------------------------------------------------------------------
# group optimisation on chunk histograms

def chunk_hist_dev(syms, count, n_chunks):
    """(n_chunks, N) int32 histogram of each 50-symbol chunk; symbols at
    index >= count are left out."""
    n = syms.shape[0]
    idx = torch.arange(n, device=syms.device)
    flat = (idx // GROUP_SIZE) * N + syms.to(torch.int64)
    flat = torch.where(idx < count, flat, n_chunks * N)
    stage_timer().add('host_syncs', 2)  # bincount reads back min and max
    hist = torch.bincount(flat, minlength=n_chunks * N + 1)
    return hist[:n_chunks * N].view(n_chunks, N).to(torch.int32)


# The two products below run in float64 with integer-valued operands:
# costs are sums of <= 50 lengths <= 20, frequencies sums of <= 900,001
# counts, all far below 2^53, so every product and sum is exact whatever
# the summation order (float64 products never go through TF32).

def _costs_from_hist(hist_f, lens, active):
    """(n_chunks, G) bit cost of each chunk under each table; inactive
    tables cost _INF_COST."""
    c = (hist_f @ lens.to(torch.float64).T).to(torch.int64)
    return torch.where(active[None, :], c, _INF_COST)


def _coded_by(sel, valid_chunk):
    """(n_chunks, G) bool: chunk c is valid and coded by table g."""
    return (sel[:, None] == torch.arange(G, device=sel.device)[None, :]) \
        & valid_chunk[:, None]


def _freqs_by_group(hist_f, coded_by):
    """(G, N) int32 symbol frequencies of the chunks each table codes."""
    return (coded_by.to(torch.float64).T @ hist_f).to(torch.int32)


def _rank_stable(keys):
    """Stable ascending rank of each element (ties by index)."""
    order = torch.sort(keys, stable=True).indices
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(keys.shape[0], device=keys.device)
    return ranks


def _target_groups(count):
    """Number of coding groups for a block of `count` symbols."""
    return 2 + (count >= 200) + (count >= 600) + (count >= 1200) + \
        (count >= 2400)


@staged('ops.optimize_groups_dev')
def optimize_groups_dev(syms, count, n_chunks, freq, m):
    """Coding tables and selectors for one block: returns (length matrix
    (G, N) int32, n_groups, selectors (n_chunks,) int64, code matrix
    (G, N) int32).  Rows >= n_groups are inactive.

    syms: (n_syms,) symbol stream, padded; count: valid symbols (int);
    n_chunks: ceil(n_syms / 50); freq: (>= N,) global frequencies; m:
    alphabet size (= eob + 1)."""
    dev = syms.device
    # set by a table build the allocator could not finish; read with the
    # Lloyd loop's cost, so no table build waits on the host
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    hist_f = chunk_hist_dev(syms, count, n_chunks).to(torch.float64)
    valid_chunk = torch.arange(n_chunks, device=dev) < \
        (count + GROUP_SIZE - 1) // GROUP_SIZE
    garange = torch.arange(G, device=dev)

    fbuf = torch.where(torch.arange(N, device=dev) < m,
                       freq[:N].to(torch.int32), 0)
    row01 = code_lengths_batch(torch.stack([fbuf, torch.ones_like(fbuf)]),
                               m, err)
    lens = torch.stack([row01[0]] + [row01[1]] * (G - 1))

    # greedy split of the busiest group until the target count
    g = 2
    target = _target_groups(count)
    while g < target:
        active = garange < g
        costs = _costs_from_hist(hist_f, lens, active)
        sel = torch.argmin(costs, 1)
        counts = torch.where(active, _coded_by(sel, valid_chunk).sum(0), -1)
        which = torch.argmax(counts)
        member = (sel == which) & valid_chunk
        wcosts = costs.gather(1, which.expand(n_chunks, 1))[:, 0]
        rank = _rank_stable(torch.where(member, wcosts, _BIG))
        sel = torch.where(member & (rank >= member.sum() >> 1), g, sel)
        new_lens = code_lengths_batch(
            _freqs_by_group(hist_f, _coded_by(sel, valid_chunk)), m, err)
        lens = torch.where((garange <= g)[:, None], new_lens, lens)
        g += 1

    active = garange < g
    sel = torch.argmin(_costs_from_hist(hist_f, lens, active), 1)

    # Lloyd refinement with the host's early break: iterate while the
    # total cost strictly improves, at most 4 rounds; empty groups keep
    # their previous table
    prev_cost = _BIG
    for _ in range(4):
        coded_by = _coded_by(sel, valid_chunk)
        new_lens = code_lengths_batch(_freqs_by_group(hist_f, coded_by), m,
                                      err)
        keep = active & (coded_by.sum(0) > 0)
        lens = torch.where(keep[:, None], new_lens, lens)
        costs = _costs_from_hist(hist_f, lens, active)
        sel = torch.argmin(costs, 1)
        chosen = costs.gather(1, sel[:, None])[:, 0]
        stage_timer().add('host_syncs')
        cost, bad = torch.stack([torch.where(valid_chunk, chosen, 0).sum(),
                                 err[0].to(torch.int64)]).tolist()
        if bad:
            raise RuntimeError('optimize_groups_dev: a coding table broke '
                               'a loop bound of the allocator')
        if cost >= prev_cost:
            break
        prev_cost = cost

    return lens, g, sel, canonical_codes_dev(lens, m)


# ---------------------------------------------------------------------------
# payload packing

@staged('ops.payload_pack_words_dev')
def payload_pack_words_dev(syms, count, selectors, lens, codes):
    """Huffman payload as packed big-endian bytes: (uint8[ceil(bits/8)],
    total_bits).

    Each code (<= 20 bits) lands in at most two consecutive 32-bit words.
    The left-aligned 64-bit value code << (64 - bit_offset - len) is
    split into hi and lo words, computed in int64 and masked to 32 bits.
    Every output bit belongs to exactly one symbol, so adding the words
    into place (`index_add_`) equals OR-ing them, and no sum carries.  The
    buffer is sized from the real bit count."""
    n = syms.shape[0]
    dev = syms.device
    idx = torch.arange(n, device=dev)
    valid = idx < count
    sel = selectors[idx // GROUP_SIZE]
    packed_tbl = (lens.to(torch.int64) << 20) | codes.to(torch.int64)
    pv = packed_tbl[sel, syms.to(torch.int64)]
    ln = torch.where(valid, pv >> 20, 0)
    cd = torch.where(valid, pv & 0xFFFFF, 0)
    offsets = torch.cumsum(ln, 0) - ln
    stage_timer().add('host_syncs')
    total = int(ln.sum())
    wi = offsets >> 5
    bo = offsets & 31
    mask32 = 0xFFFFFFFF
    sh_hi = 32 - bo - ln
    hi = torch.where(sh_hi >= 0, cd << sh_hi.clamp(min=0),
                     cd >> (-sh_hi).clamp(min=0)) & mask32
    lo = torch.where(bo + ln > 32, cd << (64 - bo - ln).clamp(0, 31),
                     0) & mask32
    nwords = total // 32 + 2
    words = torch.zeros(nwords, dtype=torch.int64, device=dev)
    words.index_add_(0, wi, hi)
    words.index_add_(0, wi + 1, lo)
    b = torch.stack([(words >> 24) & 0xFF, (words >> 16) & 0xFF,
                     (words >> 8) & 0xFF, words & 0xFF], 1)
    return b.to(torch.uint8).view(-1)[:(total + 7) // 8], total


def encode_block_full(block, n, remap, eob):
    """All-device bzip2 block encode: rotation sort -> BWT -> MTF -> RLE2
    -> group optimisation -> canonical tables -> packed payload.

    Returns (pidx, payload bytes, total_bits, lens (G, N), n_groups,
    selectors, count, freq)."""
    pidx, syms, count, freq = encode_block_core(block, n, remap, eob)
    stage_timer().add('host_syncs')
    count = int(count)
    n_chunks = -(-(n + 1) // GROUP_SIZE)
    lens, g, sel, codes = optimize_groups_dev(syms, count, n_chunks, freq,
                                              eob + 1)
    payload, total_bits = payload_pack_words_dev(syms, count, sel, lens,
                                                 codes)
    return pidx, payload, total_bits, lens, g, sel, count, freq
