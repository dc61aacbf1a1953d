"""bzip2's static-Huffman block stages on the host (counterpart of
``compressjs_tpu.ops.huffman_stages``): length-limited code lengths
from frequencies, canonical codes, the group-count thresholds, the
greedy split-the-busiest-group refinement and its Lloyd rounds,
per-50-symbol selectors, the packed payload, and the block-header
fields derived from the tables (delta-coded lengths, MTF'd selectors).

The scans run in the native runtime every time (``native``).  Each has
a plain numpy twin (``*_plain``) that the tests and the smoke hold it
against; `optimize_groups_plain` runs the whole refinement on them.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .huffman_allocator import allocate_huffman_code_lengths

MAX_HUFCODE_BITS = native.MAX_HUFCODE_BITS
GROUP_SIZE = native.GROUP_SIZE
MIN_GROUPS = 2
MAX_GROUPS = 6


def code_lengths_from_freqs(freq, alphabet_size):
    """Length-limited canonical Huffman code lengths of
    freq[:alphabet_size]: sort (freq << 9 | sym), allocate in place,
    invert the sort."""
    return native.huff_code_lengths(
        np.asarray(freq, dtype=np.int64)[:alphabet_size])


def code_lengths_plain(freq, alphabet_size):
    """Plain twin of `code_lengths_from_freqs`."""
    freq = np.asarray(freq, dtype=np.int64)[:alphabet_size]
    merged_sorted = np.sort((freq << 9) | np.arange(alphabet_size,
                                                    dtype=np.int64))
    arr = (merged_sorted >> 9).tolist()
    allocate_huffman_code_lengths(arr, MAX_HUFCODE_BITS)
    lengths = np.zeros(alphabet_size, dtype=np.uint8)
    lengths[merged_sorted & 0x1FF] = arr
    return lengths


def canonical_codes(code_lengths):
    """Canonical codes, assigned in (length, symbol) order."""
    alphabet_size = len(code_lengths)
    merged = ((code_lengths.astype(np.int64) << 9)
              | np.arange(alphabet_size, dtype=np.int64))
    order = np.argsort(merged, kind='stable')
    lens_sorted = code_lengths[order].astype(np.int64)
    codes = np.zeros(alphabet_size, dtype=np.uint32)
    code = 0
    prev_len = 0
    for i in range(alphabet_size):
        cur = int(lens_sorted[i])
        code <<= (cur - prev_len)
        codes[order[i]] = code
        code += 1
        prev_len = cur
    return codes


def target_group_count(mtf_len):
    """Number of coding tables for a symbol stream of mtf_len symbols."""
    if mtf_len >= 2400:
        return 6
    if mtf_len >= 1200:
        return 5
    if mtf_len >= 600:
        return 4
    if mtf_len >= 200:
        return 3
    return 2


def group_costs(length_matrix, syms):
    """(n_chunks, n_groups) bit cost of coding each 50-symbol chunk with
    each group's table.  length_matrix: (n_groups, alphabet)."""
    return native.group_costs(syms, length_matrix)


def group_costs_plain(length_matrix, syms):
    """Plain twin of `group_costs`."""
    n = syms.shape[0]
    n_groups = length_matrix.shape[0]
    per_sym = length_matrix[:, syms]             # (n_groups, n)
    n_chunks = (n + GROUP_SIZE - 1) // GROUP_SIZE
    pad = n_chunks * GROUP_SIZE - n
    if pad:
        per_sym = np.pad(per_sym, ((0, 0), (0, pad)))
    chunked = per_sym.reshape(n_groups, n_chunks, GROUP_SIZE).sum(axis=2)
    return chunked.T.astype(np.int64)


def assign_selectors(length_matrix, syms):
    """The cheapest table of each 50-symbol chunk (uint8); the first
    minimum wins, like the reference's strict `<` scan."""
    return np.argmin(group_costs(length_matrix, syms),
                     axis=1).astype(np.uint8)


def chunk_freqs(syms, selectors, n_groups, alphabet_size):
    """Per-group symbol frequencies given chunk selectors."""
    return native.chunk_freqs(syms, selectors, n_groups, alphabet_size)


def chunk_freqs_plain(syms, selectors, n_groups, alphabet_size):
    """Plain twin of `chunk_freqs`."""
    n = syms.shape[0]
    chunk_of_sym = np.repeat(np.arange(len(selectors)), GROUP_SIZE)[:n]
    sel_of_sym = selectors[chunk_of_sym].astype(np.int64)
    flat = sel_of_sym * alphabet_size + syms.astype(np.int64)
    counts = np.bincount(flat, minlength=n_groups * alphabet_size)
    return counts.reshape(n_groups, alphabet_size)


def _v8_sort(a):
    """In-place emulation of v8 3.11 `Array.prototype.sort` (the engine
    that produced the reference's published sizes): insertion sort for
    segments <= 10 elements, otherwise median-of-three quicksort with v8
    array.js's partition mechanics.  The sort is unstable, and which
    equal-cost chunks land in the top half of the median split is what
    this reproduces.  `a` is a list of (cost, chunk_index) pairs
    compared by cost alone."""
    def insertion(frm, to):
        for i in range(frm + 1, to):
            element = a[i]
            j = i - 1
            while j >= frm:
                tmp = a[j]
                if tmp[0] - element[0] > 0:
                    a[j + 1] = tmp
                    j -= 1
                else:
                    break
            a[j + 1] = element

    stack = [(0, len(a))]
    while stack:
        frm, to = stack.pop()
        if to - frm <= 10:
            insertion(frm, to)
            continue
        middle = frm + ((to - frm) >> 1)
        v0, v1, v2 = a[frm], a[to - 1], a[middle]
        if v0[0] - v1[0] > 0:
            v0, v1 = v1, v0                  # v0 <= v1
        if v0[0] - v2[0] >= 0:
            v0, v1, v2 = v2, v0, v1          # v2 <= v0 <= v1: rotate
        elif v1[0] - v2[0] > 0:
            v1, v2 = v2, v1                  # v0 < v2 < v1
        a[frm] = v0          # v0/v2 already in final position
        a[to - 1] = v2
        pivot = v1
        low_end = frm + 1    # upper bound of elements < pivot
        high_start = to - 1  # lower bound of elements > pivot
        a[middle] = a[low_end]
        a[low_end] = pivot
        i = low_end + 1      # [low_end, i) equal pivot; [i, high_start) unseen
        broke = False
        while i < high_start:
            element = a[i]
            order = element[0] - pivot[0]
            if order < 0:
                a[i] = a[low_end]
                a[low_end] = element
                low_end += 1
            elif order > 0:
                while True:
                    high_start -= 1
                    if high_start == i:
                        broke = True
                        break
                    top = a[high_start]
                    order = top[0] - pivot[0]
                    if not order > 0:
                        break
                if broke:
                    break
                a[i] = a[high_start]
                a[high_start] = element
                if order < 0:
                    element = a[i]
                    a[i] = a[low_end]
                    a[low_end] = element
                    low_end += 1
            i += 1
        stack.append((frm, low_end))
        stack.append((high_start, to))


def optimize_groups(syms, alphabet_size, initial_freq, ref_ties):
    """Build up to 6 Huffman tables with the reference's greedy
    refinement: start from a global-frequency table plus a flat table;
    repeatedly split the most-used group at the median chunk cost and
    rebuild all tables from reassigned frequencies.  Returns
    (length_matrix, selectors).

    With `ref_ties` the median split orders equal-cost chunks the way
    the reference's unstable v8 sort did (see `_v8_sort`) and the Lloyd
    refinement is skipped, reproducing the reference encoder's grouping;
    without it, ties keep chunk order and Lloyd rounds follow (the
    grouping the device path and the JAX package's default build)."""
    return _optimize_groups(syms, alphabet_size, initial_freq, ref_ties,
                            code_lengths_from_freqs, group_costs,
                            chunk_freqs)


def optimize_groups_plain(syms, alphabet_size, initial_freq, ref_ties):
    """Plain twin of `optimize_groups`: the same refinement on the numpy
    stages."""
    return _optimize_groups(syms, alphabet_size, initial_freq, ref_ties,
                            code_lengths_plain, group_costs_plain,
                            chunk_freqs_plain)


def _optimize_groups(syms, alphabet_size, initial_freq, ref_ties,
                     lengths_of, costs_of, freqs_of):
    def assign(length_matrix):
        # first minimum wins, like the reference's strict `<` scan
        return np.argmin(costs_of(length_matrix, syms),
                         axis=1).astype(np.uint8)

    target = target_group_count(len(syms))
    length_matrix = np.stack([
        lengths_of(initial_freq, alphabet_size),
        lengths_of(np.ones(alphabet_size, dtype=np.int64), alphabet_size)])
    while length_matrix.shape[0] < target:
        selectors = assign(length_matrix)
        counts = np.bincount(selectors, minlength=length_matrix.shape[0])
        which = int(np.argmax(counts))  # first max, like indexOf
        # cost of each chunk assigned to `which`; split the top half
        costs = costs_of(length_matrix, syms)[:, which]
        members = np.nonzero(selectors == which)[0]
        if ref_ties:
            pairs = [(int(costs[m]), int(m)) for m in members]
            _v8_sort(pairs)
            order = np.array([m for _, m in pairs], dtype=np.int64)
        else:
            order = members[np.argsort(costs[members], kind='stable')]
        selectors[order[len(order) >> 1:]] = length_matrix.shape[0]
        n_groups = length_matrix.shape[0] + 1
        freqs = freqs_of(syms, selectors, n_groups, alphabet_size)
        length_matrix = np.stack([lengths_of(freqs[g], alphabet_size)
                                  for g in range(n_groups)])
    selectors = assign(length_matrix)
    if ref_ties:   # the reference stops at the final assignment above
        return length_matrix, selectors

    # Lloyd rounds beyond the reference heuristic: alternate min-cost
    # selector assignment and table rebuilds from the resulting
    # per-group frequencies; each round cannot raise the payload cost,
    # so stop at the first that does not lower it (at most 4)
    n_groups = length_matrix.shape[0]
    prev_cost = None
    for _ in range(4):
        freqs = freqs_of(syms, selectors, n_groups, alphabet_size)
        group_counts = np.bincount(selectors, minlength=n_groups)
        length_matrix = np.stack([
            lengths_of(freqs[g], alphabet_size)
            if group_counts[g] else length_matrix[g]   # keep empty groups
            for g in range(n_groups)])
        costs = costs_of(length_matrix, syms)
        selectors = np.argmin(costs, axis=1).astype(np.uint8)
        cost = int(costs[np.arange(costs.shape[0]), selectors].sum())
        if prev_cost is not None and cost >= prev_cost:
            break
        prev_cost = cost
    return length_matrix, selectors


def payload_bytes(syms, selectors, length_matrix, code_matrix):
    """Huffman payload packed MSB first: (bytes, total_bits)."""
    return native.payload_pack(syms, selectors, length_matrix, code_matrix)


def payload_bytes_plain(syms, selectors, length_matrix, code_matrix):
    """Plain twin of `payload_bytes`: each code (<= 20 bits) lands in at
    most two consecutive 32-bit words, so a left-aligned u64 split into
    hi and lo halves OR-accumulated at the word index packs the stream."""
    n = syms.shape[0]
    chunk_of_sym = np.repeat(np.arange(len(selectors)), GROUP_SIZE)[:n]
    sel = selectors[chunk_of_sym].astype(np.int64)
    lens = length_matrix[sel, syms].astype(np.int64)
    codes = code_matrix[sel, syms].astype(np.uint64)
    offsets = np.cumsum(lens) - lens
    total = int(offsets[-1] + lens[-1]) if n else 0
    nwords = (total + 31) // 32 + 1
    wi = (offsets >> 5).astype(np.int64)
    bo = (offsets & 31).astype(np.uint64)
    chunk64 = codes << (np.uint64(64) - bo - lens.astype(np.uint64))
    hi = (chunk64 >> np.uint64(32)).astype(np.uint32)
    lo = (chunk64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    words = np.zeros(nwords, dtype=np.uint32)
    np.bitwise_or.at(words, wi, hi)
    np.bitwise_or.at(words, wi + 1, lo)
    out = words.byteswap().view(np.uint8)  # big-endian bit order
    return out[:(total + 7) // 8], total


def emit_table_deltas(code_lengths):
    """Delta-coded length table bits: 5-bit start, then per symbol 2-bit
    inc (10) / dec (11) steps and a 0 stop bit.  Returns uint8 0/1."""
    bits = []
    current = int(code_lengths[0])
    for i in range(4, -1, -1):
        bits.append((current >> i) & 1)
    for length in code_lengths:
        length = int(length)
        step = [1, 0] if current < length else [1, 1]
        for _ in range(abs(length - current)):
            bits.extend(step)
        bits.append(0)
        current = length
    return np.array(bits, dtype=np.uint8)


def selector_mtf_bits(selectors, n_groups):
    """Selectors move-to-front coded, then unary coded."""
    return native.selector_mtf(selectors, n_groups)


def selector_mtf_bits_plain(selectors, n_groups):
    """Plain twin of `selector_mtf_bits`."""
    lst = list(range(n_groups))
    bits = []
    for s in selectors:
        s = int(s)
        j = lst.index(s)
        if j:
            del lst[j]
            lst.insert(0, s)
        bits.extend([1] * j)
        bits.append(0)
    return np.array(bits, dtype=np.uint8)
