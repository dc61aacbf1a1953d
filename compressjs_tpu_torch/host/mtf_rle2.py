"""Move-to-front and RLE2 of a BWT column on the host (counterpart of
``compressjs_tpu.codecs.bzip2.mtf_rle2``, with ``ops.mtf.mtf_encode``
and ``ops.rle.mtf_rle2_encode`` as its plain twin).

`mtf_rle2` is one fused scan of the native runtime: MTF against the
sorted used-byte alphabet, zero runs as bijective base-2 RUNA/RUNB
digits, index j as symbol j + 1, then EOB, with the symbol histogram.
`mtf_rle2_plain` makes the same three passes in Python and numpy.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .rle1 import _segment_positions, _within_positions, run_lengths


def mtf_rle2(U, alphabet, alphabet_size):
    """(syms uint16 ending in EOB = alphabet_size + 1, freq
    int64[alphabet_size + 2]) of the BWT column U over `alphabet`."""
    if len(alphabet) != alphabet_size:
        raise ValueError('alphabet holds %d symbols, not %d'
                         % (len(alphabet), alphabet_size))
    return native.mtf_rle2(U, alphabet)


def mtf_rle2_plain(U, alphabet, alphabet_size):
    """Plain twin of `mtf_rle2`."""
    syms = rle2_encode_plain(mtf_encode_plain(U, alphabet),
                             alphabet_size + 1)
    return syms, np.bincount(syms, minlength=alphabet_size + 2)


def mtf_encode_plain(data, alphabet):
    """MTF indices (int32) of `data` against the initial list
    `alphabet`."""
    lst = [int(x) for x in alphabet]
    out = np.empty(len(data), dtype=np.int32)
    find = lst.index
    for i, c in enumerate(np.asarray(data).tolist()):
        j = find(c)
        out[i] = j
        if j:
            del lst[j]
            lst.insert(0, c)
    return out


def _digits(lengths):
    """RUNA/RUNB digit count of each zero-run length L:
    floor(log2(L + 1))."""
    return np.int64(np.floor(np.log2(np.asarray(lengths, np.int64) + 1)))


def rle2_encode_plain(mtf_seq, eob):
    """bzip2 symbol stream (uint16) of MTF indices: zero runs become
    RUNA (0) / RUNB (1) digits, least significant first (digit i of a
    run of L is bit i of L + 1), index j becomes j + 1, then EOB."""
    mtf_seq = np.asarray(mtf_seq)
    if mtf_seq.shape[0] == 0:
        return np.array([eob], dtype=np.uint16)
    vals, lens = run_lengths(mtf_seq)
    is_zero = vals == 0
    digit_counts = np.where(is_zero, _digits(lens), lens)
    out = np.empty(int(digit_counts.sum()) + 1, dtype=np.uint16)
    offs = np.concatenate(([0], np.cumsum(digit_counts)[:-1]))
    nz = ~is_zero
    out[_segment_positions(offs[nz], lens[nz])] = np.repeat(
        vals[nz].astype(np.uint16) + 1, lens[nz])
    kdig = _digits(lens[is_zero])
    within = _within_positions(kdig)
    out[_segment_positions(offs[is_zero], kdig)] = (
        (np.repeat(lens[is_zero] + 1, kdig) >> within) & 1)
    out[-1] = eob
    return out
