"""Run-length stages on the host (counterpart of ``compressjs_tpu.ops.rle``):
RLE1's block fill and undo (from `rle1`, re-exported here under the
JAX module's names), and RLE2, bzip2's zero-run coding of MTF indices:
each run of zeros as bijective base-2 RUNA/RUNB digits, least
significant first.

`mtf_rle2_encode` is the numpy build of the symbol stream; the encoder
runs the native fused scan (``host.mtf_rle2.mtf_rle2``) and holds it
against this one.  `runab_encode_lengths` is one run's digits, as the
BWTC codec's block body writes them.
"""

from __future__ import annotations

import numpy as np

from .rle1 import _segment_positions, _within_positions, run_lengths
from .rle1 import rle1_decode, rle1_encode  # noqa: F401  (the JAX names)

RUNA = 0
RUNB = 1


def runab_digits_length(run_lengths_arr):
    """RUNA/RUNB digit count of each zero-run length L:
    floor(log2(L + 1))."""
    L = np.asarray(run_lengths_arr, dtype=np.int64)
    return np.int64(np.floor(np.log2(L + 1)))  # exact for L < 2^52


def runab_encode_lengths(L):
    """Bijective base-2 digits (least significant first) of one zero-run
    length L: bit i of L + 1 selects RUNB (1) or RUNA (0); there are
    fls(L + 1) - 1 digits."""
    L = int(L)
    return [((L + 1) >> i) & 1 for i in range((L + 1).bit_length() - 1)]


def mtf_rle2_encode(mtf_seq, eob):
    """bzip2 symbol stream (uint16) of MTF indices: zero runs become
    RUNA (0) / RUNB (1) digits, least significant first (digit i of a
    run of L is bit i of L + 1), index j becomes j + 1, then EOB."""
    mtf_seq = np.asarray(mtf_seq)
    if mtf_seq.shape[0] == 0:
        return np.array([eob], dtype=np.uint16)
    vals, lens = run_lengths(mtf_seq)
    is_zero = vals == 0
    digit_counts = np.where(is_zero, runab_digits_length(lens), lens)
    out = np.empty(int(digit_counts.sum()) + 1, dtype=np.uint16)
    offs = np.concatenate(([0], np.cumsum(digit_counts)[:-1]))
    nz = ~is_zero
    out[_segment_positions(offs[nz], lens[nz])] = np.repeat(
        vals[nz].astype(np.uint16) + 1, lens[nz])
    kdig = runab_digits_length(lens[is_zero])
    within = _within_positions(kdig)
    out[_segment_positions(offs[is_zero], kdig)] = (
        (np.repeat(lens[is_zero] + 1, kdig) >> within) & 1)
    out[-1] = eob
    return out
