"""Zero-run digits of the BWTC codec's block body (counterpart of
``compressjs_tpu.ops.rle.runab_encode_lengths``, the one function of
that module the codec calls)."""

from __future__ import annotations

RUNA = 0
RUNB = 1


def runab_encode_lengths(L):
    """Bijective base-2 digits (least significant first) of one zero-run
    length L: bit i of L + 1 selects RUNB (1) or RUNA (0); there are
    fls(L + 1) - 1 digits."""
    L = int(L)
    return [((L + 1) >> i) & 1 for i in range((L + 1).bit_length() - 1)]
