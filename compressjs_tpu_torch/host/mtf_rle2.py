"""Move-to-front and RLE2 of a BWT column on the host (counterpart of
``compressjs_tpu.codecs.bzip2.mtf_rle2``, with ``host.mtf``'s and
``host.rle``'s numpy builds, ``mtf_encode_plain`` and
``mtf_rle2_encode``, as its plain twin).

`mtf_rle2` is one fused scan of the native runtime: MTF against the
sorted used-byte alphabet, zero runs as bijective base-2 RUNA/RUNB
digits, index j as symbol j + 1, then EOB, with the symbol histogram.
`mtf_rle2_plain` makes the same three passes in Python and numpy.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .mtf import mtf_encode_plain
from .rle import mtf_rle2_encode


def mtf_rle2(U, alphabet, alphabet_size):
    """(syms uint16 ending in EOB = alphabet_size + 1, freq
    int64[alphabet_size + 2]) of the BWT column U over `alphabet`."""
    if len(alphabet) != alphabet_size:
        raise ValueError('alphabet holds %d symbols, not %d'
                         % (len(alphabet), alphabet_size))
    return native.mtf_rle2(U, alphabet)


def mtf_rle2_plain(U, alphabet, alphabet_size):
    """Plain twin of `mtf_rle2`."""
    syms = mtf_rle2_encode(mtf_encode_plain(U, alphabet),
                           alphabet_size + 1)
    return syms, np.bincount(syms, minlength=alphabet_size + 2)
