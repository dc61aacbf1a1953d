"""Move-to-front over a sorted alphabet list, the BWTC codec's host MTF
(counterpart of ``compressjs_tpu.ops.mtf``): the list starts as the
block's used bytes in order and each coded byte moves to its front.

`used_alphabet` is that starting list.  Above 2048 symbols the native
runtime runs the loop (``cz_mtf_encode``, ``cz_mtf_decode``); below,
and in the tests, its Python twin does.
"""

from __future__ import annotations

import numpy as np

from .. import native

NATIVE_MIN = 2048


def used_alphabet(block):
    """The sorted byte values present in `block` (uint8): bzip2's symbol
    map and the list MTF starts from."""
    present = np.zeros(256, dtype=bool)
    present[np.asarray(block)] = True
    return np.flatnonzero(present).astype(np.uint8)


def mtf_encode(data, alphabet):
    """MTF indices (int32) of the bytes `data` over `alphabet`."""
    data = np.asarray(data)
    if data.shape[0] > NATIVE_MIN:
        return native.mtf_encode(data, alphabet)
    return mtf_encode_plain(data, alphabet)


def mtf_encode_plain(data, alphabet):
    """Python twin of `mtf_encode`."""
    lst = [int(x) for x in alphabet]
    out = np.empty(np.asarray(data).shape[0], dtype=np.int32)
    for i, c in enumerate(np.asarray(data).tolist()):
        j = lst.index(c)
        out[i] = j
        if j:
            del lst[j]
            lst.insert(0, c)
    return out


def mtf_decode(indices, alphabet):
    """The bytes (uint8) of MTF `indices` over `alphabet`."""
    indices = np.asarray(indices)
    if indices.shape[0] > NATIVE_MIN:
        return native.mtf_decode(indices, alphabet)
    return mtf_decode_plain(indices, alphabet)


def mtf_decode_plain(indices, alphabet):
    """Python twin of `mtf_decode`."""
    lst = [int(x) for x in alphabet]
    out = np.empty(np.asarray(indices).shape[0], dtype=np.uint8)
    for i, j in enumerate(np.asarray(indices).tolist()):
        c = lst[j]
        out[i] = c
        if j:
            del lst[j]
            lst.insert(0, c)
    return out
