"""The cyclic BWT on the host (counterpart of
``compressjs_tpu.ops.bwt.bwtransform2``): the native runtime's
two-stage rotation sort, and `cyclic_suffix_array`, numpy prefix
doubling, as its plain twin.  The encoder's ``self_check`` holds the
card's BWT against `bwtransform2`."""

from __future__ import annotations

import numpy as np

from .. import native


def bwtransform2(T, U, n):
    """Cyclic BWT of T[:n]: U[j] is the last byte of the j-th sorted
    rotation (identical rotations: larger start first).  Fills U[:n]
    and returns pidx, the sorted position of rotation 0."""
    if n <= 1:
        if n == 1:
            U[0] = T[0]
        return 0
    Un, pidx = native.bwt_cyclic(np.asarray(T)[:n])
    U[:n] = Un
    return pidx


def bwtransform2_plain(T, U, n):
    """Plain twin of `bwtransform2`."""
    T = np.asarray(T)
    if n <= 1:
        if n == 1:
            U[0] = T[0]
        return 0
    order = cyclic_suffix_array(T, n)
    U[:n] = T[(order - 1) % n]
    return int(np.nonzero(order == 0)[0][0])


def cyclic_suffix_array(T, n):
    """Rotation start indices of T[:n] in sorted order, identical
    rotations by descending start (as a doubled-string suffix sort
    orders them: the later start is the shorter suffix of T + T)."""
    T = np.asarray(T)[:n]
    if n <= 1:
        return np.zeros(max(n, 0), dtype=np.int32)
    rank = T.astype(np.int64)
    idx = np.arange(n, dtype=np.int64)
    k = 1
    while k < n:
        rank2 = rank[(idx + k) % n]
        order = np.lexsort((rank2, rank))
        key1 = rank[order]
        key2 = rank2[order]
        diff = np.ones(n, dtype=bool)
        diff[1:] = (key1[1:] != key1[:-1]) | (key2[1:] != key2[:-1])
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.cumsum(diff) - 1
        if rank[order[-1]] == n - 1:
            break
        k <<= 1
    return np.lexsort((-idx, rank)).astype(np.int32)
