"""The cyclic BWT and its inverse on the host (counterparts of
``compressjs_tpu.ops.bwt.bwtransform2`` and ``inverse_bwt_cyclic``): the
native runtime's two-stage rotation sort and LF walk, and numpy twins of
both (`cyclic_suffix_array`, prefix doubling; `inverse_bwt_plain`, the
LF orbit by doubling).  The encoder's ``self_check`` holds the card's
BWT against `bwtransform2`; the host block decode inverts with
`inverse_bwt`."""

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


def inverse_bwt(U, pidx):
    """Invert the cyclic BWT of the column U with origPtr pidx: the
    native LF walk."""
    return native.inverse_bwt(U, pidx)


def inverse_bwt_plain(U, pidx):
    """Plain twin of `inverse_bwt`: LF[i] = (bytes of U smaller than
    U[i]) + (earlier positions holding U[i]); the orbit pidx, LF(pidx),
    ... by doubling, read backwards."""
    U = np.asarray(U, dtype=np.uint8)
    n = U.shape[0]
    if not 0 <= pidx < n:
        raise ValueError('inverse_bwt: origPtr %d outside a block of %d '
                         'bytes' % (pidx, n))
    order = np.argsort(U, kind='stable')
    lf = np.empty(n, dtype=np.int64)
    lf[order] = np.arange(n)
    seq = np.array([pidx], dtype=np.int64)
    step = lf
    while seq.shape[0] < n:
        seq = np.concatenate([seq, step[seq[:n - seq.shape[0]]]])
        step = step[step]
    return U[seq][::-1].copy()
