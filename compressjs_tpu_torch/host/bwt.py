"""The BWTs and their inverses on the host (counterparts of
``compressjs_tpu.ops.bwt``).

* The cyclic BWT of bzip2 (`bwtransform2`, `inverse_bwt`, and
  `inverse_bwt_cyclic` with the JAX signature): the native runtime's
  two-stage rotation sort and LF walk, and numpy twins of both
  (`cyclic_suffix_array`, prefix doubling; `inverse_bwt_plain`, the LF
  orbit by doubling).  The encoder's ``self_check`` holds the card's
  BWT against `bwtransform2`; the host block decode inverts with
  `inverse_bwt`.
* The EOF-terminated BWT of the BWTC codec (`bwtransform`,
  `unbwtransform`), with the reference's signatures: above 4096 bytes
  the native runtime (``cz_bwt_eof``, ``cz_inverse_bwt_eof``), else the
  numpy twins (`bwtransform_plain` on `suffix_array`,
  `unbwtransform_plain`).
* `suffixsort`, the reference's suffix array call: above 4096 bytes the
  native two-stage sorter (``native.suffix_sort``), else
  `suffix_array`.
"""

from __future__ import annotations

import numpy as np

from .. import native


def bwtransform2(T, U, n, alphabet_size=256):
    """Cyclic BWT of T[:n]: U[j] is the last byte of the j-th sorted
    rotation (identical rotations: larger start first).  Fills U[:n]
    and returns pidx, the sorted position of rotation 0.  alphabet_size
    is the reference's signature."""
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


def cyclic_suffix_array(T, n=None):
    """Rotation start indices of T[:n] in sorted order, identical
    rotations by descending start (as a doubled-string suffix sort
    orders them: the later start is the shorter suffix of T + T)."""
    T = np.asarray(T)[:n]
    n = T.shape[0]
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


def inverse_bwt_cyclic(U, n, pidx):
    """`inverse_bwt` of U[:n], with the JAX package's signature."""
    return inverse_bwt(np.asarray(U)[:n], pidx)


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


# ---------------------------------------------------------------------------
# the EOF-terminated BWT (BWTC)

NATIVE_MIN = 4096


def suffix_array(T, n=None):
    """Suffix array (int32) of T[:n] terminated by a virtual sentinel
    below every byte (a suffix that is a prefix of another sorts first),
    by prefix doubling."""
    T = np.asarray(T)[:n]
    n = T.shape[0]
    if n <= 1:
        return np.zeros(max(n, 0), dtype=np.int32)
    rank = T.astype(np.int64)
    sa = np.argsort(rank, kind='stable')
    diff = np.ones(n, dtype=bool)
    diff[1:] = rank[sa][1:] != rank[sa][:-1]
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = np.cumsum(diff) - 1
    k = 1
    while k < n:
        rank2 = np.full(n, -1, dtype=np.int64)   # past the end: first
        rank2[:n - k] = rank[k:]
        sa = np.lexsort((rank2, rank))
        key1, key2 = rank[sa], rank2[sa]
        diff[1:] = (key1[1:] != key1[:-1]) | (key2[1:] != key2[:-1])
        rank = np.empty(n, dtype=np.int64)
        rank[sa] = np.cumsum(diff) - 1
        if rank[sa[-1]] == n - 1:   # all ranks distinct
            break
        k <<= 1
    return sa.astype(np.int32)


def suffixsort(T, SA, n, alphabet_size=256):
    """Fill SA[:n] with the suffix array of T[:n] (`suffix_array`'s
    order).  Returns 0; alphabet_size is the reference's signature."""
    if n > NATIVE_MIN:
        SA[:n] = native.suffix_sort(np.asarray(T)[:n])
    else:
        SA[:n] = suffix_array(T, n)
    return 0


def bwtransform(T, U, A, n, alphabet_size=256):
    """EOF-terminated BWT of T[:n] into U[:n]: U[0] = T[n-1], then the
    byte before each sorted suffix, the slot of suffix 0 skipped.
    Returns pidx + 1, pidx being suffix 0's place in the suffix array.
    A is scratch of the reference's signature (the twin leaves the
    suffix array there); alphabet_size is the reference's too."""
    if n > NATIVE_MIN:
        U[:n], pidx = native.bwt_eof(np.asarray(T)[:n])
        return pidx
    return bwtransform_plain(T, U, A, n)


def bwtransform_plain(T, U, A, n):
    """Numpy twin of `bwtransform`."""
    T = np.asarray(T)
    if n <= 1:
        if n == 1:
            U[0] = T[0]
        return n
    sa = suffix_array(T, n)
    A[:n] = sa
    pidx = int(np.flatnonzero(sa == 0)[0])
    prev = T[(sa - 1) % n]
    U[0] = T[n - 1]
    U[1:pidx + 1] = prev[:pidx]
    U[pidx + 1:n] = prev[pidx + 1:]
    return pidx + 1


def unbwtransform(T, U, LF, n, pidx):
    """Invert the EOF-terminated BWT: U[:n] from the column T[:n] and
    `bwtransform`'s return value pidx.  LF is scratch of the
    reference's signature."""
    if n > NATIVE_MIN:
        U[:n] = native.inverse_bwt_eof(np.asarray(T)[:n], pidx)
        return
    unbwtransform_plain(T, U, LF, n, pidx)


def unbwtransform_plain(T, U, LF, n, pidx):
    """Numpy twin of `unbwtransform`: the reference walks t = 0,
    f(t), ... with f(t) = LF(t) + (LF(t) < pidx) and writes T[t] back to
    front; here the walk is the orbit of 0 under f by doubling (the
    last step, to slot n when pidx == n, is computed but never read, so
    it is clamped)."""
    T = np.asarray(T)[:n]
    if n == 0:
        return
    order = np.argsort(T, kind='stable')
    lf = np.empty(n, dtype=np.int64)
    lf[order] = np.arange(n)
    f = np.minimum(lf + (lf < pidx), n - 1)
    seq = np.zeros(1, dtype=np.int64)
    step = f
    while seq.shape[0] < n:
        seq = np.concatenate([seq, step[seq[:n - seq.shape[0]]]])
        step = step[step]
    U[:n] = T[seq[::-1]]
