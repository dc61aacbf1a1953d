"""Context-parallel rotation sort: one block's cyclic rotation sort split
over the ranks of a `mesh.Mesh`, each rank holding O(n/d) of every
array (counterpart of ``compressjs_tpu.parallel.sharded_sort``).

Rank r holds positions [r s, (r + 1) s) of the block, s = n / d, and
runs the quad prefix-doubling rounds of ``ops.block_kernels.
cyclic_suffix_sort`` with every array sharded:

* **A distributed sort is a bitonic network of merge-splits over the
  shards** (`_bitonic_shard_sort`): each comparator swaps whole shards
  with its hypercube partner, sorts the 2s elements and keeps the low or
  the high half.  Both partners sort the same (lower rank, higher rank)
  concatenation with one stable sort, so tied keys with different
  payloads still split into complementary halves.  d is a power of two.
* **The shifted ranks** rank[(i + k) mod n] of a shard are a window over
  at most two other shards (`_shifted_window`).
* **Ranks go back to position order by a second bitonic sort keyed by
  position** (`_route_to_positions`): positions are a permutation, so
  every rank ends with exactly s of them.
* **Every ppermute of the JAX module is one paired exchange**
  (`_exchange`: the send and the receive in one
  ``dist.batch_isend_irecv``, so two partners never both block in a
  send), and a pair whose source is the rank itself is a local copy (a
  one-rank NCCL group cannot send to itself).  The tied count is
  all-reduced, so every rank runs and skips the same rounds and the same
  collectives.

Where the JAX module sorts four 32-bit keys, this one packs them into
two int64 keys; the order is the same.  No exchanged tensor holds more
than s elements; ``gather=True`` all-gathers the s-element shards of the
result at the end.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.block_kernels import _lex_order
from .mesh import _on


def _exchange(mesh, send_to, recv_from, tensors):
    """Send `tensors` to rank `send_to` and receive tensors of the same
    shapes from rank `recv_from`, as one batch of point-to-point ops (a
    local copy where the peer is this rank)."""
    if send_to == mesh.rank:
        return [t.clone() for t in tensors]
    out = [torch.empty_like(t) for t in tensors]
    group = mesh.group
    dst = dist.get_global_rank(group, send_to)
    src = dist.get_global_rank(group, recv_from)
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group)
           for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, src, group) for t in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _ring(mesh, tensors, step):
    """Each rank's `tensors` sent `step` ranks on (mod d): returns the
    tensors of rank (rank - step) mod d."""
    d = mesh.size
    return _exchange(mesh, (mesh.rank + step) % d, (mesh.rank - step) % d,
                     tensors)


def _all_reduce_sum(mesh, t):
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def _sorted(arrays, num_keys):
    """`arrays` in the lexicographic order of the first num_keys of them
    (stable: rows with equal keys keep their order)."""
    order = _lex_order(arrays[:num_keys])
    return [a[order] for a in arrays]


def _bitonic_shard_sort(mesh, arrays, num_keys):
    """Sort the rows (key..., payload...) held across the ranks: returns
    this rank's shard of the globally sorted rows, rank-major.  Each
    comparator of the network is one exchange of a shard with the
    partner and one local sort of 2s rows."""
    me = mesh.rank
    arrays = _sorted(arrays, num_keys)
    s = arrays[0].shape[0]
    size = 2
    while size <= mesh.size:
        stride = size >> 1
        while stride >= 1:
            partner = me ^ stride
            received = _exchange(mesh, partner, partner, arrays)
            low = me < partner
            merged = _sorted([torch.cat([a, b] if low else [b, a])
                              for a, b in zip(arrays, received)], num_keys)
            keep_low = low == ((me & size) == 0)
            arrays = [m[:s] if keep_low else m[s:] for m in merged]
            stride >>= 1
        size <<= 1
    return arrays


def _shifted_window(mesh, rank_shard, k):
    """rank[(base + j + k) mod n] for j in [0, s): the window k past this
    shard, from at most two source shards."""
    s = rank_shard.shape[0]
    d = mesh.size
    dev_off, off = (k // s) % d, k % s
    a, = _ring(mesh, [rank_shard], -dev_off)
    if off == 0:
        return a
    b, = _ring(mesh, [rank_shard], -dev_off - 1)
    return torch.cat([a, b])[off:off + s]


def _distributed_rank_compress(mesh, keys):
    """Group-start ranks of globally sorted key rows (this rank's shard
    of them), and the all-reduced count of rows in groups of more than
    one."""
    me, d = mesh.rank, mesh.size
    s = keys[0].shape[0]
    dev = keys[0].device
    prevs = _ring(mesh, [k[-1:] for k in keys], 1)
    diff = torch.zeros(s, dtype=torch.bool, device=dev)
    if me == 0:
        diff[0] = True
    else:
        diff[0] = torch.cat([k[:1] != p for k, p in zip(keys, prevs)]).any()
    for k in keys:
        diff[1:] |= k[1:] != k[:-1]
    gpos = me * s + torch.arange(s, device=dev)
    # positions before the first local diff belong to a group that starts
    # on an earlier rank: the last group start on any earlier rank
    local_start = torch.cummax(torch.where(diff, gpos, -1), 0).values
    all_last = mesh.all_gather(local_start[-1:])
    carry = torch.where(torch.arange(d, device=dev) < me, all_last,
                        -1).max()
    rank_sorted = torch.where(local_start >= 0, local_start, carry)
    # a row is a singleton iff a diff flag sits on it and on the next row
    nxt_first, = _ring(mesh, [diff[:1].to(torch.int64)], -1)
    last = torch.ones(1, dtype=torch.bool, device=dev) if me == d - 1 \
        else nxt_first.bool()
    singleton = diff & torch.cat([diff[1:], last])
    tied = _all_reduce_sum(mesh, (s - singleton.sum()).view(1))
    return rank_sorted, int(tied)


def _route_to_positions(mesh, positions, vals):
    """`vals` of the rows at `positions` (a permutation spread over the
    ranks) in position-sharded order."""
    return _bitonic_shard_sort(mesh, [positions, vals], 1)[1]


def _recount_tied(mesh, rank_shard):
    """All-reduced count of positions whose rank another position shares,
    from position-sharded ranks: sort them, then compare each with its
    neighbours, across shard boundaries too."""
    me, d = mesh.rank, mesh.size
    s = rank_shard.shape[0]
    dev = rank_shard.device
    gpos = me * s + torch.arange(s, device=dev)
    r_sorted, _ = _bitonic_shard_sort(mesh, [rank_shard, gpos], 1)
    prev, = _ring(mesh, [r_sorted[-1:]], 1)
    nxt, = _ring(mesh, [r_sorted[:1]], -1)
    left = torch.cat([torch.full_like(prev, -1) if me == 0 else prev,
                      r_sorted[:-1]])
    right = torch.cat([r_sorted[1:],
                       torch.full_like(nxt, -2) if me == d - 1 else nxt])
    tied = ((r_sorted == left) | (r_sorted == right)).sum().view(1)
    return int(_all_reduce_sum(mesh, tied))


def sharded_cyclic_suffix_sort(mesh, block, rounds=None, gather=True):
    """Sorted rotation start indices of `block` (uint8[n], numpy or
    tensor; every rank is called with the same block and moves only its
    own shard to its device), ties between equal rotations broken by
    descending index, with every array sharded over `mesh`.  n must be a
    multiple of the mesh size, a power of two.  `rounds` caps the quad
    rounds (the JAX function's argument).  Returns the order as an int64
    tensor on the mesh's device: all n entries on every rank with
    gather=True, else this rank's s = n / d entries (ranks r s to
    (r + 1) s - 1 of the order)."""
    n = int(block.shape[0])
    d = mesh.size
    assert n % d == 0, 'block length must divide the mesh size'
    assert d & (d - 1) == 0, 'mesh size must be a power of two'
    s = n // d
    me = mesh.rank
    ks = []
    k = 16
    while k < n:
        ks.append(k)
        k *= 4
    if rounds is not None:
        ks = ks[:rounds]
    shard = _on(block[me * s:(me + 1) * s], mesh.device).to(torch.int64)
    gpos = me * s + torch.arange(s, device=mesh.device)

    # seed: 16 bytes of cyclic context a position, the shard's tail
    # reading the next shard's first 15 bytes
    nxt, = _ring(mesh, [shard], -1)
    ext = torch.cat([shard, nxt[:15]])

    def word(o):
        return ((ext[o:o + s] << 24) | (ext[o + 1:o + 1 + s] << 16)
                | (ext[o + 2:o + 2 + s] << 8) | ext[o + 3:o + 3 + s])

    # two 32-bit words to an int64 key, the first offset by -2^31 so that
    # the signed order is the unsigned one
    keys = [((word(0) - (1 << 31)) << 32) | word(4),
            ((word(8) - (1 << 31)) << 32) | word(12)]
    srt = _bitonic_shard_sort(mesh, keys + [gpos], 2)
    rank_sorted, tied = _distributed_rank_compress(mesh, srt[:2])
    rank = _route_to_positions(mesh, srt[2], rank_sorted)

    # the quad rounds, each skipped by every rank alike once no rank
    # holds a tie
    for i, k in enumerate(ks):
        if tied == 0:
            break
        r2 = _shifted_window(mesh, rank, k)
        r3 = _shifted_window(mesh, rank, 2 * k % n)
        r4 = _shifted_window(mesh, rank, 3 * k % n)
        srt = _bitonic_shard_sort(
            mesh, [(rank << 32) | r2, (r3 << 32) | r4, gpos], 2)
        rank_sorted, _ = _distributed_rank_compress(mesh, srt[:2])
        rank = _route_to_positions(mesh, srt[2], rank_sorted)
        if i < len(ks) - 1:
            tied = _recount_tied(mesh, rank)

    # final order: rank ascending, index descending (identical
    # rotations of a periodic block)
    _, order = _bitonic_shard_sort(mesh, [rank * n + (n - 1 - gpos), gpos],
                                   1)
    return mesh.all_gather(order) if gather else order
