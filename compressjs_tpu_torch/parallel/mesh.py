"""Data parallelism over bzip2 blocks with ``torch.distributed``
(counterpart of ``compressjs_tpu.parallel.mesh``).

Blocks are the parallel axis: bzip2 blocks share only the rolling stream
CRC and the bit alignment, both of which the host handles.  One process
drives each card (NCCL between GPUs; gloo between CPU processes, as the
tests run it).  Every rank is called with the same blocks.  Rank r
encodes or inverts the blocks `_ring_order` gives it (block i on rank
i mod size), one by one, with the package's block kernels; the ranks
then exchange a manifest of each block's sizes with an all-gather, and
the per-block outputs padded to the largest size the manifest shows, so
every rank returns every block's outputs in block order.  The ranks'
shares may differ by one block: a rank loops over its own blocks, so no
filler block pads the shares to equal length (the JAX package's
``_pad_block`` exists for ``shard_map``'s equal shards).

Where no process group is initialised, `make_mesh` gives a mesh of one
rank whose all-gather returns the local tensor; everything around the
collective is the same code either way.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..convert import as_u8, block_inputs
from ..host.bzip2 import (StreamWriter, _ref_ties_default, block_meta,
                          block_size_of, split_blocks)
from ..ops.block_decode import (inverse_bwt_block, inverse_bwt_block_masked,
                                inverse_bwt_eof_block)
from ..ops.block_kernels import bwt_eof_block, encode_block_core
from ..ops.device_entropy import GROUP_SIZE, encode_block_full
from .pipeline import block_bits, device_stage

# NCCL and gloo move no int16: such a tensor travels as int32 and comes
# back in its own type
_WIRE = {torch.int16: torch.int32}

# torch >= 2.13 names the flat all-gather `all_gather_single` and warns on
# the older name
_all_gather = getattr(dist, 'all_gather_single', None) \
    or dist.all_gather_into_tensor


class Mesh:
    """The ranks of one process group (or this process alone, where
    `group` is None) and the device this rank's work runs on."""

    def __init__(self, device, group=None):
        self.device = torch.device(device)
        self.group = group
        if group is None:
            self.rank, self.size = 0, 1
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)

    def all_gather(self, t):
        """Every rank's `t` (the same shape on each), concatenated along
        the first axis in rank order."""
        wire = t.to(_WIRE.get(t.dtype, t.dtype)).contiguous()
        if self.group is not None:
            out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                              dtype=wire.dtype, device=t.device)
            _all_gather(out, wire, group=self.group)
            wire = out
        return wire.to(t.dtype)

    def __repr__(self):
        return 'Mesh(rank %d of %d, %s)' % (self.rank, self.size,
                                            self.device)


def make_mesh(device='cuda', group=None):
    """A `Mesh` over `group` (default: the default process group where one
    is initialised, else this process alone) on `device` ('cuda', the
    current card, unless the caller asks for 'cpu').  With NCCL each
    process sets its card first (``torch.cuda.set_device``)."""
    device = torch.device(device)
    if device.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device('cuda', torch.cuda.current_device())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return Mesh(device, group)


def _ring_order(n_blocks, n_dev):
    """Round-robin block -> rank assignment (block i on rank i mod
    n_dev): perm lists rank 0's blocks, then rank 1's, ...; inv is its
    inverse.  Interleaving spreads the blocks of a file region, whose
    sort difficulty tends to cluster, over the ranks."""
    perm = np.concatenate([np.arange(d, n_blocks, n_dev)
                           for d in range(n_dev)])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_blocks)
    return perm, inv


def prepare_blocks(raw_blocks):
    """Host prep: dense-alphabet remap tables and EOB symbols per block."""
    metas = [block_meta(b) for b in raw_blocks]
    return (np.stack(raw_blocks), np.stack([m[2] for m in metas]),
            np.asarray([m[1] + 1 for m in metas], dtype=np.int32))


class _Shares:
    """Which blocks each rank owns, and how to put the ranks' gathered
    rows back in block order."""

    def __init__(self, mesh, n_blocks):
        perm, inv = _ring_order(n_blocks, mesh.size)
        counts = [len(range(r, n_blocks, mesh.size))
                  for r in range(mesh.size)]
        self.mine = np.split(perm, np.cumsum(counts)[:-1])[mesh.rank] \
            .tolist()
        self.k_max = -(-n_blocks // mesh.size)
        # gathered row of each block: rank r's j-th block at r*k_max + j
        rows = np.concatenate([r * self.k_max + np.arange(c)
                               for r, c in enumerate(counts)])
        self.rows = torch.from_numpy(rows[inv]).to(mesh.device)
        self.mesh = mesh

    def gather(self, per_block, shape=(), dtype=None):
        """Each of this rank's results (tensors of at most `shape`, zero
        padded to it; 0-dim with shape ()) gathered from every rank:
        (n_blocks, *shape) in block order."""
        local = torch.zeros((self.k_max,) + tuple(shape), dtype=dtype,
                            device=self.mesh.device)
        for j, t in enumerate(per_block):
            local[(j,) + tuple(slice(0, s) for s in t.shape)] = t
        return self.mesh.all_gather(local)[self.rows]


def _on(x, device):
    """A row of the callers' input (numpy or tensor) on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def sharded_block_encode(mesh, blocks, remaps, eobs):
    """Sort, BWT, MTF and RLE2 of B blocks (``ops.block_kernels.
    encode_block_core``) sharded over the mesh.  blocks: (B, n) uint8
    (or B rows of any lengths); remaps: (B, 256); eobs: (B,).  Returns
    tensors on the mesh's device, every block in block order on every
    rank: (pidx (B,), syms (B, w) int16 with w the largest symbol count,
    count (B,), freq (B, 260) int32, all_counts (B,)), all_counts being
    the manifest of symbol counts (equal to count)."""
    sh = _Shares(mesh, len(blocks))
    dev = mesh.device
    res = []
    for i in sh.mine:
        blk, remap, eob = block_inputs(blocks[i], remaps[i], eobs[i], dev)
        res.append(encode_block_core(blk, blk.shape[0], remap, eob))
    # the manifest: every block's pidx and symbol count
    head = sh.gather([torch.stack([r[0], r[2]]) for r in res], (2,),
                     torch.int64)
    w = int(head[:, 1].max()) if len(blocks) else 0
    syms = sh.gather([r[1][:w] for r in res], (w,), torch.int16)
    freq = sh.gather([r[3] for r in res], (260,), torch.int32)
    return head[:, 0], syms, head[:, 1], freq, head[:, 1]


def sharded_block_encode_full(mesh, blocks, remaps, eobs):
    """The whole block encode of B blocks (``ops.device_entropy.
    encode_block_full``: transforms and the Huffman stage) sharded over
    the mesh, so the host receives packed payloads and the header
    matrices.  Inputs as `sharded_block_encode`.  Returns tensors on the
    mesh's device, in block order on every rank: (pidx (B,), payload
    (B, cap) uint8 with cap the largest payload's bytes, bits (B,), lens
    (B, 6, 260), n_groups (B,), selectors (B, nc), count (B,), all_bits
    (B,)), all_bits being the manifest of payload bits (equal to bits)."""
    sh = _Shares(mesh, len(blocks))
    dev = mesh.device
    res = []
    for i in sh.mine:
        blk, remap, eob = block_inputs(blocks[i], remaps[i], eobs[i], dev)
        res.append(encode_block_full(blk, blk.shape[0], remap, eob))
    # the manifest: pidx, payload bits, group count and symbol count
    head = sh.gather([torch.stack([r[0].to(torch.int64),
                                   torch.tensor(r[2], device=dev),
                                   torch.tensor(r[4], device=dev),
                                   torch.tensor(r[6], device=dev)])
                      for r in res], (4,), torch.int64)
    cap = (int(head[:, 1].max()) + 7) // 8 if len(blocks) else 0
    payload = sh.gather([r[1] for r in res], (cap,), torch.uint8)
    lens = sh.gather([r[3] for r in res], (6, 260), torch.int32)
    nc = max((-(-(len(b) + 1) // GROUP_SIZE) for b in blocks), default=0)
    sel = sh.gather([r[5] for r in res], (nc,), torch.int64)
    return (head[:, 0], payload, head[:, 1], lens, head[:, 2], sel,
            head[:, 3], head[:, 1])


def mesh_compress_bzip2(mesh, data, level=9):
    """bzip2-compress `data` with its blocks' whole encode sharded over
    `mesh` (`sharded_block_encode_full`), then the ordered assembly on
    the host: each block's header bits beside its payload bits, in a
    standard stream.  Every rank is called with the same data and returns
    the same bytes, byte-identical to
    ``compressjs_tpu.codecs.bzip2.compress_file``.  The short tail block
    takes the same device stage, on the rank that owns it; while
    COMPRESSJS_TPU_BZ2_REF_TIES is set every rank encodes it itself, as
    ``DeviceBzip2Encoder`` does: the device stage of its 'core' route,
    then the host Huffman stage, whose grouping follows the variable, as
    the JAX mesh's host tail does."""
    block_size = block_size_of(level)
    blocks = list(split_blocks(as_u8(data), block_size))
    metas = [block_meta(block) for block, _ in blocks]
    n_dev = len(blocks)
    if blocks and blocks[-1][0].shape[0] != block_size \
            and _ref_ties_default():
        n_dev -= 1
    if n_dev:
        pidx, payload, bits, lens, g, sel, count, _ = (
            t.cpu().numpy() for t in sharded_block_encode_full(
                mesh, [b for b, _ in blocks[:n_dev]],
                [m[2] for m in metas[:n_dev]],
                [m[1] + 1 for m in metas[:n_dev]]))
    stream = StreamWriter(level)
    for i, ((block, crc), meta) in enumerate(zip(blocks, metas)):
        res = ('full', int(pidx[i]), payload[i], int(bits[i]), lens[i],
               int(g[i]), sel[i], int(count[i])) if i < n_dev \
            else device_stage(block, meta, 'core', mesh.device)
        header, pay, nbits = block_bits(block, meta, res)
        stream.block(crc, header, np.unpackbits(pay, count=nbits))
    return stream.end().getvalue()


def sharded_block_decode(mesh, Us, pidxs, eof=False):
    """Invert B equal-length BWT columns sharded over the mesh: the
    cyclic transform of bzip2 (``ops.block_decode.inverse_bwt_block``,
    pidx the origPtr) or, with eof=True, the EOF-terminated one of BWTC
    (``inverse_bwt_eof_block``, pidx as `sharded_bwt_eof` returns it).
    Us: (B, n) uint8 columns (numpy or tensor); pidxs: (B,).  Returns
    the (B, n) original blocks on the mesh's device, in block order on
    every rank."""
    n = int(Us.shape[1])
    inv = inverse_bwt_eof_block if eof else inverse_bwt_block
    sh = _Shares(mesh, int(Us.shape[0]))
    out = [inv(_on(Us[i], mesh.device), n, int(pidxs[i])) for i in sh.mine]
    return sh.gather(out, (n,), torch.uint8)


def sharded_bwt_eof(mesh, blocks):
    """EOF-terminated BWT (``ops.block_kernels.bwt_eof_block``) of B
    equal-length blocks sharded over the mesh, the transform of the BWTC
    codec.  blocks: (B, n) uint8 (numpy or tensor).  Returns (U (B, n)
    uint8, pidx (B,) int64: each block's pidx + 1) on the mesh's device,
    in block order on every rank."""
    n = int(blocks.shape[1])
    sh = _Shares(mesh, int(blocks.shape[0]))
    res = [bwt_eof_block(_on(blocks[i], mesh.device), n) for i in sh.mine]
    U = sh.gather([r[0] for r in res], (n,), torch.uint8)
    pidx = sh.gather([r[1] for r in res], (), torch.int64)
    return U, pidx


def mesh_compress_bwtcp(mesh, data, level=9):
    """BWTC-P encode with the full blocks' EOF-terminated BWTs sharded over
    `mesh` (`sharded_bwt_eof`: each rank transforms its own share) and the
    rest the host codec: each block's coder on a host thread and the
    container, ``host.bwtcp.BWTCP.compress_file`` with the transforms
    handed in through its `_PRE_BWT` seam.  As in the JAX package's
    function, a stream of one full block transforms it on the host.
    Every rank is called with the same data and returns the same bytes,
    byte for byte the host codec's."""
    from ..host import bwtcp
    data = as_u8(data)
    bs = bwtcp._level_of(level) * 100000
    n_full = len(data) // bs
    pre = {}
    if n_full > 1:
        U, pidx = sharded_bwt_eof(mesh, data[:n_full * bs].reshape(n_full,
                                                                   bs))
        U, pidx = U.cpu().numpy(), pidx.cpu().tolist()
        pre = {i: (U[i], pidx[i]) for i in range(n_full)}
    token = bwtcp._PRE_BWT.set(pre)
    try:
        return bwtcp.BWTCP.compress_file(data, None, level)
    finally:
        bwtcp._PRE_BWT.reset(token)


def sharded_ragged_inverse_bwt(mesh, Us, ns, pidxs):
    """Invert B ragged cyclic BWT columns sharded over the mesh: the
    blocks of one stream differ in length (RLE1 packing), so each row of
    Us (B, cap) holds its column in its first ns[i] bytes
    (``ops.block_decode.inverse_bwt_block_masked``).  Returns the (B, cap)
    original blocks on the mesh's device, zero past each n, in block
    order on every rank."""
    cap = int(Us.shape[1])
    sh = _Shares(mesh, int(Us.shape[0]))
    out = [inverse_bwt_block_masked(_on(Us[i], mesh.device), cap,
                                    int(ns[i]), int(pidxs[i]))
           for i in sh.mine]
    return sh.gather(out, (cap,), torch.uint8)
