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

from ..convert import block_inputs
from ..host.bits import SQRTPI, WHOLEPI, BitWriter
from ..host.crc32 import stream_crc_combine
from ..ops.block_decode import inverse_bwt_block, inverse_bwt_block_masked
from ..ops.block_kernels import encode_block_core
from ..ops.device_entropy import GROUP_SIZE, encode_block_full
from .pipeline import _block_meta, _device_block_header, _split_blocks

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
    remaps = []
    eobs = []
    for b in raw_blocks:
        used = np.zeros(256, dtype=bool)
        used[b] = True
        remap = np.zeros(256, dtype=np.int32)
        remap[np.nonzero(used)[0]] = np.arange(int(used.sum()))
        remaps.append(remap)
        eobs.append(int(used.sum()) + 1)
    return (np.stack(raw_blocks), np.stack(remaps),
            np.asarray(eobs, dtype=np.int32))


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
    takes the same device stage, on the rank that owns it."""
    if not 1 <= level <= 9:
        raise ValueError('Invalid block size multiplier')
    data = np.frombuffer(bytes(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data, dtype=np.uint8)
    blocks = _split_blocks(data, level * 100000 - 19)
    metas = [_block_meta(block) for block, _ in blocks]
    out = BitWriter()
    out.write_bits(32, int.from_bytes(b'BZh' + bytes([48 + level]), 'big'))
    stream_crc = 0
    if blocks:
        pidx, payload, bits, lens, g, sel, count, _ = (
            t.cpu().numpy() for t in sharded_block_encode_full(
                mesh, [b for b, _ in blocks], [m[2] for m in metas],
                [m[1] + 1 for m in metas]))
        for i, ((_, crc), (used, alphabet_size, _)) in enumerate(
                zip(blocks, metas)):
            header = _device_block_header(int(pidx[i]), lens[i], int(g[i]),
                                          sel[i], int(count[i]),
                                          alphabet_size, used)
            stream_crc = stream_crc_combine(stream_crc, crc)
            out.write_bits(48, WHOLEPI)
            out.write_bits(32, crc)
            out.write_bit_array(header)
            out.write_bit_array(np.unpackbits(payload[i], count=int(bits[i])))
    out.write_bits(48, SQRTPI)
    out.write_bits(32, stream_crc)
    return out.getvalue()


def sharded_block_decode(mesh, Us, pidxs, eof=False):
    """Invert B equal-length cyclic BWT columns sharded over the mesh
    (``ops.block_decode.inverse_bwt_block`` on each rank's blocks).
    Us: (B, n) uint8 columns (numpy or tensor); pidxs: (B,).  Returns
    the (B, n) original blocks on the mesh's device, in block order on
    every rank.  eof=True, the EOF-terminated transform of the BWTC
    codec, is not ported yet."""
    if eof:
        raise NotImplementedError(
            'sharded_block_decode(eof=True): the EOF-terminated inverse '
            'BWT comes with the BWTC family (ROADMAP.md queue A, item 7)')
    n = int(Us.shape[1])
    sh = _Shares(mesh, int(Us.shape[0]))
    out = [inverse_bwt_block(_on(Us[i], mesh.device), n, int(pidxs[i]))
           for i in sh.mine]
    return sh.gather(out, (n,), torch.uint8)


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
