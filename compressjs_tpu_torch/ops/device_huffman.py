"""Tensor build of the parallel canonical-Huffman decode of a bzip2 block
and of the whole block decode (counterpart of
``compressjs_tpu.ops.device_huffman``).

The sequential bit-by-bit walk becomes four parallel stages:

1. `walk_maps`, speculative decode at every bit offset: under each
   group's table the code length at offset p is the smallest L >= min_len
   with ``bits[p:p+L] <= limit[L]``, so ``nxt_g[p] = p + len_g[p]``;
2. `_power_k`: ``F_g = nxt_g^k`` by a squaring ladder of windowed
   compositions (`ops.compose.compose_windowed`, a CUDA kernel on the
   card);
3. `selector_chase`: chunk-boundary bit positions follow
   ``p <- F[sel[c]][p]``, ``50 / k`` times per selector -- one dependent
   chain, run on the card by one CUDA thread that reads F from windows
   staged ahead of it in shared memory (``csrc/selector_chase.cu``), and
   by its plain version, a host loop, for a CPU tensor;
4. `chunk_walk`: every 50-symbol chunk then decodes its 50 symbols.

Stages 1 and 4 are one launch each on the card (``csrc/huffman_walk.cu``);
for a CPU tensor their plain versions, `_next_maps` and
`chunk_walk_plain`, run one tensor operation at a time.

`decode_block_full_dev` follows the walk with RLE2 undo, MTF undo, the
used-alphabet map, the inverse BWT and RLE1 undo (``ops.block_decode``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .block_decode import (inverse_bwt_block_masked, mtf_decode,
                           rle1_decode_dev, rle2_decode)
from .compose import compose_windowed
from ..tracer import stage_timer, staged

MAX_CODE_BITS = 20     # bzip2 code lengths are 1..20
GROUP_SIZE = 50
BIG_LIMIT = 1 << 28    # stands in for the int64-max limit sentinel
# composition power: F = nxt^50 takes 7 compositions and one chase step
# per selector, so the chase, one thread's chain of dependent loads, is
# as short as one thread can make it
POWER_K_DEFAULT = 50
# most selectors one chase launch takes: a bzip2 block has at most 32,767
CHASE_MAX_SEL = 32768
# the walk kernels' caps: bzip2's table count, and the payload bits
MAX_GROUPS = 6
MAX_WALK_BITS = 1 << 30
_MASK32 = 0xFFFFFFFF


def tables_for_device(groups, n_groups):
    """Stack `host.bzip2_parse._decode_tables` outputs into the padded
    int32 numpy arrays (limits (G, 22), bases (G, 21), perms (G, 258),
    mins (G,)) that `huffman_walk_dev` takes, through
    ``convert.decode_tables``.  The int64 limit sentinel clamps to
    BIG_LIMIT: codes are below 2^20, so any larger limit means 'always'."""
    limits = np.full((n_groups, MAX_CODE_BITS + 2), -1, dtype=np.int64)
    bases = np.zeros((n_groups, MAX_CODE_BITS + 1), dtype=np.int64)
    perms = np.zeros((n_groups, 258), dtype=np.int32)
    mins = np.zeros(n_groups, dtype=np.int32)
    for g, (min_len, max_len, limit, base, permute) in enumerate(groups):
        lim = np.asarray(limit[:MAX_CODE_BITS + 2], dtype=np.int64)
        limits[g, :lim.shape[0]] = lim
        ba = np.asarray(base[:MAX_CODE_BITS + 1], dtype=np.int64)
        bases[g, :ba.shape[0]] = ba
        pe = np.asarray(permute[:258], dtype=np.int32)
        perms[g, :pe.shape[0]] = pe
        mins[g] = min_len
        # lengths below min_len must never match
        limits[g, :min_len] = -1
    limits = np.clip(limits, -1, BIG_LIMIT).astype(np.int32)
    bases = np.clip(bases, -(1 << 28), BIG_LIMIT).astype(np.int32)
    return limits, bases, perms, mins


def payload_words(payload_bytes, n_words):
    """Payload bytes packed MSB-first into 32-bit words held in int64,
    zero-padded to n_words (bits past the data read as zero)."""
    cap = n_words * 4
    take = min(payload_bytes.shape[0], cap)
    q = torch.zeros(cap, dtype=torch.int64, device=payload_bytes.device)
    q[:take] = payload_bytes[:take]
    q = q.view(n_words, 4)
    return (q[:, 0] << 24) | (q[:, 1] << 16) | (q[:, 2] << 8) | q[:, 3]


def _window_vals(words, bit0, nbits):
    """val[p] = the MAX_CODE_BITS bits starting at bit bit0 + p of the
    words, as int32.  The uint32 word arithmetic runs in int64; the mask
    drops what the shift carries above bit 31, which uint32 would wrap."""
    p = torch.arange(nbits, device=words.device) + bit0
    w = p >> 5
    sh = p & 31
    padded = torch.cat([words, words.new_zeros(1)])
    left = padded[w]
    right = padded[w + 1]
    lo = torch.where(sh > 0, right >> ((32 - sh) & 31), 0)
    return ((((left << sh) & _MASK32) | lo)
            >> (32 - MAX_CODE_BITS)).to(torch.int32)


def _group_lengths(val, limits, mins):
    """(G, n) int32 code length at every offset under each group's
    table: the smallest L >= mins[g] with (val >> (W-L)) <= limits[g, L].
    Offsets where no code fits get MAX_CODE_BITS (the block CRC catches
    a walk that uses one)."""
    G = limits.shape[0]
    ln = torch.full((G, val.shape[0]), MAX_CODE_BITS, dtype=torch.int32,
                    device=val.device)
    # longest first, so the shortest fitting length is written last
    for L in range(MAX_CODE_BITS, 0, -1):
        j = (val >> (MAX_CODE_BITS - L))[None, :]
        ok = (j <= limits[:, L:L + 1]) & (mins <= L)[:, None]
        ln = torch.where(ok, L, ln)
    return ln


def _next_maps(payload_bytes, bit0, nbits_cap, limits, min_lens):
    """Plain version of `walk_maps`: (val, lens, nxt) -- the code window
    at every payload bit, each group's code length there, and the next
    symbol's bit nxt[g, p] = p + lens[g, p], clamped into the cap."""
    n_words = (nbits_cap + MAX_CODE_BITS + 31) // 32 + 1
    val = _window_vals(payload_words(payload_bytes, n_words), bit0,
                       nbits_cap)
    lens = _group_lengths(val, limits, min_lens)
    nxt = (torch.arange(nbits_cap, dtype=torch.int32,
                        device=payload_bytes.device)
           + lens).clamp_(0, nbits_cap - 1)
    return val, lens, nxt


def _power_k(nxt, k):
    """nxt composed k times (k divides 50): a squaring ladder, then the
    remaining powers combined largest first, each composition with the
    window [j, 20j] of its inner map nxt^j."""
    if k == 1:
        return nxt
    p = {1: nxt}
    kk = 1
    while 2 * kk <= k:
        p[2 * kk] = compose_windowed(p[kk], p[kk], kk, 20 * kk)
        kk *= 2
    out, need = None, k
    for kk in sorted(p, reverse=True):
        if kk <= need:
            out = p[kk] if out is None else compose_windowed(
                out, p[kk], kk, 20 * kk)
            need -= kk
    return out


def selector_chase_plain(F, sel, sub):
    """Plain version of `selector_chase`: the scalar loop on the host."""
    cap = F.shape[1]
    flat = F.reshape(-1).cpu().numpy()
    last = flat.shape[0] - 1
    out = np.empty(sel.shape[0], dtype=np.int32)
    p = 0
    for c, s in enumerate(sel.cpu().tolist()):
        out[c] = p
        row = s * cap
        for _ in range(sub):
            p = int(flat[min(max(row + p, 0), last)])
    return torch.from_numpy(out).to(F.device)


def selector_chase(F, sel, sub):
    """Start bit of every 50-symbol chunk: starting at p = 0, chunk c
    starts at p and then p <- F[sel[c], p], sub times (F = nxt^(50/sub)).
    F (G, cap) int32, sel (n,) int32 with n <= CHASE_MAX_SEL; returns
    (n,) int32.  The CUDA kernel (F staged through shared memory) for a
    CUDA tensor, the plain version for a CPU tensor."""
    if F.device.type == 'cpu':
        return selector_chase_plain(F, sel, sub)
    _cuda.require_cuda(F, 'selector_chase')
    if (F.dim() != 2 or sel.dim() != 1 or F.dtype != torch.int32
            or sel.dtype != torch.int32 or sel.device != F.device
            or not F.is_contiguous() or not sel.is_contiguous()
            or sub < 1 or sel.shape[0] > CHASE_MAX_SEL
            or F.shape[1] >= 1 << 31):
        raise ValueError('selector_chase takes a contiguous (G, cap < 2^31) '
                         'and (n <= %d,) int32 tensor on one device, '
                         'sub >= 1' % CHASE_MAX_SEL)
    G, cap = F.shape
    starts = torch.empty_like(sel)
    lib = _cuda.lib()
    _cuda.launches['selector_chase'] += 1
    _cuda.check(lib.cz_selector_chase(F.data_ptr(), sel.data_ptr(),
                                      starts.data_ptr(), G, cap,
                                      sel.shape[0], sub, None,
                                      _cuda.stream_handle(F.device)),
                'selector_chase')
    return starts


def _check_tables(what, dev, limits, min_lens, *more):
    """The decode tables a walk kernel takes: contiguous int32 on `dev`,
    limits (G, 22) and min_lens (G,) with 1 <= G <= 6, then each of `more`
    (tensor, its shape)."""
    G = limits.shape[0] if limits.dim() == 2 else 0
    want = [(limits, (G, MAX_CODE_BITS + 2)), (min_lens, (G,))]
    for t, shape in want + list(more):
        if (tuple(t.shape) != tuple(shape) or t.dtype != torch.int32
                or t.device != dev or not t.is_contiguous()
                or not 1 <= G <= MAX_GROUPS):
            raise ValueError('%s takes contiguous int32 tables on %s: '
                             'limits (G, %d), min_lens (G,), bases (G, %d), '
                             'permutes (G, 258), 1 <= G <= %d'
                             % (what, dev, MAX_CODE_BITS + 2,
                                MAX_CODE_BITS + 1, MAX_GROUPS))
    return G


def walk_maps(payload_bytes, bit0, nbits_cap, limits, min_lens):
    """Stage 1 of the walk: (val, nxt), the code window at every payload
    bit (nbits_cap,) and the next symbol's bit under each group's table,
    nxt[g, p] = min(p + len_g(p), nbits_cap - 1) (G, nbits_cap), both
    int32.  One launch of ``cz_walk_maps`` for a CUDA tensor (the lengths
    are not kept: `chunk_walk` recomputes the ones it needs); `_next_maps`
    for a CPU tensor."""
    if payload_bytes.device.type == 'cpu':
        val, _, nxt = _next_maps(payload_bytes, bit0, nbits_cap, limits,
                                 min_lens)
        return val, nxt
    _cuda.require_cuda(payload_bytes, 'walk_maps')
    dev = payload_bytes.device
    G = _check_tables('walk_maps', dev, limits, min_lens)
    if (payload_bytes.dim() != 1 or payload_bytes.dtype != torch.uint8
            or not payload_bytes.is_contiguous() or not 0 <= bit0 < 8
            or not 1 <= nbits_cap <= MAX_WALK_BITS):
        raise ValueError('walk_maps takes contiguous uint8 payload bytes, '
                         '0 <= bit0 < 8 and 1 <= nbits_cap <= 2^30')
    val = torch.empty(nbits_cap, dtype=torch.int32, device=dev)
    nxt = torch.empty((G, nbits_cap), dtype=torch.int32, device=dev)
    lib = _cuda.lib()
    _cuda.launches['walk_maps'] += 1
    _cuda.check(lib.cz_walk_maps(payload_bytes.data_ptr(),
                                 payload_bytes.shape[0], bit0, nbits_cap,
                                 limits.data_ptr(), min_lens.data_ptr(), G,
                                 val.data_ptr(), nxt.data_ptr(),
                                 _cuda.stream_handle(dev)), 'walk_maps')
    return val, nxt


def chunk_walk_plain(val, sel, starts, limits, bases, permutes, min_lens):
    """Plain version of `chunk_walk`: the chunks decode in lock-step, 50
    vector steps, each step's code length found at its offset under the
    chunk's group."""
    dev, nbits_cap, s_cap = val.device, val.shape[0], sel.shape[0]
    sel64 = sel.to(torch.int64).clamp(0, limits.shape[0] - 1)
    # each chunk's limits for L = 1..20; a length below min_len never fits
    L = torch.arange(1, MAX_CODE_BITS + 1, device=dev)
    lim = torch.where(L >= min_lens[:, None],
                      limits[:, 1:MAX_CODE_BITS + 1], -1)[sel64]
    base_off = sel64 * bases.shape[1]
    perm_w = permutes.shape[1]
    perm_off = sel64 * perm_w
    base_flat, perm_flat = bases.reshape(-1), permutes.reshape(-1)
    pos = torch.zeros(s_cap, dtype=torch.int64, device=dev)
    pos[:starts.shape[0]] = starts.clamp(0, nbits_cap - 1)
    syms = torch.empty((GROUP_SIZE, s_cap), dtype=torch.int32, device=dev)
    ends = torch.empty((GROUP_SIZE, s_cap), dtype=torch.int64, device=dev)
    for t in range(GROUP_SIZE):
        v = val[pos]
        fits = (v[:, None] >> (MAX_CODE_BITS - L)) <= lim
        ln = torch.where(fits, L, MAX_CODE_BITS).amin(1)
        j = (v >> (MAX_CODE_BITS - ln)) - base_flat[base_off + ln]
        syms[t] = perm_flat[perm_off + j.clamp(0, perm_w - 1)]
        ends[t] = pos + ln
        pos = ends[t].clamp(0, nbits_cap - 1)
    return syms.T.reshape(-1), ends.T.reshape(-1)


def chunk_walk(val, sel, starts, limits, bases, permutes, min_lens):
    """Stage 4 of the walk: each 50-symbol chunk c decodes from bit
    starts[c] (0 for c >= len(starts)) under group sel[c]'s table
    (clamped into [0, G)).  val (nbits_cap,) from `walk_maps`, sel
    (s_cap,), starts (<= s_cap,) int32; the tables as `huffman_walk_dev`
    takes them.  Returns (syms int32, ends int64), each (s_cap * 50,)
    chunk-major: every symbol and the bit just past it.  One launch of
    ``cz_chunk_walk`` for a CUDA tensor, `chunk_walk_plain` for a CPU
    tensor."""
    if val.device.type == 'cpu':
        return chunk_walk_plain(val, sel, starts, limits, bases, permutes,
                                min_lens)
    _cuda.require_cuda(val, 'chunk_walk')
    dev = val.device
    s_cap = sel.shape[0] if sel.dim() == 1 else -1
    G = _check_tables('chunk_walk', dev, limits, min_lens,
                      (bases, (limits.shape[0], MAX_CODE_BITS + 1)),
                      (permutes, (limits.shape[0], 258)))
    if (val.dim() != 1 or starts.dim() != 1
            or not 1 <= val.shape[0] <= MAX_WALK_BITS
            or not 1 <= s_cap <= CHASE_MAX_SEL
            or starts.shape[0] > s_cap
            or any(t.dtype != torch.int32 or t.device != dev
                   or not t.is_contiguous() for t in (val, sel, starts))):
        raise ValueError('chunk_walk takes contiguous int32 val (<= 2^30,), '
                         'sel (1..%d,) and starts (<= len(sel),) on one '
                         'device' % CHASE_MAX_SEL)
    n = s_cap * GROUP_SIZE
    syms = torch.empty(n, dtype=torch.int32, device=dev)
    ends = torch.empty(n, dtype=torch.int64, device=dev)
    lib = _cuda.lib()
    _cuda.launches['chunk_walk'] += 1
    _cuda.check(lib.cz_chunk_walk(val.data_ptr(), sel.data_ptr(),
                                  starts.data_ptr(), starts.shape[0],
                                  limits.data_ptr(), bases.data_ptr(),
                                  permutes.data_ptr(), min_lens.data_ptr(),
                                  G, val.shape[0], s_cap, syms.data_ptr(),
                                  ends.data_ptr(), _cuda.stream_handle(dev)),
                'chunk_walk')
    return syms, ends


@staged('ops.huffman_walk_dev')
def huffman_walk_dev(payload_bytes, bit0, nbits_cap, s_cap, limits, bases,
                     permutes, min_lens, selectors, n_selectors, eob):
    """Decode a bzip2 block's Huffman payload into its symbol stream.

    payload_bytes: uint8 tensor from the byte holding the first symbol
        bit; bit0 = that bit's offset in the byte.
    nbits_cap / s_cap: caps on payload bits and selector count.
    limits, bases, permutes, min_lens: `tables_for_device` output on the
        payload's device (``convert.decode_tables``).
    selectors: (>= s_cap,) int32 tensor of per-chunk groups;
        n_selectors and eob (the end-of-block symbol) are ints.

    Returns (syms int32[s_cap*50], count, end_bit): the symbol stream,
    the EOB's index (0-dim tensor) and the bit just past the EOB counted
    from payload_bytes' bit 0 (0-dim tensor)."""
    dev = payload_bytes.device
    val, nxt = walk_maps(payload_bytes, bit0, nbits_cap, limits, min_lens)
    F = _power_k(nxt, POWER_K_DEFAULT)
    sel = selectors[:s_cap].to(torch.int32).contiguous()
    # the chain stops at n_selectors: chunks past it lie past the EOB, and
    # start at bit 0
    starts = selector_chase(F, sel[:min(n_selectors, s_cap)],
                            GROUP_SIZE // POWER_K_DEFAULT)
    syms, ends = chunk_walk(val, sel, starts, limits, bases, permutes,
                            min_lens)
    valid = torch.arange(s_cap * GROUP_SIZE, device=dev) < \
        n_selectors * GROUP_SIZE
    count = torch.argmax(((syms == eob) & valid).to(torch.int32))
    return syms, count, ends[count.view(1)][0] + bit0


def bwt_column(syms, count, dbuf_cap, sym_to_byte):
    """RLE2 undo, MTF undo and the used-alphabet map: the block's BWT
    column U (uint8[dbuf_cap]) and its length (0-dim tensor).
    sym_to_byte: uint8 tensor of 256 entries."""
    idx, total = rle2_decode(syms, dbuf_cap, count)
    dense = mtf_decode(idx, dbuf_cap)
    return sym_to_byte[dense.to(torch.int64)], total


def block_bytes(U, cap, total, pidx, out_cap=None):
    """Inverse BWT and RLE1 undo of the BWT column U[:total] (total may
    be a 0-dim tensor) with origPtr pidx: (out uint8[out_cap], count);
    out_cap=None sizes the output to the exact byte count (one host
    sync)."""
    if not torch.is_tensor(pidx):
        stage_timer().add('host_syncs')     # pidx uploaded
    t0 = torch.as_tensor(pidx, device=U.device).clamp(max=total - 1)
    packed = inverse_bwt_block_masked(U, cap, total, t0)
    return rle1_decode_dev(packed, out_cap, total)


def decode_block_full_dev(payload_bytes, bit0, nbits_cap, s_cap, dbuf_cap,
                          out_cap, limits, bases, permutes, min_lens,
                          selectors, n_selectors, eob, sym_to_byte, pidx):
    """All-device bzip2 block decode: Huffman walk -> RLE2 undo -> MTF
    undo -> used-alphabet map (`bwt_column`) -> inverse BWT -> RLE1 undo
    (`block_bytes`).

    Returns (out uint8[out_cap], out_count, end_bit); out_cap=None sizes
    the output to the exact byte count (one host sync).  pidx is the
    block's origPtr.  A corrupt payload gives wrong bytes, which the
    caller's CRC check catches."""
    syms, count, end_bit = huffman_walk_dev(
        payload_bytes, bit0, nbits_cap, s_cap, limits, bases, permutes,
        min_lens, selectors, n_selectors, eob)
    U, total = bwt_column(syms, count, dbuf_cap, sym_to_byte)
    out, out_count = block_bytes(U, dbuf_cap, total, pidx, out_cap)
    return out, out_count, end_bit
