"""BWTC-L block encode and decode with every stage on the device
(counterpart of ``compressjs_tpu.ops.device_lane``).

The batched model and coder run at their design point here: 128 lanes a
block, so every scan step advances 128 independent model and coder
chains.  Per block:

encode: EOF BWT -> MTF -> RLE2 -> round-robin lane split ->
        fenwick_code_streams (model and coder) -> token_bytes ->
        ragged_concat (one download)
decode: lane bytes -> fenwick_decode_streams -> interleave -> RLE2 undo ->
        MTF undo -> inverse EOF BWT

Byte for byte the host codec's (``host.bwtcl``).  On the card the MTF
stages, the model and the coder are kernels (``csrc/mtf_scan.cu``,
``mtf_undo.cu``, ``fenwick_encode.cu``'s fused entry,
``fenwick_decode.cu``); on the CPU their plain versions run.
"""

from __future__ import annotations

import torch

from . import block_decode as bd
from . import block_kernels as bk
from . import device_coder as dc
from . import device_model as dm

F_PROB_MAX = 0xFF00
F_PROB_INCR = 0x0100
MAX_N = 258          # the Fenwick trees' width: asize + 2 <= 258


def lane_caps(bs, lanes):
    """(T, tok_cap, lane_byte_cap) of a block of bs bytes over `lanes`:
    steps a lane, tokens a lane (each of a symbol's 2 triple slots emits
    at most one, plus the 5 of the finish) and bytes a lane."""
    T = -(-(bs + 1) // lanes)
    return T, 2 * T + 8, 3 * T + 64


def ragged_concat(byts, lens, out_cap):
    """The L rows of byts (L, W) uint8, each its first lens[l] bytes, end
    to end: ((out_cap,) uint8, total), so that a block's lane bytes
    download in one transfer.  Each output byte finds its row by a
    searchsorted in the rows' end offsets."""
    L, W = byts.shape
    lens = lens.to(torch.int64)
    ends = torch.cumsum(lens, 0)
    total = ends[-1]
    slots = torch.arange(out_cap, device=byts.device)
    row = torch.searchsorted(ends, slots, right=True).clamp_(max=L - 1)
    pos = (slots - (ends[row] - lens[row])).clamp(0, W - 1)
    val = byts.reshape(-1)[row * W + pos]
    return torch.where(slots < total, val, 0).to(torch.uint8), total


def _lane_valid(T, lanes, S, device):
    """(lanes, T) bool: slot t of lane l is symbol t * lanes + l < S."""
    slot = (torch.arange(T, device=device)[None, :] * lanes +
            torch.arange(lanes, device=device)[:, None])
    return slot < S


def encode_block_lanes(block, bs, lanes, remap, asize):
    """One BWTC-L block of bs bytes (uint8 tensor), every stage on its
    device.  remap: (256,) int64 byte -> dense symbol; asize: the used
    alphabet's size.  Returns (pidx + 1, S, lane_lens (lanes,), flat
    bytes (cap,), total_bytes, max_tok) as tensors; max_tok > tok_cap,
    total > cap or a lane past lane_byte_cap marks an overflow (the
    caller takes the host path)."""
    T, tok_cap, lane_cap = lane_caps(bs, lanes)
    dev = block.device
    U, pidx = bk.bwt_eof_block(block, bs)
    dense = remap[U.to(torch.int64)].to(torch.int32)
    mtf = bk.mtf_encode(dense, bs)
    syms, cnt, _ = bk.rle2_encode(mtf, bs, 0)
    S = cnt - 1                       # without bzip2's EOB slot
    padded = torch.zeros(T * lanes, dtype=torch.int32, device=dev)
    padded[:bs + 1] = syms.to(torch.int32)
    lanemat = padded.view(T, lanes).T.contiguous()     # lane l, slot t
    Ns = torch.full((lanes,), asize + 2, dtype=torch.int32, device=dev)
    zeros = torch.zeros(lanes, dtype=torch.int64, device=dev)
    tokens, tok_n, nbytes = dm.fenwick_code_streams(
        lanemat, _lane_valid(T, lanes, S, dev), Ns, MAX_N, F_PROB_MAX,
        F_PROB_INCR, dc.encoder_states(zeros, zeros), tok_cap)
    byts, lens = dc.token_bytes(tokens, tok_n, nbytes, lane_cap)
    flat, total = ragged_concat(byts, lens, bs + (bs >> 1) + 4096)
    return pidx, S, lens, flat, total, tok_n.max()


def decode_block_lanes(paymat, bs, lanes, S, pidx, asize, sym_map):
    """Invert `encode_block_lanes`: paymat (lanes, lane_byte_cap) uint8,
    each row one lane's stream, zero-padded; S the symbol count; pidx
    the transform's pidx + 1; sym_map (256,) int64 dense symbol -> byte.
    Returns (the block's bytes uint8[bs], the RLE2 expansion's length)."""
    T = lane_caps(bs, lanes)[0]
    dev = paymat.device
    low, rng, buf, pos = dc.dec_start_state(
        paymat, torch.ones(lanes, dtype=torch.int64, device=dev))
    state = torch.stack([low, rng, buf, pos], 1)
    Ns = torch.full((lanes,), asize + 2, dtype=torch.int32, device=dev)
    symmat, _ = dm.fenwick_decode_streams(
        paymat, state, Ns, MAX_N, F_PROB_MAX, F_PROB_INCR,
        _lane_valid(T, lanes, S, dev))
    flat = symmat.T.reshape(-1)                   # slot t * lanes + l
    flat = torch.where(torch.arange(T * lanes, device=dev) < S, flat, 2)
    mtf_idx, total = bd.rle2_decode(flat.to(torch.int16), bs, S)
    U = sym_map[bd.mtf_decode(mtf_idx, bs).to(torch.int64)]
    return bd.inverse_bwt_eof_block(U.to(torch.uint8), bs, pidx), total
