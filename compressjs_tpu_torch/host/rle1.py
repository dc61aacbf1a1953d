"""bzip2's RLE1 block fill (runs of 4 identical bytes followed by a
count byte 0-251).

`rle1_encode` runs the native runtime's byte loop every time.
`rle1_encode_plain` is its plain twin for the tests: the same
semantics, including the lazy count-byte emission and its interaction
with block-boundary cuts, as run-segmented numpy array math.
"""

from __future__ import annotations

import numpy as np

from .. import native


def run_lengths(data):
    """(values, lengths) run-length encoding of a uint8 array."""
    data = np.asarray(data)
    n = data.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.int64)
    starts = np.ones(n, dtype=bool)
    starts[1:] = data[1:] != data[:-1]
    idx = np.nonzero(starts)[0]
    return data[idx], np.diff(np.append(idx, n))


def _rle1_out_len(lengths):
    """Output bytes of a fully emitted run: pieces of <= 255 input bytes;
    a piece of p >= 4 costs 5 output bytes (4 literals + count), p < 4
    costs p."""
    k = lengths // 255
    r = lengths % 255
    return 5 * k + np.where(r < 4, r, 5)


def rle1_encode(data, start, block_size):
    """Pack input bytes from data[start:] until block_size output bytes
    are produced or the input ends.

    Returns (block, consumed): the packed uint8 block (len <= block_size)
    and the count of input bytes used."""
    data = np.asarray(data)
    if data.shape[0] - start <= 0:
        return np.zeros(0, dtype=np.uint8), 0
    return native.rle1_encode(data[start:], block_size)


def rle1_encode_plain(data, start, block_size):
    """Plain twin of `rle1_encode` (numpy), a copy of the JAX package's
    numpy path.  Where the input ends on a 4-run with one block byte
    left, the native loop writes the count byte there and this does not.
    The JAX package takes its numpy path only for the last 4,096 input
    bytes or fewer, which never fill a block of 99,981 bytes or more, so
    its encoder and this package's agree; the tests hold each twin to
    its JAX counterpart."""
    data = np.asarray(data)
    avail = data.shape[0] - start
    if avail <= 0:
        return np.zeros(0, dtype=np.uint8), 0
    # RLE1 output ~= input except on run-heavy data (5 output bytes can
    # consume up to 255 input): start near block_size and grow only when
    # the window's total output underfills the block
    wsize = block_size + 4096
    while True:
        window = data[start:start + wsize]
        vals, lens = run_lengths(window)
        if window.shape[0] >= avail:
            break
        if int(_rle1_out_len(lens).sum()) > block_size:
            break
        wsize *= 8
    out_lens = _rle1_out_len(lens)
    cum_out = np.cumsum(out_lens)
    cum_in = np.cumsum(lens)
    nfit = int(np.searchsorted(cum_out, block_size, side='right'))
    # a run whose output ends exactly at the block boundary may still be
    # cut there (a count byte written as the final block byte ends the
    # loop before its extras are consumed): take the partial-run path
    if nfit > 0 and int(cum_out[nfit - 1]) == block_size:
        nfit -= 1
    out_parts = []
    consumed = int(cum_in[nfit - 1]) if nfit > 0 else 0
    emitted = int(cum_out[nfit - 1]) if nfit > 0 else 0
    if nfit > 0:
        out_parts.append(_emit_full_runs(vals[:nfit], lens[:nfit],
                                         emitted))
    if nfit < len(vals) and emitted < block_size:
        part, used = _emit_partial_run(int(vals[nfit]), int(lens[nfit]),
                                       block_size - emitted)
        out_parts.append(part)
        consumed += used
    block = (np.concatenate(out_parts) if out_parts
             else np.zeros(0, dtype=np.uint8))
    return block, consumed


def _emit_full_runs(vals, lens, total_out):
    """Emit fully fitting runs via piece decomposition: each run splits
    into <= 255-input pieces; a piece of p >= 4 input bytes emits
    [v, v, v, v, p-4], a shorter piece emits p literals."""
    k = lens // 255
    r = lens % 255
    if ((k == 0) & (r < 4)).all():
        return np.repeat(vals, lens.astype(np.int64))
    pieces_per_run = k + (r > 0)
    run_id = np.repeat(np.arange(len(vals)), pieces_per_run)
    within = _within_positions(pieces_per_run)
    piece_in = np.where(within < k[run_id], 255, r[run_id])
    piece_v = vals[run_id]
    piece_out = np.where(piece_in >= 4, 5, piece_in)
    lit = np.minimum(piece_in, 4)
    po = np.cumsum(piece_out) - piece_out
    out = np.empty(total_out, dtype=np.uint8)
    out[_segment_positions(po, lit)] = np.repeat(piece_v, lit)
    counted = piece_in >= 4
    out[po[counted] + 4] = (piece_in[counted] - 4).astype(np.uint8)
    if int(piece_out.sum()) != total_out:
        raise ValueError('RLE1 piece sizes do not add up to the block')
    return out


def _emit_partial_run(v, L, cap):
    """Emit as much of a run of `v` (length L) as fits in cap output
    bytes, with the reference loop's cut semantics: literals are
    capacity-checked per byte; a count byte needs one slot at loop top;
    the counted extras consume input without consuming output space.
    Returns (bytes, used_input)."""
    out = []
    used = 0
    remaining = L
    dangling = False
    while remaining > 0:
        lit = min(remaining, 4)
        take = min(lit, cap)
        out.extend([v] * take)
        cap -= take
        used += take
        remaining -= take
        if take < lit or remaining == 0:
            dangling = take == 4 and cap == 0
            break
        if cap == 0:
            dangling = True
            break
        cap -= 1
        if cap == 0:
            # the count byte is the final block byte: the loop ends right
            # after writing it, before any extra is read
            out.append(0)
            break
        extras = min(remaining, 251)
        out.append(extras)
        used += extras
        remaining -= extras
    if dangling:
        # never end the block with a 4-run whose count byte did not fit:
        # C bzip2 reads the count from the same block, so defer the 4th
        # byte to the next block
        out.pop()
        used -= 1
    return np.array(out, dtype=np.uint8), used


def _segment_positions(offsets, lengths):
    """Flat output indices for segments given start offsets and lengths."""
    if int(lengths.sum()) == 0:
        return np.zeros(0, dtype=np.int64)
    seg_ids = np.repeat(np.arange(len(lengths)), lengths)
    return offsets[seg_ids] + _within_positions(lengths)


def _within_positions(lengths):
    total = int(np.sum(lengths))
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(lengths)
    return np.arange(total) - np.repeat(ends - lengths, lengths)
