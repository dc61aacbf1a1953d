"""The bzip2 block decode on the host (counterparts of
``compressjs_tpu.codecs.bzip2._read_block_header``, ``_decode_one_block``
and its Python symbol loop), for the parallel and mesh decoders.

`_read_block_header` tries the native runtime's whole-block parse and
symbol decode first.  Where that reports an anomaly it parses the
header again in Python (``host.bzip2_parse._parse_block_header``) and
decodes the symbols natively from there: that route reproduces the
reference's own errors, and its acceptance of degenerate blocks the
native parse refuses (an empty symbol map).  It is the reference's
semantics on the host, not a stand-in for the card.  `decode_symbols_plain`
is the Python symbol loop, the plain twin of the native one for the
tests.  Every format error raises ``ValueError``.
"""

from __future__ import annotations

import numpy as np

from .. import native
from .bits import SQRTPI, WHOLEPI
from .bwt import inverse_bwt
from .bzip2_parse import MAX_SYMBOLS, _parse_block_header
from .crc32 import crc32_bzip2
from .rle1 import rle1_decode


def _group_tables(groups):
    """The `_decode_tables` tuples of a block's groups as the native
    decoder's arrays: (minlen, maxlen, limit (G, 25), base (G, 22),
    permute (G, 258))."""
    g = len(groups)
    minlen = np.array([grp[0] for grp in groups], dtype=np.int32)
    maxlen = np.array([grp[1] for grp in groups], dtype=np.int32)
    limit = np.zeros((g, 25), dtype=np.int64)
    base = np.zeros((g, 22), dtype=np.int64)
    permute = np.zeros((g, MAX_SYMBOLS), dtype=np.int32)
    for i, (_, _, lim, bas, perm) in enumerate(groups):
        limit[i, :len(lim)] = lim
        base[i, :len(bas)] = bas
        permute[i, :len(perm)] = perm
    return minlen, maxlen, limit, base, permute


def decode_symbols(r, sym_to_byte, selectors, groups, dbuf_size):
    """Decode one block's symbols from r.pos (Huffman walk, RLE2 and MTF
    undo) with the native loop: the block's BWT column, with r.pos moved
    past its EOB code."""
    s2b = np.zeros(256, dtype=np.uint8)
    s2b[:len(sym_to_byte)] = sym_to_byte
    dbuf, r.pos = native.bz2_decode_block(
        r.data, r.pos, np.array(selectors, dtype=np.uint8),
        *_group_tables(groups), len(sym_to_byte), s2b, dbuf_size)
    return dbuf


def decode_symbols_plain(r, sym_to_byte, selectors, groups, dbuf_size):
    """Plain twin of `decode_symbols`: the reference's symbol loop, one
    code at a time."""
    sym_total = len(sym_to_byte)
    dbuf = np.empty(dbuf_size, dtype=np.uint8)
    mtf_syms = list(range(256))
    run_pos = t_acc = dbuf_count = selector_idx = sym_budget = 0
    read_bits = r.read_bits
    while True:
        if not sym_budget:
            sym_budget = native.GROUP_SIZE
            if selector_idx >= len(selectors):
                raise ValueError('Data error: selectors exhausted')
            min_len, max_len, limit, base, permute = groups[
                selectors[selector_idx]]
            selector_idx += 1
        sym_budget -= 1
        i = min_len
        j = read_bits(i)
        while j > limit[i]:
            i += 1
            if i > max_len:
                raise ValueError('Data error: bad Huffman code')
            j = (j << 1) | read_bits(1)
        j -= base[i]
        if j < 0 or j >= MAX_SYMBOLS:
            raise ValueError('Data error: bad Huffman code')
        next_sym = permute[j]
        if next_sym <= 1:  # RUNA / RUNB
            if not run_pos:
                run_pos = 1
                t_acc = 0
            t_acc += run_pos if next_sym == 0 else 2 * run_pos
            run_pos <<= 1
            continue
        if run_pos:
            run_pos = 0
            if dbuf_count + t_acc > dbuf_size:
                raise ValueError('Data error: run past the block')
            dbuf[dbuf_count:dbuf_count + t_acc] = sym_to_byte[mtf_syms[0]]
            dbuf_count += t_acc
        if next_sym > sym_total:  # EOB
            break
        if dbuf_count >= dbuf_size:
            raise ValueError('Data error: block overflow')
        uc = mtf_syms.pop(next_sym - 1)
        mtf_syms.insert(0, uc)
        dbuf[dbuf_count] = sym_to_byte[uc]
        dbuf_count += 1
    return dbuf[:dbuf_count]


def _read_block_header(r, dbuf_size):
    """Parse and symbol-decode the block at r.pos (its magic): (BWT
    column, origPtr, block CRC), or None at the end-of-stream magic, with
    r.pos after the block's EOB code."""
    h = r.read_bits(48)
    if h == SQRTPI:
        return None
    if h != WHOLEPI:
        raise ValueError('not bzip2 data: bad block magic')
    target_crc = r.read_bits(32)
    res = native.bz2_block_full(r.data, r.pos, dbuf_size)
    if res is not None:
        dbuf, orig_pointer, r.pos = res
        return dbuf, orig_pointer, target_crc
    orig_pointer, sym_to_byte, selectors, groups = _parse_block_header(
        r, dbuf_size)
    dbuf = decode_symbols(r, sym_to_byte, selectors, groups, dbuf_size)
    if orig_pointer >= dbuf.shape[0]:
        raise ValueError('Data error: origPtr past the block')
    return dbuf, orig_pointer, target_crc


def _decode_one_block(r, dbuf_size):
    """Decode the block at r.pos to its bytes: (bytes uint8, block CRC),
    or None at the end-of-stream magic.  Raises ValueError on a bad
    block CRC."""
    res = _read_block_header(r, dbuf_size)
    if res is None:
        return None
    dbuf, orig_pointer, target_crc = res
    out = rle1_decode(inverse_bwt(dbuf, orig_pointer))
    crc = crc32_bzip2(out)
    if crc != target_crc:
        raise ValueError('bad block CRC (got %x expected %x)'
                         % (crc, target_crc))
    return out, target_crc
