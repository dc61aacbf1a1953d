"""bzip2 block-header fields derived from the Huffman tables: the
delta-coded code-length tables and the MTF'd unary selectors."""

from __future__ import annotations

import numpy as np


def emit_table_deltas(code_lengths):
    """Delta-coded length table bits: 5-bit start, then per symbol 2-bit
    inc (10) / dec (11) steps and a 0 stop bit.  Returns uint8 0/1."""
    bits = []
    current = int(code_lengths[0])
    for i in range(4, -1, -1):
        bits.append((current >> i) & 1)
    for length in code_lengths:
        length = int(length)
        step = [1, 0] if current < length else [1, 1]
        for _ in range(abs(length - current)):
            bits.extend(step)
        bits.append(0)
        current = length
    return np.array(bits, dtype=np.uint8)


def selector_mtf_bits(selectors, n_groups):
    """Selectors move-to-front coded, then unary coded."""
    lst = list(range(n_groups))
    bits = []
    for s in selectors:
        s = int(s)
        j = lst.index(s)
        if j:
            del lst[j]
            lst.insert(0, s)
        bits.extend([1] * j)
        bits.append(0)
    return np.array(bits, dtype=np.uint8)
