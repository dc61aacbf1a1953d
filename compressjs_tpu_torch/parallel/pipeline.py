"""bzip2 encoder with the whole block encode on the GPU (counterpart of
``compressjs_tpu.parallel.pipeline`` in mode ``'full'``).

The host packs RLE1 blocks and computes their CRCs, the device runs each
block's sort, BWT, MTF, RLE2, group optimisation and payload packing
(``ops.device_entropy.encode_block_full``), and the host writes the
block headers from the small matrices it downloads with the payload.
Every block, the short tail included, takes the device path.  Output is
byte-identical to ``compressjs_tpu.codecs.bzip2.compress_file``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import block_inputs
from ..host.bits import SQRTPI, WHOLEPI, BitArrayWriter, BitWriter
from ..host.crc32 import crc32_bzip2, stream_crc_combine
from ..host.huffman_headers import emit_table_deltas, selector_mtf_bits
from ..host.rle1 import rle1_encode
from ..ops.device_entropy import GROUP_SIZE, encode_block_full


def _split_blocks(data, block_size):
    """Host RLE1 pass: list of (packed_block, crc)."""
    out = []
    start = 0
    n = data.shape[0]
    while start < n:
        block, consumed = rle1_encode(data, start, block_size)
        if block.shape[0] == 0 or consumed == 0:
            break
        out.append((block, crc32_bzip2(data[start:start + consumed])))
        # mid-stream blocks may be short of block_size (the RLE1
        # count-byte back-off defers a byte), so stop by input position
        start += consumed
    return out


def _block_meta(block):
    """(used-byte mask, alphabet size, byte -> dense symbol remap)."""
    used = np.zeros(256, dtype=bool)
    used[block] = True
    alphabet = np.nonzero(used)[0]
    remap = np.zeros(256, dtype=np.int32)
    remap[alphabet] = np.arange(len(alphabet))
    return used, len(alphabet), remap


def _device_block_header(pidx, lens, n_groups, sel, count, alphabet_size,
                         used):
    """Block header bits after the block CRC: randomised flag, pidx,
    used-byte bitmap, group count, selectors and length tables."""
    nvc = (count + GROUP_SIZE - 1) // GROUP_SIZE
    m = alphabet_size + 2
    w = BitArrayWriter()
    w.write_bit(0)  # not randomised
    w.write_bits(24, int(pidx))
    compact = used.reshape(16, 16).any(axis=1)
    for i in range(16):
        w.write_bit(bool(compact[i]))
    for i in range(16):
        if compact[i]:
            for j in range(16):
                w.write_bit(bool(used[(i << 4) | j]))
    w.write_bits(3, n_groups)
    w.write_bits(15, nvc)
    w.append(selector_mtf_bits(sel[:nvc], n_groups))
    for g in range(n_groups):
        w.append(emit_table_deltas(lens[g, :m]))
    return w.bits()


class DeviceBzip2Encoder:
    """bzip2 encoder whose block encode runs on `device` ('cuda' unless
    the caller asks for 'cpu'; the CPU runs every kernel's plain
    version)."""

    def __init__(self, level=9, device='cuda'):
        if not 1 <= level <= 9:
            raise ValueError('Invalid block size multiplier')
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('DeviceBzip2Encoder: CUDA is not available; '
                               "pass device='cpu' to run on the CPU")
        self.level = level
        self.block_size = level * 100000 - 19

    def encode_block(self, block):
        """One RLE1 block -> header bits and (payload bytes, bit count)."""
        used, alphabet_size, remap = _block_meta(block)
        eob = alphabet_size + 1
        blk, remap_t, eob = block_inputs(block, remap, eob, self.device)
        pidx, payload, bits, lens, g, sel, count, _ = encode_block_full(
            blk, block.shape[0], remap_t, eob)
        header = _device_block_header(int(pidx), lens.cpu().numpy(), g,
                                      sel.cpu().numpy(), count,
                                      alphabet_size, used)
        return header, payload.cpu().numpy(), bits

    def compress(self, data, output=None):
        """Compress bytes-like or uint8 `data`.  Returns the stream as
        bytes, or writes it to `output` (a binary file object) and
        returns `output`."""
        data = np.frombuffer(bytes(data), dtype=np.uint8) \
            if not isinstance(data, np.ndarray) \
            else np.ascontiguousarray(data, dtype=np.uint8)
        out = BitWriter()
        out.write_bits(32, int.from_bytes(b'BZh' + bytes([48 + self.level]),
                                          'big'))
        stream_crc = 0
        for block, crc in _split_blocks(data, self.block_size):
            header, payload, bits = self.encode_block(block)
            stream_crc = stream_crc_combine(stream_crc, crc)
            out.write_bits(48, WHOLEPI)
            out.write_bits(32, crc)
            out.write_bit_array(header)
            out.write_bit_array(np.unpackbits(payload, count=bits))
        out.write_bits(48, SQRTPI)
        out.write_bits(32, stream_crc)
        result = out.getvalue()
        if output is None:
            return result
        output.write(result)
        return output


def compress_file_device(data, output=None, level=9, device='cuda'):
    """bzip2-compress `data` with the block encode on `device`."""
    return DeviceBzip2Encoder(level, device).compress(data, output)
