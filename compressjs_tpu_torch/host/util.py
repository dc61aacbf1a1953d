"""Container helpers, bit math and the model-driving loops of the host
codecs (a copy of ``compressjs_tpu.utils.util``).

The container is the magic, then the file size + 1 as a self-delimiting
big-endian varint (7 bits a byte, 0x80 on the last), whose last byte a
range-coded codec may fold into the coder's free first byte.  The entry
points the helpers build pass any keyword (``native_body``) on to the
codec's guts.
"""

from __future__ import annotations

import numpy as np

from .stream import EOF, coerce_input_stream, coerce_output_stream


def read_unsigned_number(input_stream):
    n = 0
    while True:
        c = input_stream.read_byte()
        if c & 0x80:
            return n + (c & 0x7F)
        n = (n + c) << 7


def varint_bytes(n):
    """The varint of n >= 0 as a list of ints."""
    assert n >= 0
    out = [n & 0x7F]
    n >>= 7
    while n != 0:
        out.append(n & 0x7F)
        n >>= 7
    out[0] |= 0x80
    return list(reversed(out))


def write_unsigned_number(output, n):
    """Write the varint of n >= 0 (`varint_bytes`) to `output`."""
    for b in varint_bytes(n):
        output.write_byte(b)


def fls(v):
    """Find-last-set: the position of the most significant set bit,
    fls(0) == 0, fls(1) == 1."""
    assert v >= 0
    return int(v).bit_length()


_BYTE_MSB = np.zeros(256, dtype=np.int32)
for _v in range(1, 256):
    _BYTE_MSB[_v] = _v.bit_length()


def fls_array(v):
    """`fls` of each element of an integer array (values < 2^62)."""
    v = np.asarray(v)
    work = v.astype(np.uint64).copy()
    shift = np.zeros(v.shape, dtype=np.int32)
    mask = work > 0xFFFFFFFF
    while mask.any():
        work = np.where(mask, work >> np.uint64(32), work)
        shift = shift + np.where(mask, 32, 0)
        mask = work > 0xFFFFFFFF
    w = work.astype(np.uint32)
    hi16 = (w >> np.uint32(16)).astype(np.int64)
    lo16 = (w & np.uint32(0xFFFF)).astype(np.int64)
    hi_res = np.where(hi16 > 0xFF,
                      24 + _BYTE_MSB[(hi16 >> 8) & 0xFF],
                      16 + _BYTE_MSB[hi16 & 0xFF])
    lo_res = np.where(lo16 > 0xFF,
                      8 + _BYTE_MSB[(lo16 >> 8) & 0xFF],
                      _BYTE_MSB[lo16 & 0xFF])
    return (shift + np.where(hi16 != 0, hi_res, lo_res)).astype(np.int32)


def log2c(v):
    """ceil(log2(v)); log2c(0) == -1."""
    return -1 if v == 0 else fls(v - 1)


def compress_file_helper(magic, guts, suppress_final_byte=False):
    """A compress_file(input, output=None, props=None) entry point that
    writes `magic` and the size varint, then calls
    guts(in_stream, out_stream, file_size, props, final_byte).  With
    suppress_final_byte the varint's last byte goes to guts (the range
    coder's free first byte) instead of the stream."""

    def compress_file(input_data, output=None, props=None, **opts):
        in_stream = coerce_input_stream(input_data)
        o = coerce_output_stream(output)
        out_stream = o.stream
        for ch in magic:
            out_stream.write_byte(ord(ch))
        file_size = in_stream.size \
            if getattr(in_stream, 'size', -1) >= 0 else -1
        vb = varint_bytes(file_size + 1)
        final_byte = None
        if suppress_final_byte:
            vb, final_byte = vb[:-1], vb[-1]
        for b in vb:
            out_stream.write_byte(b)
        guts(in_stream, out_stream, file_size, props, final_byte, **opts)
        return o.retval

    return compress_file


def decompress_file_helper(magic, guts):
    """A decompress_file(input, output=None) entry point that checks
    `magic`, reads the size varint and calls
    guts(in_stream, out_stream, file_size).  Raises ValueError on a bad
    magic, or where a caller's stream that counts its writes
    (``count``) received other than the declared size."""

    def decompress_file(input_data, output=None, **opts):
        in_stream = coerce_input_stream(input_data)
        for ch in magic:
            if ord(ch) != in_stream.read_byte():
                raise ValueError('Bad magic')
        file_size = read_unsigned_number(in_stream) - 1
        o = coerce_output_stream(output, file_size if file_size >= 0
                                 else None)
        guts(in_stream, o.stream, file_size, **opts)
        written = getattr(o.stream, 'count', None)
        if (output is not None and file_size >= 0 and written is not None
                and written != file_size):
            raise ValueError('output size does not match decoded input')
        return o.retval

    return decompress_file


def compress_with_model(in_stream, file_size, model):
    """Code the input's bytes through `model` (its encode), then the EOF
    symbol 256 where the size is unknown (-1) and the input ends."""
    in_size = 0
    while in_size != file_size:
        ch = in_stream.read_byte()
        if ch == EOF:
            model.encode(256)  # end of stream
            break
        model.encode(ch)
        in_size += 1


def decompress_with_model(out_stream, file_size, model):
    """Write `file_size` symbols of `model` (its decode), or, where the
    size is unknown, those before the EOF symbol 256."""
    out_size = 0
    while out_size != file_size:
        ch = model.decode()
        if ch == 256:
            break
        out_stream.write_byte(ch)
        out_size += 1
