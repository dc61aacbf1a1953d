"""Byte- and bit-oriented host streams of the BWTC codec (a copy of the
parts of ``compressjs_tpu.utils.stream`` that the codec and its models
use).

EOF is -1, bits are big-endian, and reads past the end give EOF (bytes)
or zero bits.  `ArrayInputStream` and `BufferStream` move whole numpy
arrays, so a block codec reads and writes a block in one call.
"""

from __future__ import annotations

import numpy as np

EOF = -1


class Stream:
    """Abstract byte stream.  Subclasses override read_byte/write_byte or
    the bulk read/write; each defaults to the other."""

    def read_byte(self):
        buf = bytearray(1)
        if self.read(buf, 0, 1) == 0:
            return EOF
        return buf[0]

    def read(self, buf, buf_offset, length):
        bytes_read = 0
        while bytes_read < length:
            ch = self.read_byte()
            if ch == EOF:
                break
            buf[buf_offset + bytes_read] = ch
            bytes_read += 1
        return bytes_read

    def write_byte(self, byte):
        self.write(bytes([byte & 0xFF]), 0, 1)

    def write(self, buf, buf_offset, length):
        for i in range(length):
            self.write_byte(buf[buf_offset + i])
        return length

    def flush(self):
        pass


class ArrayInputStream(Stream):
    """Read from a bytes-like object or uint8 array, with known size."""

    def __init__(self, data):
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data, dtype=np.uint8)
        else:
            data = np.frombuffer(bytes(data), dtype=np.uint8)
        self.data = data
        self.size = int(data.shape[0])
        self.pos = 0

    def read_byte(self):
        if self.pos >= self.size:
            return EOF
        b = int(self.data[self.pos])
        self.pos += 1
        return b

    def read(self, buf, buf_offset, length):
        n = min(length, self.size - self.pos)
        if n <= 0:
            return 0
        chunk = self.data[self.pos:self.pos + n]
        if isinstance(buf, np.ndarray):
            buf[buf_offset:buf_offset + n] = chunk
        else:
            buf[buf_offset:buf_offset + n] = chunk.tobytes()
        self.pos += n
        return n

    def read_array(self, length):
        """Up to `length` bytes as a uint8 array (a view)."""
        n = min(length, self.size - self.pos)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


class BufferStream(Stream):
    """Growable output buffer backed by numpy.  With resize_ok=False it
    holds exactly `initial_size` bytes, and writing past them (or
    reading back fewer) raises TypeError."""

    def __init__(self, initial_size=16384, resize_ok=True):
        size = max(int(initial_size), 16) if resize_ok else int(initial_size)
        self.buffer = np.zeros(size, dtype=np.uint8)
        self.pos = 0
        self.resize_ok = resize_ok

    def _ensure(self, extra):
        need = self.pos + extra
        if need > self.buffer.shape[0]:
            if not self.resize_ok:
                raise TypeError('output size does not match decoded input')
            nb = np.zeros(max(need, self.buffer.shape[0] * 2),
                          dtype=np.uint8)
            nb[:self.pos] = self.buffer[:self.pos]
            self.buffer = nb

    def write_byte(self, byte):
        self._ensure(1)
        self.buffer[self.pos] = byte & 0xFF
        self.pos += 1

    def write(self, buf, buf_offset, length):
        self._ensure(length)
        src = buf[buf_offset:buf_offset + length]
        if not isinstance(src, np.ndarray):
            src = np.frombuffer(bytes(src), dtype=np.uint8)
        self.buffer[self.pos:self.pos + length] = src
        self.pos += length
        return length

    def write_array(self, arr):
        arr = np.asarray(arr, dtype=np.uint8)
        self._ensure(arr.shape[0])
        self.buffer[self.pos:self.pos + arr.shape[0]] = arr
        self.pos += arr.shape[0]

    def get_buffer(self):
        if self.pos != self.buffer.shape[0] and not self.resize_ok:
            raise TypeError('output size does not match decoded input')
        return self.buffer[:self.pos]


def coerce_input_stream(data):
    """A stream (returned as is), or bytes-like data / a uint8 array
    wrapped in an `ArrayInputStream`."""
    if hasattr(data, 'read_byte'):
        return data
    return ArrayInputStream(data)


class _OutputWrapper:
    def __init__(self, stream, user_supplied):
        self.stream = stream
        self._user = user_supplied

    @property
    def retval(self):
        """What the codec returns: the caller's stream, else the bytes
        written."""
        if self._user is not None:
            return self._user
        return self.stream.get_buffer()


def coerce_output_stream(output, size=None):
    """Wrap the caller's stream, or a new `BufferStream` (of exactly
    `size` bytes where the size is known)."""
    if output is not None and hasattr(output, 'write_byte'):
        return _OutputWrapper(output, output)
    if size is not None and size >= 0:
        return _OutputWrapper(BufferStream(size, resize_ok=False), None)
    return _OutputWrapper(BufferStream(), None)


class BitStream:
    """Big-endian bit I/O over a byte stream, with independent read and
    write buffers; reads past EOF give zero bits."""

    def __init__(self, stream):
        self.stream = stream
        self._rbuf = 0x100  # read buffer sentinel
        self._wbuf = 1      # write buffer sentinel

    def read_bit(self):
        if (self._rbuf & 0xFF) == 0:
            ch = self.stream.read_byte()
            if ch == EOF:
                return ch
            self._rbuf = ((ch << 1) | 1) & 0x1FF
        bit = 1 if (self._rbuf & 0x100) else 0
        self._rbuf = (self._rbuf << 1) & 0x1FF
        return bit

    def read_bits(self, n):
        r = 0
        for _ in range(n):
            r <<= 1
            if self.read_bit() > 0:  # EOF yields zero bits
                r += 1
        return r

    def write_bit(self, b):
        self._wbuf = (self._wbuf << 1) | (1 if b else 0)
        if self._wbuf & 0x100:
            self.stream.write_byte(self._wbuf & 0xFF)
            self._wbuf = 1

    def write_bits(self, n, value):
        for i in range(n - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def flush(self):
        while self._wbuf != 1:
            self.write_bit(0)
        self.stream.flush()
