"""Byte- and bit-oriented host streams (a copy of
``compressjs_tpu.utils.stream``).

EOF is -1, bits are big-endian, and reads past the end give EOF (bytes)
or zero bits.  `ArrayInputStream` and `BufferStream` move whole numpy
arrays (``read_array``, ``write_array``), so a codec reads and writes a
block in one call, and the codecs give their native bodies exactly such
streams.  `FileOutputStream` writes through to a binary file in
O(buffer) memory (the command line's sink); `BitStream` adds bit I/O and
the bit-addressed seeks of bzip2's block extraction.
"""

from __future__ import annotations

import numpy as np

EOF = -1


class Stream:
    """Abstract byte stream.  Subclasses override read_byte/write_byte or the
    bulk read/write; each defaults to the other."""

    _eof = False

    # -- reading -----------------------------------------------------------
    def read_byte(self):
        buf = bytearray(1)
        n = self.read(buf, 0, 1)
        if n == 0:
            self._eof = True
            return EOF
        return buf[0]

    def read(self, buf, buf_offset, length):
        bytes_read = 0
        while bytes_read < length:
            ch = self.read_byte()
            if ch == EOF:
                self._eof = True
                break
            buf[buf_offset + bytes_read] = ch
            bytes_read += 1
        return bytes_read

    def eof(self):
        return bool(self._eof)

    def seek(self, pos):
        raise IOError('Stream is not seekable.')

    def tell(self):
        raise IOError('Stream is not seekable.')

    # -- writing -----------------------------------------------------------
    def write_byte(self, byte):
        self.write(bytes([byte & 0xFF]), 0, 1)

    def write(self, buf, buf_offset, length):
        for i in range(length):
            self.write_byte(buf[buf_offset + i])
        return length

    def flush(self):
        pass


Stream.EOF = EOF


class ArrayInputStream(Stream):
    """Read from a bytes-like / uint8 ndarray, seekable, with known size."""

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
        """Bulk read up to `length` bytes as a uint8 array (framework
        extension; lets block codecs slurp whole blocks without a loop)."""
        n = min(length, self.size - self.pos)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def seek(self, pos):
        self.pos = pos
        self._eof = False

    def tell(self):
        return self.pos

    def eof(self):
        return self.pos >= self.size


class BufferStream(Stream):
    """Growable output buffer backed by numpy, with O(1) amortized appends
    and vectorized bulk writes."""

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
            newsize = max(need, self.buffer.shape[0] * 2)
            nb = np.zeros(newsize, dtype=np.uint8)
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

    def tell(self):
        return self.pos


def coerce_input_stream(data):
    """Accept a stream, bytes, bytearray, memoryview, list, or uint8 array
    and return an input stream (reference contract: Util.js:9-51)."""
    if hasattr(data, 'read_byte'):
        return data
    return ArrayInputStream(data)


class _OutputWrapper:
    def __init__(self, stream, user_supplied):
        self.stream = stream
        self._user = user_supplied

    @property
    def retval(self):
        if self._user is not None:
            return self._user
        return self.stream.get_buffer()


class FileOutputStream(Stream):
    """Write-through to a binary file object with an internal buffer.

    Framework extension: lets the CLI stream codec output to disk in
    O(buffer) memory instead of materializing the whole result (the
    reference CLI buffers entire files).  Call flush() when done."""

    def __init__(self, fileobj, bufsize=1 << 20):
        self.f = fileobj
        self._buf = bytearray()
        self._bufsize = bufsize
        self.count = 0

    def write_byte(self, byte):
        self._buf.append(byte & 0xFF)
        self.count += 1
        if len(self._buf) >= self._bufsize:
            self.f.write(self._buf)
            self._buf = bytearray()

    def write(self, buf, buf_offset, length):
        chunk = buf[buf_offset:buf_offset + length]
        if isinstance(chunk, np.ndarray):
            chunk = chunk.tobytes()
        self._buf += bytes(chunk)
        self.count += length
        if len(self._buf) >= self._bufsize:
            self.f.write(self._buf)
            self._buf = bytearray()
        return length

    def write_array(self, arr):
        return self.write(arr, 0, len(arr))

    def flush(self):
        if self._buf:
            self.f.write(self._buf)
            self._buf = bytearray()
        self.f.flush()


def coerce_output_stream(output, size=None):
    """Accept a stream or None; return wrapper with .stream and .retval
    (reference contract: Util.js:85-103)."""
    if output is not None and hasattr(output, 'write_byte'):
        return _OutputWrapper(output, output)
    if size is not None and size >= 0:
        return _OutputWrapper(BufferStream(size, resize_ok=False), None)
    return _OutputWrapper(BufferStream(), None)


class BitStream:
    """Big-endian bit I/O over a byte stream (reference:
    lib/BitStream.js:5-105).  Independent read and write buffer bytes; reads
    past EOF return zero bits; seek_bit/tell_bit give the bit-addressed
    random access that powers bzip2 block extraction."""

    EOF = EOF

    def __init__(self, stream):
        self.stream = stream
        self._rbuf = 0x100  # read buffer sentinel
        self._wbuf = 1      # write buffer sentinel
        self._eof = False

    # -- bit reading -------------------------------------------------------
    def read_bit(self):
        if (self._rbuf & 0xFF) == 0:
            ch = self.stream.read_byte()
            if ch == EOF:
                self._eof = True
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

    def seek_bit(self, pos):
        n_byte = pos >> 3
        n_bit = pos - n_byte * 8
        self.seek(n_byte)
        self._eof = False
        self.read_bits(n_bit)

    def tell_bit(self):
        pos = self.stream.tell() * 8
        b = self._rbuf
        while (b & 0xFF) != 0:
            pos -= 1
            b = (b << 1) & 0x1FF
        return pos

    def seek(self, pos):
        self.stream.seek(pos)
        self._rbuf = 0x100

    def read_byte(self):
        if (self._rbuf & 0xFF) == 0:
            return self.stream.read_byte()
        return self.read_bits(8)

    def eof(self):
        return self._eof

    # -- bit writing -------------------------------------------------------
    def write_bit(self, b):
        self._wbuf = (self._wbuf << 1) | (1 if b else 0)
        if self._wbuf & 0x100:
            self.stream.write_byte(self._wbuf & 0xFF)
            self._wbuf = 1

    def write_bits(self, n, value):
        for i in range(n - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def write_byte(self, byte):
        if self._wbuf == 1:
            self.stream.write_byte(byte)
        else:
            self.write_bits(8, byte)

    def write_bit_array(self, bits):
        """Bulk write a uint8 0/1 array (framework extension used by the
        vectorized codecs; equivalent to write_bit in a loop)."""
        bits = np.asarray(bits, dtype=np.uint8)
        n = bits.shape[0]
        if n == 0:
            return
        # number of pending bits currently in _wbuf
        pend_bits = self._wbuf.bit_length() - 1
        pend_val = self._wbuf & ((1 << pend_bits) - 1) if pend_bits else 0
        total = pend_bits + n
        nbytes = total // 8
        if nbytes > 0:
            head = np.empty(nbytes * 8, dtype=np.uint8)
            if pend_bits:
                head[:pend_bits] = [(pend_val >> (pend_bits - 1 - i)) & 1
                                    for i in range(pend_bits)]
            head[pend_bits:] = bits[:nbytes * 8 - pend_bits]
            packed = np.packbits(head)
            self.stream.write(packed, 0, packed.shape[0])
            rem = bits[nbytes * 8 - pend_bits:]
            self._wbuf = 1
            for b in rem:
                self._wbuf = (self._wbuf << 1) | int(b)
        else:
            for b in bits:
                self.write_bit(int(b))

    def flush(self):
        while self._wbuf != 1:
            self.write_bit(0)
        if hasattr(self.stream, 'flush'):
            self.stream.flush()
