"""ctypes bindings of the native host runtime (``core.cpp``).

At first use ``core.cpp`` is compiled with ``g++`` into
``_build/host-<hash>/``, where the hash covers the compiler flags, the
source, the host CPU's model name and the target g++ resolves
``-march=native`` to (such code must never be loaded on another CPU).
The library is written under a name tagged with the process id and
then renamed into place, so processes that build at once never load a
half-written file.  A failed build or load
raises with the compiler's output: there is no fallback.  ctypes drops
the GIL for each call, so these calls overlap the card's work in other
threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, 'core.cpp')
BUILD_DIR = os.path.join(os.path.dirname(_DIR), '_build')
CXX = 'g++'
CXXFLAGS = ['-O3', '-march=native', '-shared', '-fPIC', '-std=c++17']
MAX_HUFCODE_BITS = 20
GROUP_SIZE = 50

_lock = threading.Lock()
_lib = None
# what the last build did: wall seconds (0 if an existing library was
# loaded), the library's path, the compiler's version line, the CPU and
# the target -march=native resolved to
build_info = {'seconds': 0.0, 'path': None, 'compiler': None, 'cpu': None,
              'march': None}

_i32, _i64 = ctypes.c_int32, ctypes.c_int64


def _ptr(dtype):
    return np.ctypeslib.ndpointer(dtype=dtype, flags='C_CONTIGUOUS')


_p_u8, _p_u16, _p_u32, _p_i32, _p_i64 = (
    _ptr(np.uint8), _ptr(np.uint16), _ptr(np.uint32), _ptr(np.int32),
    _ptr(np.int64))


def cpu_model():
    """The host CPU as ``/proc/cpuinfo`` names it (model name, vendor,
    family and model number), else the machine type."""
    fields = {}
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if not line.strip():
                    break                    # the first CPU is enough
                key, _, val = line.partition(':')
                fields.setdefault(key.strip(), val.strip())
    except OSError:
        pass
    if 'model name' not in fields:
        return platform.machine()
    return '%s (%s family %s model %s)' % (
        fields['model name'], fields.get('vendor_id', '?'),
        fields.get('cpu family', '?'), fields.get('model', '?'))


def _run(cmd):
    try:
        return subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError('native runtime: cannot run %s: %s' % (cmd[0], e))


def _native_march():
    """The target g++ resolves -march=native to on this host."""
    out = _run([CXX, '-march=native', '-Q', '--help=target']).stdout
    for line in out.splitlines():
        if line.strip().startswith('-march='):
            return line.split()[-1]
    return 'unknown'


def _build():
    """Compile core.cpp unless a library for the same flags, source and
    CPU exists; returns its path."""
    cpu, march = cpu_model(), _native_march()
    with open(SOURCE, 'rb') as f:
        src = f.read()
    h = hashlib.sha256('\0'.join([' '.join([CXX] + CXXFLAGS), cpu, march])
                       .encode() + b'\0' + src)
    out_dir = os.path.join(BUILD_DIR, 'host-' + h.hexdigest()[:16])
    so = os.path.join(out_dir, 'libcompressjs_host.so')
    if os.path.exists(so):
        build_info.update(seconds=0.0, path=so, cpu=cpu, march=march)
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = '%s.%d' % (so, os.getpid())
    t0 = time.perf_counter()
    proc = _run([CXX, *CXXFLAGS, '-o', tmp, SOURCE])
    if proc.returncode:
        raise RuntimeError('native runtime: %s failed on %s:\n%s'
                           % (CXX, SOURCE, proc.stdout))
    os.replace(tmp, so)
    build_info.update(seconds=time.perf_counter() - t0, path=so, cpu=cpu,
                      march=march)
    return so


def _bind(lib):
    lib.cz_huff_code_lengths.argtypes = [_p_i64, _i32, _i32, _p_u8]
    lib.cz_huff_code_lengths.restype = None
    lib.cz_selector_mtf.argtypes = [_p_u8, _i64, _i32, _p_u8]
    lib.cz_selector_mtf.restype = _i64
    lib.cz_bwt_cyclic.argtypes = [_p_u8, _p_u8, _i64]
    lib.cz_bwt_cyclic.restype = _i64
    lib.cz_mtf_rle2.argtypes = [_p_u8, _i64, _p_u8, _i32, _p_u16, _p_i64]
    lib.cz_mtf_rle2.restype = _i64
    lib.cz_group_costs.argtypes = [_p_u16, _i64, _p_u8, _i32, _i32, _p_i64]
    lib.cz_group_costs.restype = None
    lib.cz_chunk_freqs.argtypes = [_p_u16, _i64, _p_u8, _i32, _i32, _p_i64]
    lib.cz_chunk_freqs.restype = None
    lib.cz_payload_pack.argtypes = [_p_u16, _i64, _p_u8, _p_u8, _p_u32,
                                    _i32, _p_u8]
    lib.cz_payload_pack.restype = _i64
    lib.cz_rle1_encode.argtypes = [_p_u8, _i64, _i64, _p_u8,
                                   ctypes.POINTER(_i64)]
    lib.cz_rle1_encode.restype = _i64
    lib.cz_bz2_decode_block.argtypes = [
        _p_u8, _i64, ctypes.POINTER(_i64), _p_u8, _i64, _p_i32, _p_i32,
        _p_i64, _p_i64, _p_i32, _i32, _p_u8, _p_u8, _i64]
    lib.cz_bz2_decode_block.restype = _i64
    lib.cz_bz2_block_full.argtypes = [_p_u8, _i64, ctypes.POINTER(_i64),
                                      _i64, _p_u8, ctypes.POINTER(_i64)]
    lib.cz_bz2_block_full.restype = _i64
    lib.cz_inverse_bwt.argtypes = [_p_u8, _i64, _i64, _p_u8]
    lib.cz_inverse_bwt.restype = None
    lib.cz_rle1_decode.argtypes = [_p_u8, _i64, _p_u8, _i64]
    lib.cz_rle1_decode.restype = _i64
    return lib


def lib():
    """The loaded runtime, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            so = _build()
            _lib = _bind(ctypes.CDLL(so))
            build_info['compiler'] = _run([CXX, '--version']).stdout \
                .splitlines()[0]
        return _lib


def _u8(a):
    return np.ascontiguousarray(a, dtype=np.uint8)


def _u16(a):
    return np.ascontiguousarray(a, dtype=np.uint16)


def rle1_encode(data, block_size):
    """RLE1-pack data from its start into one block of at most
    block_size bytes; returns (block, input bytes consumed)."""
    data = _u8(data)
    out = np.empty(block_size, dtype=np.uint8)
    consumed = _i64(0)
    n = lib().cz_rle1_encode(data, data.shape[0], block_size, out,
                             ctypes.byref(consumed))
    return out[:n], int(consumed.value)


def mtf_rle2(U, alphabet):
    """Fused MTF + RLE2 of a BWT column over the sorted `alphabet`:
    (syms uint16 with EOB last, freq int64[len(alphabet) + 2])."""
    U, alphabet = _u8(U), _u8(alphabet)
    if not 1 <= alphabet.shape[0] <= 256:
        raise ValueError('mtf_rle2: alphabet of %d symbols'
                         % alphabet.shape[0])
    present = np.zeros(256, dtype=bool)
    present[alphabet] = True
    if not present[U].all():   # the scan's list search would run off
        raise ValueError('mtf_rle2: a byte of U is not in the alphabet')
    syms = np.empty(U.shape[0] + 1, dtype=np.uint16)
    freq = np.zeros(alphabet.shape[0] + 2, dtype=np.int64)
    count = lib().cz_mtf_rle2(U, U.shape[0], alphabet, alphabet.shape[0],
                              syms, freq)
    return syms[:count], freq


def huff_code_lengths(freq):
    """Length-limited (20-bit) canonical Huffman code lengths of `freq`."""
    freq = np.ascontiguousarray(freq, dtype=np.int64)
    n = freq.shape[0]
    if not 1 <= n <= 512:
        raise ValueError('huff_code_lengths: %d symbols' % n)
    lengths = np.zeros(n, dtype=np.uint8)
    lib().cz_huff_code_lengths(freq, n, MAX_HUFCODE_BITS, lengths)
    return lengths


def _check_tables(syms, lengths):
    if syms.shape[0] and int(syms.max()) >= lengths.shape[1]:
        raise ValueError('a symbol lies outside the tables')


def group_costs(syms, lengths):
    """(n_chunks, n_groups) int64 bit cost of each 50-symbol chunk under
    each table of `lengths` (n_groups, alphabet) uint8."""
    syms, lengths = _u16(syms), _u8(lengths)
    _check_tables(syms, lengths)
    g, alpha = lengths.shape
    costs = np.empty((-(-syms.shape[0] // GROUP_SIZE), g), dtype=np.int64)
    lib().cz_group_costs(syms, syms.shape[0], lengths, g, alpha, costs)
    return costs


def _check_selectors(syms, selectors, n_groups):
    if selectors.shape[0] != -(-syms.shape[0] // GROUP_SIZE):
        raise ValueError('%d selectors for %d symbols'
                         % (selectors.shape[0], syms.shape[0]))
    if selectors.shape[0] and int(selectors.max()) >= n_groups:
        raise ValueError('a selector names no table')


def chunk_freqs(syms, selectors, n_groups, alpha):
    """(n_groups, alpha) int64 symbol counts of the chunks each selector
    assigns to each group."""
    syms, selectors = _u16(syms), _u8(selectors)
    _check_selectors(syms, selectors, n_groups)
    if syms.shape[0] and int(syms.max()) >= alpha:
        raise ValueError('a symbol lies outside the alphabet')
    freqs = np.zeros((n_groups, alpha), dtype=np.int64)
    lib().cz_chunk_freqs(syms, syms.shape[0], selectors, n_groups, alpha,
                         freqs)
    return freqs


def payload_pack(syms, selectors, lengths, codes):
    """Huffman payload, MSB first: (bytes, total bits)."""
    syms, selectors, lengths = _u16(syms), _u8(selectors), _u8(lengths)
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    _check_tables(syms, lengths)
    _check_selectors(syms, selectors, lengths.shape[0])
    if codes.shape != lengths.shape:
        raise ValueError('codes and lengths differ in shape')
    out = np.zeros(syms.shape[0] * MAX_HUFCODE_BITS // 8 + 16,
                   dtype=np.uint8)
    bits = lib().cz_payload_pack(syms, syms.shape[0], selectors, lengths,
                                 codes, lengths.shape[1], out)
    return out[:(bits + 7) // 8], int(bits)


def selector_mtf(selectors, n_groups):
    """Selectors move-to-front coded, then unary coded: uint8 0/1 bits."""
    selectors = _u8(selectors)
    out = np.empty(selectors.shape[0] * max(1, n_groups), dtype=np.uint8)
    count = lib().cz_selector_mtf(selectors, selectors.shape[0], n_groups,
                                  out)
    if count < 0:
        raise ValueError('invalid selector value')
    return out[:count]


def bwt_cyclic(T):
    """Cyclic BWT of T (ties: larger start first): (U uint8, pidx)."""
    T = _u8(T)
    n = T.shape[0]
    if not 1 <= n < (1 << 30) - 1:
        raise ValueError('bwt_cyclic: block of %d bytes' % n)
    U = np.empty(n, dtype=np.uint8)
    pidx = lib().cz_bwt_cyclic(T, U, n)
    return U, int(pidx)


# the decode tables' row widths in core.cpp: limit, base and permute of
# each Huffman group
_LIMIT_W, _BASE_W, _PERM_W = 25, 22, 258


def bz2_decode_block(data, bitpos, selectors, minlen, maxlen, limit, base,
                     permute, sym_total, sym_to_byte, dbuf_size):
    """The symbol decode of one block (Huffman walk, RLE2 and MTF undo)
    from bit `bitpos` of `data`, with the block's selectors and its
    groups' decode tables (minlen, maxlen (G,), limit (G, 25), base
    (G, 22), permute (G, 258)).  Returns (the BWT column, the bit after
    its EOB code); raises ValueError on a data error."""
    data, selectors, sym_to_byte = _u8(data), _u8(selectors), _u8(sym_to_byte)
    minlen = np.ascontiguousarray(minlen, dtype=np.int32)
    maxlen = np.ascontiguousarray(maxlen, dtype=np.int32)
    limit = np.ascontiguousarray(limit, dtype=np.int64)
    base = np.ascontiguousarray(base, dtype=np.int64)
    permute = np.ascontiguousarray(permute, dtype=np.int32)
    g = minlen.shape[0]
    if (maxlen.shape != (g,) or limit.shape != (g, _LIMIT_W)
            or base.shape != (g, _BASE_W) or permute.shape != (g, _PERM_W)
            or not 1 <= g <= 6):
        raise ValueError('bz2_decode_block: tables of %d groups do not '
                         'match in shape' % g)
    if g and not ((1 <= minlen) & (minlen <= maxlen)
                  & (maxlen <= MAX_HUFCODE_BITS)).all():
        raise ValueError('bz2_decode_block: code lengths out of range')
    if selectors.shape[0] and int(selectors.max()) >= g:
        raise ValueError('a selector names no table')
    if sym_to_byte.shape[0] != 256 or not 0 <= sym_total <= 256:
        raise ValueError('bz2_decode_block: bad symbol map')
    dbuf = np.empty(dbuf_size, dtype=np.uint8)
    pos = _i64(bitpos)
    count = lib().cz_bz2_decode_block(
        data, data.shape[0], ctypes.byref(pos), selectors,
        selectors.shape[0], minlen, maxlen, limit, base, permute, sym_total,
        sym_to_byte, dbuf, dbuf_size)
    if count < 0:
        raise ValueError('Data error')
    return dbuf[:count], int(pos.value)


def bz2_block_full(data, bitpos, dbuf_size):
    """Parse and symbol-decode one block from bit `bitpos` of `data`, the
    bit after its magic and CRC.  Returns (the BWT column, origPtr, the
    bit after its EOB code), or None on any anomaly: the caller then
    parses the block again in Python, which reproduces the reference's
    own errors and its acceptance of degenerate blocks."""
    data = _u8(data)
    dbuf = np.empty(dbuf_size, dtype=np.uint8)
    pos = _i64(bitpos)
    optr = _i64(0)
    count = lib().cz_bz2_block_full(data, data.shape[0], ctypes.byref(pos),
                                    dbuf_size, dbuf, ctypes.byref(optr))
    if count < 0:
        return None
    return dbuf[:count], int(optr.value), int(pos.value)


def inverse_bwt(U, pidx):
    """Invert the cyclic BWT of U with origPtr pidx (0 <= pidx < len(U))."""
    U = _u8(U)
    if not 0 <= pidx < U.shape[0]:
        raise ValueError('inverse_bwt: origPtr %d outside a block of %d '
                         'bytes' % (pidx, U.shape[0]))
    out = np.empty(U.shape[0], dtype=np.uint8)
    lib().cz_inverse_bwt(U, U.shape[0], pidx, out)
    return out


def rle1_decode(block, out_cap):
    """Undo RLE1 (after 4 equal bytes the next byte is a count of more)
    into at most out_cap bytes; raises ValueError past it."""
    block = _u8(block)
    out = np.empty(out_cap, dtype=np.uint8)
    n = lib().cz_rle1_decode(block, block.shape[0], out, out_cap)
    if n < 0:
        raise ValueError('RLE1 output overflow')
    return out[:n]
