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
    for name in ('cz_suffix_sort', 'cz_suffix_sort_sais'):
        getattr(lib, name).argtypes = [_p_u8, _p_i64, _i64]
        getattr(lib, name).restype = None
    lib.cz_huff_code_lengths.argtypes = [_p_i64, _i32, _i32, _p_u8]
    lib.cz_huff_code_lengths.restype = None
    lib.cz_selector_mtf.argtypes = [_p_u8, _i64, _i32, _p_u8]
    lib.cz_selector_mtf.restype = _i64
    for name in ('cz_bwt_cyclic', 'cz_bwt_cyclic_ref'):
        getattr(lib, name).argtypes = [_p_u8, _p_u8, _i64]
        getattr(lib, name).restype = _i64
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
    lib.cz_crc32_bzip2.argtypes = [_p_u8, _i64, ctypes.c_uint32]
    lib.cz_crc32_bzip2.restype = ctypes.c_uint32
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
    lib.cz_bwt_eof.argtypes = [_p_u8, _p_u8, _i64]
    lib.cz_bwt_eof.restype = _i64
    lib.cz_inverse_bwt_eof.argtypes = [_p_u8, _p_u8, _i64, _i64]
    lib.cz_inverse_bwt_eof.restype = None
    lib.cz_mtf_encode.argtypes = [_p_u8, _i64, _p_u8, _i32, _p_i32]
    lib.cz_mtf_encode.restype = None
    lib.cz_mtf_decode.argtypes = [_p_i32, _i64, _p_u8, _i32, _p_u8]
    lib.cz_mtf_decode.restype = None
    lib.cz_bwtc_encode_block.argtypes = [_p_i32, _i64, _i32, _i32, _p_i64,
                                         _p_u8]
    lib.cz_bwtc_encode_block.restype = _i64
    lib.cz_bwtc_decode_block.argtypes = [_p_u8, _i64, _p_i64, _i32, _i32,
                                         _p_u8, _i64]
    lib.cz_bwtc_decode_block.restype = _i64
    lib.cz_order0_fenwick_encode.argtypes = [_p_u8, _i64, _i32, _i32,
                                             _p_i64, _p_u8]
    lib.cz_order0_fenwick_encode.restype = _i64
    lib.cz_order0_fenwick_decode.argtypes = [_p_u8, _i64, _p_i64, _i32,
                                             _p_u8, _i64]
    lib.cz_order0_fenwick_decode.restype = _i64
    for name in ('cz_huff_encode', 'cz_ctx1_encode'):
        getattr(lib, name).argtypes = [_p_u8, _i64, _p_u8]
        getattr(lib, name).restype = _i64
    for name in ('cz_huff_decode', 'cz_ctx1_decode', 'cz_lzjb_decode'):
        getattr(lib, name).argtypes = [_p_u8, _i64, _p_u8, _i64]
        getattr(lib, name).restype = _i64
    lib.cz_simple_encode.argtypes = [_p_u8, _i64, _p_i64, _p_u8]
    lib.cz_simple_encode.restype = _i64
    for name in ('cz_simple_decode', 'cz_lzp3_decode', 'cz_lzjbr_decode'):
        getattr(lib, name).argtypes = [_p_u8, _i64, _p_i64, _p_u8, _i64]
        getattr(lib, name).restype = _i64
    for name in ('cz_order0_mtf_encode', 'cz_order0_defsum_encode',
                 'cz_ppm_encode'):
        getattr(lib, name).argtypes = [_p_u8, _i64, _i32, _i32, _p_i64,
                                       _p_u8]
        getattr(lib, name).restype = _i64
    for name in ('cz_order0_mtf_decode', 'cz_order0_defsum_decode',
                 'cz_ppm_decode'):
        getattr(lib, name).argtypes = [_p_u8, _i64, _p_i64, _i32, _p_u8,
                                       _i64]
        getattr(lib, name).restype = _i64
    lib.cz_dmc_encode.argtypes = [_p_u8, _i64, _i32, _i32, _i64, _i64,
                                  _p_i64, _p_u8]
    lib.cz_dmc_encode.restype = _i64
    lib.cz_dmc_decode.argtypes = [_p_u8, _i64, _p_i64, _i32, _i64, _i64,
                                  _p_u8, _i64]
    lib.cz_dmc_decode.restype = _i64
    lib.cz_lzp3_encode.argtypes = [_p_u8, _i64, _p_i64, _p_u8]
    lib.cz_lzp3_encode.restype = _i64
    lib.cz_lzjb_encode.argtypes = [_p_u8, _i64, _i32, _i32, _p_u8]
    lib.cz_lzjb_encode.restype = _i64
    lib.cz_lzjbr_encode.argtypes = [_p_u8, _i64, _i32, _i32, _p_i64, _p_u8]
    lib.cz_lzjbr_encode.restype = _i64
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


def available():
    """Whether the runtime builds and loads on this host (built by this
    call if it was not).  Unlike the JAX package's, it reads no
    environment variable: the port has no numpy fallback to turn to."""
    try:
        lib()
    except (RuntimeError, OSError):
        return False
    return True


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


def crc32_bzip2(data, crc):
    """The CRC-32/BZIP2 register `crc` run over the bytes of `data`,
    complemented as bzip2 writes it."""
    data = _u8(data)
    return int(lib().cz_crc32_bzip2(data, data.shape[0], crc))


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


def huff_code_lengths(freq, maxlen=MAX_HUFCODE_BITS):
    """Canonical Huffman code lengths of `freq`, limited to `maxlen`
    bits."""
    freq = np.ascontiguousarray(freq, dtype=np.int64)
    n = freq.shape[0]
    if not 1 <= n <= 512:
        raise ValueError('huff_code_lengths: %d symbols' % n)
    if maxlen < (n - 1).bit_length():
        raise ValueError('huff_code_lengths: %d symbols in codes of at '
                         'most %d bits' % (n, maxlen))
    lengths = np.zeros(n, dtype=np.uint8)
    lib().cz_huff_code_lengths(freq, n, maxlen, lengths)
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


def _sort_input(T, what):
    """T as uint8, of a size the sorts' int32 indices hold (a doubled
    block below 2^31 - 2)."""
    T = _u8(T)
    if not 1 <= T.shape[0] < (1 << 30) - 1:
        raise ValueError('%s: block of %d bytes' % (what, T.shape[0]))
    return T


def suffix_sort(T):
    """Suffix array (int64) of T, a virtual sentinel below every byte
    ending it: the two-stage sorter."""
    T = _sort_input(T, 'suffix_sort')
    SA = np.empty(T.shape[0], dtype=np.int64)
    lib().cz_suffix_sort(T, SA, T.shape[0])
    return SA


def suffix_sort_sais(T):
    """`suffix_sort` by plain SA-IS: the reference the two-stage sorter
    is held against."""
    T = _sort_input(T, 'suffix_sort_sais')
    SA = np.empty(T.shape[0], dtype=np.int64)
    lib().cz_suffix_sort_sais(T, SA, T.shape[0])
    return SA


def bwt_cyclic(T):
    """Cyclic BWT of T (ties: larger start first): (U uint8, pidx)."""
    T = _sort_input(T, 'bwt_cyclic')
    U = np.empty(T.shape[0], dtype=np.uint8)
    pidx = lib().cz_bwt_cyclic(T, U, T.shape[0])
    return U, int(pidx)


def bwt_cyclic_ref(T):
    """`bwt_cyclic` by SA-IS on the doubled string: the reference the
    direct rotation sort is held against."""
    T = _sort_input(T, 'bwt_cyclic_ref')
    U = np.empty(T.shape[0], dtype=np.uint8)
    pidx = lib().cz_bwt_cyclic_ref(T, U, T.shape[0])
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


def bwt_eof(T):
    """EOF-terminated BWT of T (the BWTC codec's transform): (U uint8,
    pidx + 1), U[0] = T[n-1] and the slot of suffix 0 skipped."""
    T = _u8(T)
    n = T.shape[0]
    if not 1 <= n < (1 << 31) - 1:
        raise ValueError('bwt_eof: block of %d bytes' % n)
    U = np.empty(n, dtype=np.uint8)
    pidx = lib().cz_bwt_eof(T, U, n)
    return U, int(pidx)


def inverse_bwt_eof(T, pidx):
    """Invert the EOF-terminated BWT of T with its pidx (the forward
    transform's pidx + 1, 1 <= pidx <= len(T))."""
    T = _u8(T)
    n = T.shape[0]
    if not 1 <= pidx <= n:
        raise ValueError('inverse_bwt_eof: pidx %d outside 1..%d'
                         % (pidx, n))
    out = np.empty(n, dtype=np.uint8)
    lib().cz_inverse_bwt_eof(T, out, n, pidx)
    return out


def _check_alphabet(alphabet, name):
    alphabet = _u8(alphabet)
    if not 1 <= alphabet.shape[0] <= 256:
        raise ValueError('%s: alphabet of %d symbols'
                         % (name, alphabet.shape[0]))
    return alphabet


def mtf_encode(data, alphabet):
    """MTF indices (int32) of the bytes `data` over a list that starts as
    `alphabet`, which must hold every byte of data."""
    data, alphabet = _u8(data), _check_alphabet(alphabet, 'mtf_encode')
    present = np.zeros(256, dtype=bool)
    present[alphabet] = True
    if not present[data].all():   # the list search would run off
        raise ValueError('mtf_encode: a byte of data is not in the '
                         'alphabet')
    out = np.empty(data.shape[0], dtype=np.int32)
    lib().cz_mtf_encode(data, data.shape[0], alphabet, alphabet.shape[0],
                        out)
    return out


def mtf_decode(indices, alphabet):
    """Bytes of the MTF indices over a list that starts as `alphabet`
    (each index below its length)."""
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    alphabet = _check_alphabet(alphabet, 'mtf_decode')
    if indices.shape[0] and not (0 <= int(indices.min())
                                 and int(indices.max()) < alphabet.shape[0]):
        raise ValueError('mtf_decode: an index outside the list')
    out = np.empty(indices.shape[0], dtype=np.uint8)
    lib().cz_mtf_decode(indices, indices.shape[0], alphabet,
                        alphabet.shape[0], out)
    return out


def bwtc_encode_block(mtf_seq, asize, fast, enc_state):
    """Range-code one BWTC block body: the MTF indices (each below
    `asize`) as RUNA/RUNB zero-run digits and literals through a fresh
    DefSum (`fast`) or Fenwick model of asize + 1 symbols, on the coder
    whose state enc_state (int64[5], see ``host.range_coder``) holds and
    which this call updates.  Returns the bytes written."""
    mtf_seq = np.ascontiguousarray(mtf_seq, dtype=np.int32)
    n = mtf_seq.shape[0]
    if n and not (0 <= int(mtf_seq.min()) and int(mtf_seq.max()) < asize):
        raise ValueError('bwtc_encode_block: an index outside the alphabet')
    # a symbol costs at most two coder steps (escape and literal) of at
    # most 16 bits each
    out = np.empty(4 * n + 4096, dtype=np.uint8)
    count = lib().cz_bwtc_encode_block(mtf_seq, n, asize, 1 if fast else 0,
                                       enc_state, out)
    return out[:count]


def bwtc_decode_block(data, dec_state, asize, fast, length):
    """Decode `length` MTF indices of one BWTC block body from `data` on
    the coder whose state dec_state (int64[5]: low, range, buffer, the
    read position) holds; updates it.  Raises ValueError where the zero
    runs overrun the block."""
    data = _u8(data)
    b = np.empty(length, dtype=np.uint8)
    r = lib().cz_bwtc_decode_block(data, data.shape[0], dec_state, asize,
                                   1 if fast else 0, b, length)
    if r < 0:
        raise ValueError('BWTC block decode overrun')
    return b


def order0_fenwick_encode(data, size, eof_sym, enc_state):
    """Range-code the symbols `data` (uint8, each below `size`), then
    `eof_sym` where it is >= 0, through one fresh Fenwick model of `size`
    symbols (max_prob 0xFF00, increment 0x100) on the coder whose state
    enc_state (int64[5], see ``host.range_coder``) holds and which this
    call updates.  Returns the bytes written."""
    data = _u8(data)
    if size < 1 or eof_sym >= size or (
            data.shape[0] and int(data.max()) >= size):
        raise ValueError('order0_fenwick_encode: a symbol outside the '
                         'model\'s %d' % size)
    # a symbol costs at most two coder steps of at most 16 bits each
    out = np.empty(data.shape[0] * 3 + 4096, dtype=np.uint8)
    n = lib().cz_order0_fenwick_encode(data, data.shape[0], size, eof_sym,
                                       enc_state, out)
    return out[:n]


def order0_fenwick_decode(data, dec_state, size, n):
    """Decode `n` symbols (uint8) of an `order0_fenwick_encode` stream
    from `data` on the coder whose state dec_state (int64[5]: low,
    range, buffer, the read position) holds; updates it."""
    data = _u8(data)
    if not 1 <= size <= 256:
        raise ValueError('order0_fenwick_decode: a model of %d symbols'
                         % size)
    out = np.empty(n, dtype=np.uint8)
    lib().cz_order0_fenwick_decode(data, data.shape[0], dec_state, size,
                                   out, n)
    return out


# --- the host codecs' bodies ---------------------------------------------
# Each coder entry continues a range coder whose state the caller's
# ``host.range_coder.RangeCoder`` exported: an encoder's int64[5] (low,
# range, buffer, help, byte count), a decoder's int64[5] (low, range,
# buffer, the read position, unused); the call updates it in place.  The
# output buffers are sized as the JAX package's bindings size them: a
# symbol costs at most two coder steps (escape and literal) of at most 16
# bits each, an LZJB item at most 17/16 of its bytes, a Huffman code with
# its escaped id less than 2 bytes.


def _state(st, name):
    """The coder state array, checked: int64, C-contiguous, 5 entries."""
    if not (isinstance(st, np.ndarray) and st.dtype == np.int64
            and st.shape == (5,) and st.flags['C_CONTIGUOUS']
            and st.flags['WRITEABLE']):
        raise ValueError('%s: the coder state must be a writeable '
                         'contiguous int64 array of 5 entries' % name)
    return st


def _check_model(size, eof_sym, data, name):
    """An order-0 model of `size` symbols codes the bytes of data and
    eof_sym (where >= 0): each below size, size at most 257."""
    if not 1 <= size <= 257 or eof_sym >= size or (
            data.shape[0] and int(data.max()) >= size):
        raise ValueError('%s: a symbol outside the model\'s %d'
                         % (name, size))


def _check_count(n, name):
    if n < 0:
        raise ValueError('%s: %d symbols to decode' % (name, n))


def huff_encode(data):
    """The adaptive (Vitter) Huffman 'huff' body of `data`: alphabet 256,
    table capacity 257, max weight 8191; the bytes, bit-flushed."""
    data = _u8(data)
    out = np.empty(data.shape[0] * 2 + 4096, dtype=np.uint8)
    n = lib().cz_huff_encode(data, data.shape[0], out)
    return out[:n]


def huff_decode(data, n):
    """`n` bytes of a `huff_encode` body (zero bits past its end)."""
    data = _u8(data)
    _check_count(n, 'huff_decode')
    out = np.empty(n, dtype=np.uint8)
    lib().cz_huff_decode(data, data.shape[0], out, n)
    return out


def ctx1_encode(data):
    """The order-1 adaptive Huffman 'ctx1' body: one coder per previous
    byte (0x20 before the first)."""
    data = _u8(data)
    out = np.empty(data.shape[0] * 2 + 4096, dtype=np.uint8)
    n = lib().cz_ctx1_encode(data, data.shape[0], out)
    return out[:n]


def ctx1_decode(data, n):
    """`n` bytes of a `ctx1_encode` body."""
    data = _u8(data)
    _check_count(n, 'ctx1_decode')
    out = np.empty(n, dtype=np.uint8)
    lib().cz_ctx1_decode(data, data.shape[0], out, n)
    return out


def simple_encode(data, enc_state):
    """The Simple codec's body on the coder: 128 KiB blocks, each a
    continuation bit, 256 raw 16-bit counts and its symbols against the
    static table (a block ends early where a count reaches 0xFFFF), then
    a stop bit."""
    data = _u8(data)
    st = _state(enc_state, 'simple_encode')
    # per block: 257 16-bit steps; at least 0xFFFF / 256 bytes a block
    out = np.empty(data.shape[0] * 2 + data.shape[0] // 1000 * 520 + 8192,
                   dtype=np.uint8)
    n = lib().cz_simple_encode(data, data.shape[0], st, out)
    return out[:n]


def simple_decode(data, dec_state, cap):
    """The bytes of a Simple body (at most `cap`; ValueError past it)."""
    data = _u8(data)
    st = _state(dec_state, 'simple_decode')
    _check_count(cap, 'simple_decode')
    out = np.empty(cap, dtype=np.uint8)
    n = lib().cz_simple_decode(data, data.shape[0], st, out, cap)
    if n < 0:
        raise ValueError('simple decode overrun')
    return out[:n]


def order0_encode(kind, data, size, eof_sym, enc_state):
    """Code the bytes of data, then eof_sym where >= 0, through one
    fresh order-0 model of `size` symbols: kind 'mtf' (the MTF-list
    model, max_prob 0xFF00, increment 0x100) or 'defsum'."""
    if kind not in ('mtf', 'defsum'):
        raise ValueError('order0_encode: no model %r' % (kind,))
    data = _u8(data)
    st = _state(enc_state, 'order0_encode')
    _check_model(size, eof_sym, data, 'order0_encode')
    out = np.empty(data.shape[0] * 3 + 65536, dtype=np.uint8)
    fn = getattr(lib(), 'cz_order0_%s_encode' % kind)
    n = fn(data, data.shape[0], size, eof_sym, st, out)
    return out[:n]


def order0_decode(kind, data, dec_state, size, n):
    """`n` symbols (uint8) of an `order0_encode` stream."""
    if kind not in ('mtf', 'defsum'):
        raise ValueError('order0_decode: no model %r' % (kind,))
    data = _u8(data)
    st = _state(dec_state, 'order0_decode')
    if not 1 <= size <= 256:
        raise ValueError('order0_decode: a model of %d symbols' % size)
    _check_count(n, 'order0_decode')
    out = np.empty(n, dtype=np.uint8)
    fn = getattr(lib(), 'cz_order0_%s_decode' % kind)
    fn(data, data.shape[0], st, size, out, n)
    return out


def dmc_encode(data, size, eof_sym, min1, min2, enc_state):
    """The DMC body: the bytes (then eof_sym where >= 0) through the
    Markov model of `size` states, split thresholds min1 / min2."""
    data = _u8(data)
    st = _state(enc_state, 'dmc_encode')
    _check_model(size, eof_sym, data, 'dmc_encode')
    out = np.empty(data.shape[0] * 3 + 65536, dtype=np.uint8)
    n = lib().cz_dmc_encode(data, data.shape[0], size, eof_sym, min1, min2,
                            st, out)
    return out[:n]


def dmc_decode(data, dec_state, size, min1, min2, n):
    """`n` bytes of a DMC body."""
    data = _u8(data)
    st = _state(dec_state, 'dmc_decode')
    if not 1 <= size <= 256:
        raise ValueError('dmc_decode: a model of %d symbols' % size)
    _check_count(n, 'dmc_decode')
    out = np.empty(n, dtype=np.uint8)
    lib().cz_dmc_decode(data, data.shape[0], st, size, min1, min2, out, n)
    return out


def ppm_encode(data, size, eof_sym, enc_state):
    """The PPM body: the bytes (then eof_sym where >= 0) through the
    order-5 context model of `size` symbols."""
    data = _u8(data)
    st = _state(enc_state, 'ppm_encode')
    _check_model(size, eof_sym, data, 'ppm_encode')
    out = np.empty(data.shape[0] * 3 + 65536, dtype=np.uint8)
    n = lib().cz_ppm_encode(data, data.shape[0], size, eof_sym, st, out)
    return out[:n]


def ppm_decode(data, dec_state, size, n):
    """`n` bytes of a PPM body."""
    data = _u8(data)
    st = _state(dec_state, 'ppm_decode')
    if not 1 <= size <= 256:
        raise ValueError('ppm_decode: a model of %d symbols' % size)
    _check_count(n, 'ppm_decode')
    out = np.empty(n, dtype=np.uint8)
    lib().cz_ppm_decode(data, data.shape[0], st, size, out, n)
    return out


def lzp3_encode(data, enc_state):
    """The LZP3 body (after its 0x00 coder-mode byte) of `data`, whose
    size the container carries."""
    data = _u8(data)
    st = _state(enc_state, 'lzp3_encode')
    out = np.empty(data.shape[0] * 2 + 65536, dtype=np.uint8)
    n = lib().cz_lzp3_encode(data, data.shape[0], st, out)
    return out[:n]


def lzp3_decode(data, dec_state, n):
    """`n` bytes of an LZP3 body (a match past them is cut)."""
    data = _u8(data)
    st = _state(dec_state, 'lzp3_decode')
    _check_count(n, 'lzp3_decode')
    out = np.empty(n, dtype=np.uint8)
    lib().cz_lzp3_decode(data, data.shape[0], st, out, n)
    return out


def _check_lempel(lempel_size, expand, name):
    if not (lempel_size >= 1 and lempel_size & (lempel_size - 1) == 0
            and 1 <= expand <= 64):
        raise ValueError('%s: hash table of %d buckets x %d'
                         % (name, lempel_size, expand))


def lzjb_encode(data, lempel_size, expand):
    """The LZJB body: copymap bytes, literals and 2-byte matches, with
    `expand` candidates in each of `lempel_size` hash buckets."""
    data = _u8(data)
    _check_lempel(lempel_size, expand, 'lzjb_encode')
    out = np.empty(data.shape[0] * 2 + 1024, dtype=np.uint8)
    n = lib().cz_lzjb_encode(data, data.shape[0], lempel_size, expand, out)
    return out[:n]


def lzjb_decode(data, out_size):
    """At most `out_size` bytes of an LZJB body."""
    data = _u8(data)
    _check_count(out_size, 'lzjb_decode')
    out = np.empty(out_size, dtype=np.uint8)
    n = lib().cz_lzjb_decode(data, data.shape[0], out, out_size)
    return out[:n]


# the longest LZJB match (6 length bits + 3): a corrupt LZJB-R stream can
# code a match that passes the output's end by up to this many bytes less
# one, which the decode writes before it looks at the count again
_LZJB_MATCH_MAX = 66


def lzjbr_encode(data, lempel_size, expand, enc_state):
    """The LZJB-R body: LZJB's parse, range-coded (literal / MATCH
    through an order-1 Fenwick context, lengths and offsets through
    log-distance models)."""
    data = _u8(data)
    _check_lempel(lempel_size, expand, 'lzjbr_encode')
    st = _state(enc_state, 'lzjbr_encode')
    out = np.empty(data.shape[0] * 2 + 65536, dtype=np.uint8)
    n = lib().cz_lzjbr_encode(data, data.shape[0], lempel_size, expand, st,
                              out)
    return out[:n]


def lzjbr_decode(data, dec_state, out_size):
    """`out_size` bytes of an LZJB-R body."""
    data = _u8(data)
    st = _state(dec_state, 'lzjbr_decode')
    _check_count(out_size, 'lzjbr_decode')
    out = np.empty(out_size + _LZJB_MATCH_MAX, dtype=np.uint8)
    lib().cz_lzjbr_decode(data, data.shape[0], st, out, out_size)
    return out[:out_size]
