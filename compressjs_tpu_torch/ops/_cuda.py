"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At first use they
are compiled with ``nvcc`` for ``sm_90a`` (one object per source, all
compiles started together) and linked into one shared library under
``_build/<hash of sources and flags>/``, then loaded with ``ctypes``.
A library already built for the same sources is reused.  Nothing here
runs at import time: the CPU build of the package never compiles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
SOURCES = ('mtf_scan.cu', 'alloc_lengths.cu', 'compose_windowed.cu',
           'selector_chase.cu', 'mtf_undo.cu', 'probes.cu',
           'fenwick_encode.cu', 'fenwick_decode.cu', 'huffman_walk.cu',
           'seg_scan.cu')
# headers the sources include (part of the build's hash)
HEADERS = ('fenwick_tree.cuh', 'range_coder.cuh')
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
CFLAGS = ARCH + ['-std=c++17', '-O3', '-Xcompiler', '-fPIC',
                 '-Xptxas', '-v']

_lock = threading.Lock()
_lib = None
# kernel launches so far, by kernel: each wrapper adds one where it calls
# its kernel's C entry point, and nowhere else (the probes, csrc/probes.cu
# and cz_stage_probe, have no wrapper in the package: chip_smoke.py counts
# them where it launches them)
launches = {'mtf_scan': 0, 'alloc_lengths': 0, 'code_lengths': 0,
            'compose_windowed': 0, 'selector_chase': 0, 'mtf_undo': 0,
            'chase_probe': 0, 'smem_chain_probe': 0, 'stage_probe': 0,
            'fenwick_encode': 0, 'range_encode': 0, 'fenwick_code': 0,
            'fenwick_decode': 0, 'walk_maps': 0, 'chunk_walk': 0,
            'seg_scan': 0}
# what the last build did: wall seconds (0 if reused) and nvcc's messages
# (the -Xptxas -v register and shared-memory lines, kept beside the
# library for a later reuse)
build_info = {'seconds': 0.0, 'log': '', 'path': None}


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be '
                           'built')
    return path


def _build(sources=SOURCES, defines=()):
    """Compile `sources` (names under csrc/) with `defines` (NAME=VALUE
    macros) and link them into one shared library; returns its path."""
    flags = CFLAGS + ['-D' + d for d in defines]
    srcs = [os.path.join(CSRC, s) for s in sources]
    h = hashlib.sha256(' '.join(flags).encode())
    for s in srcs + [os.path.join(CSRC, x) for x in HEADERS]:
        with open(s, 'rb') as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_DIR, h.hexdigest()[:16])
    so = os.path.join(out_dir, 'libcompressjs_cuda.so')
    log_path = so + '.log'
    if os.path.exists(so):
        log = ''
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        build_info.update(seconds=0.0, log=log, path=so)
        return so
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    tag = '.%d' % os.getpid()
    t0 = time.perf_counter()
    objs, procs = [], []
    for s in srcs:
        obj = os.path.join(out_dir, os.path.basename(s) + tag + '.o')
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *flags, '-c', '-o', obj, s],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode:
            raise RuntimeError('nvcc failed on %s:\n%s' % (s, out))
    tmp = so + tag
    link = subprocess.run([nvcc, *ARCH, '-shared', '-o', tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise RuntimeError('nvcc link failed:\n' + link.stdout)
    log = ''.join(logs) + link.stdout
    with open(log_path + tag, 'w') as f:
        f.write(log)
    os.replace(log_path + tag, log_path)
    os.replace(tmp, so)
    for obj in objs:
        os.remove(obj)
    build_info.update(seconds=time.perf_counter() - t0, log=log, path=so)
    return so


def _bind(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.cz_mtf_encode_tiles.argtypes = [p, p, i64, i32, p]
    lib.cz_mtf_encode_tiles.restype = i32
    lib.cz_mtf_encode_prefix.argtypes = [p, p, i32, p]
    lib.cz_mtf_encode_prefix.restype = i32
    lib.cz_mtf_encode.argtypes = [p, p, p, i64, i32, p]
    lib.cz_mtf_encode.restype = i32
    lib.cz_alloc_lengths.argtypes = [p, p, p, p, i32, i32, p]
    lib.cz_alloc_lengths.restype = i32
    lib.cz_code_lengths.argtypes = [p, i32, p, p, i32, i32, p]
    lib.cz_code_lengths.restype = i32
    lib.cz_compose_windowed.argtypes = [p, p, p, i32, i64, i32, i32, p]
    lib.cz_compose_windowed.restype = i32
    lib.cz_selector_chase.argtypes = [p, p, p, i32, i64, i32, i32, p, p]
    lib.cz_selector_chase.restype = i32
    lib.cz_stage_probe.argtypes = [p, i32, i64, p, p]
    lib.cz_stage_probe.restype = i32
    lib.cz_chase_probe.argtypes = [p, p, p, i32, i64, i32, i32, p]
    lib.cz_chase_probe.restype = i32
    lib.cz_smem_chain_probe.argtypes = [p, i32, i32, p, p]
    lib.cz_smem_chain_probe.restype = i32
    lib.cz_mtf_undo_perm.argtypes = [p, p, p, i64, i32, p]
    lib.cz_mtf_undo_perm.restype = i32
    lib.cz_mtf_undo_prefix.argtypes = [p, p, i32, p]
    lib.cz_mtf_undo_prefix.restype = i32
    lib.cz_mtf_undo_decode.argtypes = [p, p, p, p, i64, i32, p]
    lib.cz_mtf_undo_decode.restype = i32
    lib.cz_fenwick_encode.argtypes = [p, p, p, i32, i64, i32, i32, i32, p,
                                      p, p, p, p, p]
    lib.cz_fenwick_encode.restype = i32
    lib.cz_range_encode.argtypes = [p, p, p, p, p, i32, i64, p, i64, p, p,
                                    p]
    lib.cz_range_encode.restype = i32
    lib.cz_fenwick_code.argtypes = [p, p, p, i32, i64, i32, i32, i32, p, p,
                                    i64, p, p, p, p]
    lib.cz_fenwick_code.restype = i32
    lib.cz_fenwick_decode.argtypes = [p, i64, p, p, p, i32, i64, i32, i32,
                                      i32, p, p, p]
    lib.cz_fenwick_decode.restype = i32
    lib.cz_fenwick_decode_levels.argtypes = []
    lib.cz_fenwick_decode_levels.restype = i32
    lib.cz_walk_maps.argtypes = [p, i64, i32, i32, p, p, i32, p, p, p]
    lib.cz_walk_maps.restype = i32
    lib.cz_chunk_walk.argtypes = [p, p, p, i32, p, p, p, p, i32, i32, i32,
                                  p, p, p]
    lib.cz_chunk_walk.restype = i32
    lib.cz_max_scan.argtypes = [p, i64, p, p, p]
    lib.cz_max_scan.restype = i32
    lib.cz_group_start.argtypes = [p, i64, p, p, p]
    lib.cz_group_start.restype = i32
    return lib


def lib():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(_build()))
        return _lib


def stream_handle(device):
    """The current CUDA stream of `device` as a pointer-sized int."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(rc, what):
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError('%s launch failed: CUDA error %d' % (what, rc))


def require_cuda(t, what):
    """Kernel wrappers launch only for CUDA tensors."""
    if t.device.type != 'cuda':
        raise RuntimeError('%s: no kernel for a tensor on %s'
                           % (what, t.device))
