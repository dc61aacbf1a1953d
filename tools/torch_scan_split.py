#!/usr/bin/env python3
"""Split a step of the one-thread-a-lane Fenwick encode and range-coder
kernels (the design of ``csrc/fenwick_encode.cu`` and
``csrc/range_encode.cu`` before the warp-a-lane redesign) by cause, on
one CUDA card, and time the current kernels beside them.

    python3 tools/torch_scan_split.py --root _archive/parent [--reps 3]

--root is a tree that still has those two sources: the commit before
the redesign, f109d86, unpacked into a git-ignored directory
(``mkdir -p _archive/parent && git archive f109d86 | tar -x -C
_archive/parent``); on any other tree the edits below are not found and
the script stops.  The script builds
variants of them, each with one cause taken out, and times every variant
by CUDA events at the BWTC paths' shapes (sample5's first -9 block as
BWTC-L's 128 lanes of 7,032 steps and as the 1 x 900,001 BWTC-P lane,
and the 8 x 900,001 BWTC-P dispatch of sample5x4's first 8 blocks):

* base: the kernels as they were;
* tail: the base at each lane's last valid step (the inputs cut there),
  so base - tail is the masked tail's cost;
* no_stores: the model keeps a checksum instead of writing its 26 bytes
  a step, the coder counts its tokens without writing them;
* no_rescale: no rescale test (the tree is never halved);
* lane_a_block: one lane a block (one a warp) instead of 16, so no lane
  waits on another's escapes and rescales;
* leaf_only: the walk adds the update to the leaf and the root only, not
  to the levels between (lt_f is 0; escapes and rescales as before).

The variants' outputs are not used: each only removes work.  Then the
current package's three encode entries (``cz_fenwick_encode``,
``cz_range_encode``, ``cz_fenwick_code``) at the same shapes.  Prints
one JSON line (also written to chiprun_out/scan_split.json) with every
time, the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from compressjs_tpu_torch.ops import _cuda  # noqa: E402
from compressjs_tpu_torch.ops import device_coder as dc  # noqa: E402
from compressjs_tpu_torch.ops import device_lane as dl  # noqa: E402

MAX_N, MAX_PROB, INCR = 258, 0xFF00, 0x100

# (file, old text, new text) edits of each variant; every old text must
# be found in the source
EDITS = {
    'base': [],
    'no_stores': [
        ('fenwick_encode.cu', '  for (int64_t s = 0; s < T; ++s) {',
         '  uint32_t acc = 0;\n  for (int64_t s = 0; s < T; ++s) {'),
        ('fenwick_encode.cu',
         '''    const int64_t o = orow + 2 * s;
    sy[o] = static_cast<int32_t>(a.sy);
    lt[o] = static_cast<int32_t>(a.lt);
    tot[o] = static_cast<int32_t>(a.tot);
    vout[o] = escapes;
    sy[o + 1] = static_cast<int32_t>(b.sy);
    lt[o + 1] = static_cast<int32_t>(b.lt);
    tot[o + 1] = static_cast<int32_t>(b.tot);
    vout[o + 1] = active;
  }
''',
         '''    acc += a.sy ^ a.lt ^ a.tot ^ b.sy ^ b.lt ^ b.tot ^ escapes ^ active;
  }
  if (acc == 0x9E3779B9u) sy[orow] = static_cast<int32_t>(acc);
'''),
        ('range_encode.cu', '    if (tok_n < cap) {',
         '    if (tok_n < cap && byte == 0x1FFu) {')],
    'no_rescale': [
        ('fenwick_encode.cu',
         '  if ((t[1] >> fenwick::kSymShift) >= max_prob) '
         'fenwick::rescale(t, N);\n', '')],
    'lane_a_block': [
        ('fenwick_encode.cu',
         '    const int lanes = fenwick::lanes_per_block(max_n);',
         '    const int lanes = 1;')],
    'leaf_only': [
        ('fenwick_encode.cu',
         '''    while (i > 1) {  // at most depth steps: i < 2 * max_n
      if (i & 1) lt += t[i - 1];
      t[i] += update;
      i >>= 1;
    }''', '    t[i] += update;')],
}


def build_variants(tree, out_dir):
    """Each variant's sources compiled (all nvcc runs at once) into its
    own library; returns {variant: ctypes library}."""
    csrc = os.path.join(tree, 'compressjs_tpu_torch', 'csrc')
    nvcc = _cuda._nvcc()
    procs = {}
    for name, edits in EDITS.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        srcs = {}
        for f in ('fenwick_encode.cu', 'range_encode.cu', 'fenwick_tree.cuh'):
            with open(os.path.join(csrc, f)) as fh:
                srcs[f] = fh.read()
        for f, old, new in edits:
            if old not in srcs[f]:
                raise RuntimeError('%s: edit of %s not found' % (name, f))
            srcs[f] = srcs[f].replace(old, new)
        for f, text in srcs.items():
            with open(os.path.join(vdir, f), 'w') as fh:
                fh.write(text)
        so = os.path.join(vdir, 'lib.so')
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_cuda.ARCH, '-std=c++17', '-O3', '-Xcompiler', '-fPIC',
             '-shared', '-o', so, os.path.join(vdir, 'fenwick_encode.cu'),
             os.path.join(vdir, 'range_encode.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, out))
        lib = ctypes.CDLL(so)
        lib.cz_fenwick_encode.argtypes = [p, p, p, i32, i64, i32, i32, i32,
                                          p, p, p, p, p, p]
        lib.cz_range_encode.argtypes = [p, p, p, p, p, i32, i64, p, i64, p,
                                        p, p]
        libs[name] = lib
    return libs


def shapes(dev):
    """{shape name: (syms, valid, Ns, init)} at the paths' shapes."""
    s5 = cs.golden('sample5_bzip2_9.bz2')[1]
    s5x4 = cs.golden('sample5x4_bzip2_9.bz2')[1]
    inp = cs.scan_inputs(s5, dev)
    lsyms, lvalid, lNs = inp['L']
    zeros = torch.zeros(lsyms.shape[0], dtype=torch.int64, device=dev)
    return {'bwtcl_128x7032': (lsyms, lvalid, lNs,
                               dc.encoder_states(zeros, zeros)),
            'bwtcp_1x900001': inp['P'],
            'bwtcp_8x900001': cs.dispatch_inputs(s5x4, dev)}


def time_model(lib, syms, valid, Ns, reps, dev):
    """ms of one cz_fenwick_encode of `lib`, and its outputs."""
    L, T = syms.shape
    s32, v8 = syms.contiguous(), valid.to(torch.uint8).contiguous()
    outs = [torch.empty((L, 2 * T), dtype=torch.int32, device=dev)
            for _ in range(3)]
    vo = torch.empty((L, 2 * T), dtype=torch.uint8, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = _cuda.stream_handle(dev)

    def launch():
        _cuda.check(lib.cz_fenwick_encode(
            s32.data_ptr(), v8.data_ptr(), Ns.data_ptr(), L, T, MAX_N,
            MAX_PROB, INCR, *(o.data_ptr() for o in outs), vo.data_ptr(),
            err.data_ptr(), stream), 'fenwick_encode')
    return cs.cuda_ms(launch, reps), outs + [vo]


def time_coder(lib, trip, init, cap, reps, dev):
    L, T2 = trip[0].shape
    v8 = trip[3].to(torch.uint8).contiguous()
    tokens = torch.zeros((L, cap, 3), dtype=torch.int32, device=dev)
    tok_n = torch.empty(L, dtype=torch.int32, device=dev)
    nbytes = torch.empty(L, dtype=torch.int64, device=dev)
    init = init.contiguous()
    stream = _cuda.stream_handle(dev)

    def launch():
        _cuda.check(lib.cz_range_encode(
            trip[0].data_ptr(), trip[1].data_ptr(), trip[2].data_ptr(),
            v8.data_ptr(), init.data_ptr(), L, T2, tokens.data_ptr(), cap,
            tok_n.data_ptr(), nbytes.data_ptr(), stream), 'range_encode')
    return cs.cuda_ms(launch, reps)


def time_fused(syms, valid, Ns, init, cap, reps, dev):
    lib = _cuda.lib()
    L, T = syms.shape
    s32, v8 = syms.contiguous(), valid.to(torch.uint8).contiguous()
    tokens = torch.zeros((L, cap, 3), dtype=torch.int32, device=dev)
    tok_n = torch.empty(L, dtype=torch.int32, device=dev)
    nbytes = torch.empty(L, dtype=torch.int64, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    init = init.contiguous()
    stream = _cuda.stream_handle(dev)

    def launch():
        _cuda.check(lib.cz_fenwick_code(
            s32.data_ptr(), v8.data_ptr(), Ns.data_ptr(), L, T, MAX_N,
            MAX_PROB, INCR, init.data_ptr(), tokens.data_ptr(), cap,
            tok_n.data_ptr(), nbytes.data_ptr(), err.data_ptr(), stream),
            'fenwick_code')
    return cs.cuda_ms(launch, reps)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', required=True)
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_scan_split: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    card = cs.card_line()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(os.path.abspath(args.root), tmp)
        res = {'card': card, 'shapes': {}}
        for name, (syms, valid, Ns, init) in shapes(dev).items():
            L, T = syms.shape
            end = int(torch.nonzero(valid.any(0))[-1]) + 1
            cap = 2 * T + 8 if L > 1 and T < 10000 else \
                900000 + (900000 >> 2) + 64
            r = {'lanes': L, 'steps': T, 'last_valid_step': end - 1,
                 'valid_steps': int(valid.sum()), 'model_ms': {},
                 'coder_ms': {}}
            cut = (syms[:, :end].contiguous(), valid[:, :end].contiguous())
            trip = trip_cut = None
            for v, lib in libs.items():
                r['model_ms'][v], outs = time_model(lib, syms, valid, Ns,
                                                    args.reps, dev)
                if v == 'base':
                    trip = outs
                    r['model_ms']['tail'], outs_cut = time_model(
                        lib, *cut, Ns, args.reps, dev)
                    trip_cut = outs_cut
            for v in ('base', 'no_stores'):
                r['coder_ms'][v] = time_coder(libs[v], trip, init, cap,
                                              args.reps, dev)
            r['coder_ms']['tail'] = time_coder(libs['base'], trip_cut, init,
                                               cap, args.reps, dev)
            # the current kernels on the same inputs
            cur, _ = time_model(_cuda.lib(), syms, valid, Ns, args.reps, dev)
            r['current_ms'] = {
                'fenwick_encode': cur,
                'range_encode': time_coder(_cuda.lib(), trip, init, cap,
                                           args.reps, dev),
                'fenwick_code': time_fused(syms, valid, Ns, init, cap,
                                           args.reps, dev)}
            m, c = r['model_ms'], r['coder_ms']
            r['split_ms'] = {
                'model_masked_tail': m['base'] - m['tail'],
                'model_stores': m['base'] - m['no_stores'],
                'model_rescales': m['base'] - m['no_rescale'],
                'model_lanes_sharing_a_warp': m['base'] - m['lane_a_block'],
                'model_walk_above_the_leaf': m['base'] - m['leaf_only'],
                'coder_masked_tail': c['base'] - c['tail'],
                'coder_stores': c['base'] - c['no_stores']}
            res['shapes'][name] = r
            print(name, json.dumps(r), flush=True)
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    with open(os.path.join(ROOT, 'chiprun_out', 'scan_split.json'), 'w') as f:
        json.dump(res, f, indent=1)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
