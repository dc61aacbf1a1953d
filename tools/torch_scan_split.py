#!/usr/bin/env python3
"""Split a step of a Fenwick scan kernel's earlier design by cause, on
one CUDA card, and time the current kernels beside it.

    python3 tools/torch_scan_split.py --root _archive/parent [--reps 3]
    python3 tools/torch_scan_split.py --mode decode --root _archive/dec

--mode encode (the default) splits the one-thread-a-lane Fenwick
encode and range-coder kernels (``csrc/fenwick_encode.cu`` and
``csrc/range_encode.cu`` before the warp-a-lane redesign); --root is a
tree that still has those two sources, the commit f109d86 unpacked into
a git-ignored directory (``mkdir -p _archive/parent && git archive
f109d86 | tar -x -C _archive/parent``).  --mode decode splits the
one-thread-a-lane Fenwick decode (``csrc/fenwick_decode.cu`` before the
block-a-lane redesign, 16 lanes a block); --root is the commit f50b162
unpacked the same way.  On any other tree the edits below are not found
and the script stops.  The script builds variants of the sources, each
with one cause taken out, and times every variant by CUDA events at the
BWTC paths' shapes (sample5's first -9 block as BWTC-L's 128 lanes of
7,032 steps and as the 1 x 900,001 BWTC-P lane, and the 8 x 900,001
BWTC-P dispatch of sample5x4's first 8 blocks: with the host's header
states for the encode, coded from fresh coder states for the decode, so
that it decodes a real stream).

Encode variants:

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

Decode variants:

* base: the kernel as it was;
* tail: the base at each lane's last valid step (the inputs cut there);
* lane_a_block: one lane a block instead of 16;
* staged_bytes: one lane a block (so that a row fits), the lane's row
  (up to 200 KB of it) copied to shared memory by 128 threads before
  the loop, the same reads past the row; staged_bytes - lane_a_block is
  what the global byte loads cost;
* update_after: a read-only root -> leaf descent, then the update added
  along the found path (the same bits);
* no_rescale: no rescale test.

The variants' outputs are not used: each only removes work.  Then the
current package's kernels at the same shapes: the three encode entries
(``cz_fenwick_encode``, ``cz_range_encode``, ``cz_fenwick_code``), or
the decode (``cz_fenwick_decode``) at each tree-level count a descent
round takes (``CZ_DECODE_LEVELS`` 1 to 5, the package's build being
one of them).  Prints one JSON line (also written to
chiprun_out/scan_split.json, or scan_split_decode.json) with every
time, the card's name and power limit.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from compressjs_tpu_torch.ops import _cuda  # noqa: E402
from compressjs_tpu_torch.ops import device_coder as dc  # noqa: E402
from compressjs_tpu_torch.ops import device_model as dm  # noqa: E402

MAX_N, MAX_PROB, INCR = 258, 0xFF00, 0x100

# (file, old text, new text) edits of each variant; every old text must
# be found in the source
ENCODE_EDITS = {
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

# the one-thread-a-lane decode's launch (16 lanes a block) and the top of
# its root -> leaf walk
_DEC_LAUNCH = '''    const int lanes = fenwick::lanes_per_block(max_n);
    const int threads = L < lanes ? L : lanes;
    const size_t smem = sizeof(uint32_t) * 2 * max_n * threads;
    fenwick_decode_kernel<<<(L + threads - 1) / threads, threads, smem,
'''
_DEC_STAGED_LAUNCH = '''    const int threads = 128;
    const size_t smem = sizeof(uint32_t) * 2 * max_n + kStageCap;
    cudaFuncSetAttribute(fenwick_decode_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    fenwick_decode_kernel<<<L, threads, smem,
'''
_DEC_LANE = '''  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const Tree t{smem + threadIdx.x, static_cast<int>(blockDim.x)};
'''
_DEC_STAGED_LANE = '''  const int l = blockIdx.x;
  const Tree t{smem, 1};
  uint8_t* staged = reinterpret_cast<uint8_t*>(smem + 2 * max_n);
  const int64_t nst = B < kStageCap ? B : kStageCap;
  for (int64_t i = threadIdx.x; i < nst; i += blockDim.x) {
    staged[i] = payload[static_cast<int64_t>(l) * B + i];
  }
  __syncthreads();
  if (threadIdx.x) return;
'''
_DEC_WALK = '''  while (i < N) {  // at most depth steps: N <= max_n
    t[i] += update;
'''

DECODE_EDITS = {
    'base': [],
    'lane_a_block': [
        ('fenwick_decode.cu',
         '    const int lanes = fenwick::lanes_per_block(max_n);',
         '    const int lanes = 1;')],
    'staged_bytes': [
        ('fenwick_decode.cu', 'constexpr int kExtraBits = 7;\n',
         'constexpr int kExtraBits = 7;\n'
         'constexpr int64_t kStageCap = 200 * 1024;\n'),
        ('fenwick_decode.cu',
         "  const uint8_t* bytes;  // the lane's payload row\n",
         "  const uint8_t* bytes;  // the lane's payload row\n"
         '  const uint8_t* sb;\n  int64_t ns;\n'),
        ('fenwick_decode.cu',
         '      const uint32_t nxt = pos < len ? bytes[pos] : 0xFFFFFFFFu;',
         '      const uint32_t nxt =\n'
         '          pos < len ? (pos < ns ? sb[pos] : bytes[pos]) : '
         '0xFFFFFFFFu;'),
        ('fenwick_decode.cu', _DEC_LANE, _DEC_STAGED_LANE),
        ('fenwick_decode.cu', '  d.len = B;\n',
         '  d.len = B;\n  d.sb = staged;\n  d.ns = nst;\n'),
        ('fenwick_decode.cu', _DEC_LAUNCH, _DEC_STAGED_LAUNCH)],
    'update_after': [
        ('fenwick_decode.cu', _DEC_WALK,
         '  while (i < N) {  // at most depth steps: N <= max_n\n'),
        ('fenwick_decode.cu',
         '  t[i] += update;\n  const uint32_t tmp = help * lt;\n',
         '  t[i] += update;\n'
         '  for (int j = i >> 1; j >= 1; j >>= 1) t[j] += update;\n'
         '  const uint32_t tmp = help * lt;\n')],
    'no_rescale': [
        ('fenwick_decode.cu',
         '  if ((t[1] >> fenwick::kSymShift) >= max_prob) '
         'fenwick::rescale(t, N);\n', '')],
}

ENCODE_FILES = ('fenwick_encode.cu', 'range_encode.cu', 'fenwick_tree.cuh')
DECODE_FILES = ('fenwick_decode.cu', 'fenwick_tree.cuh')
# tree levels a descent round of the current decode takes, each built
DECODE_LEVELS = (1, 2, 3, 4, 5)


def _nvcc_lib(vdir, srcs, defines=()):
    """nvcc started on `srcs` (paths) into vdir/lib.so: (path, process)."""
    so = os.path.join(vdir, 'lib.so')
    return so, subprocess.Popen(
        [_cuda._nvcc(), *_cuda.ARCH, '-std=c++17', '-O3', '-Xcompiler',
         '-fPIC', '-shared', *('-D' + d for d in defines), '-o', so, *srcs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_variants(tree, out_dir, edits_of, files, extra=None):
    """Each variant's sources (`files` of tree's csrc/, with its edits)
    compiled into its own library, and each `extra` {name: (source
    paths, defines)} library beside them, all nvcc runs at once; returns
    {name: ctypes library}."""
    csrc = os.path.join(tree, 'compressjs_tpu_torch', 'csrc')
    procs = {}
    for name, edits in edits_of.items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        srcs = {}
        for f in files:
            with open(os.path.join(csrc, f)) as fh:
                srcs[f] = fh.read()
        for f, old, new in edits:
            if old not in srcs[f]:
                raise RuntimeError('%s: edit of %s not found' % (name, f))
            srcs[f] = srcs[f].replace(old, new)
        for f, text in srcs.items():
            with open(os.path.join(vdir, f), 'w') as fh:
                fh.write(text)
        procs[name] = _nvcc_lib(vdir, [os.path.join(vdir, f) for f in files
                                       if f.endswith('.cu')])
    for name, (srcs, defines) in (extra or {}).items():
        vdir = os.path.join(out_dir, name)
        os.makedirs(vdir, exist_ok=True)
        procs[name] = _nvcc_lib(vdir, srcs, defines)
    libs = {}
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError('nvcc failed on %s:\n%s' % (name, out))
        lib = ctypes.CDLL(so)
        if hasattr(lib, 'cz_fenwick_encode'):
            lib.cz_fenwick_encode.argtypes = [p, p, p, i32, i64, i32, i32,
                                              i32, p, p, p, p, p, p]
        if hasattr(lib, 'cz_range_encode'):
            lib.cz_range_encode.argtypes = [p, p, p, p, p, i32, i64, p, i64,
                                            p, p, p]
        if hasattr(lib, 'cz_fenwick_decode'):
            lib.cz_fenwick_decode.argtypes = [p, i64, p, p, p, i32, i64,
                                              i32, i32, i32, p, p, p]
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


def decode_shapes(dev):
    """{shape name: (payload, state, Ns, valid, symbols)}: the encode's
    shapes coded by the package's fused entry from fresh coder states,
    each payload row cut at the longest lane (the EOF byte), the states
    decode_start's at byte 1."""
    out = {}
    for name, (syms, valid, Ns, _) in shapes(dev).items():
        L, T = syms.shape
        zeros = torch.zeros(L, dtype=torch.int64, device=dev)
        cap = 2 * T + 8 if L > 1 and T < 10000 else \
            900000 + (900000 >> 2) + 64
        tok = dm.fenwick_code_streams(syms, valid, Ns, MAX_N, MAX_PROB, INCR,
                                      dc.encoder_states(zeros, zeros), cap)
        byts, lens = dc.token_bytes(*tok, 3 * T + 64)
        byts = byts[:, :int(lens.max())].contiguous()
        st = torch.stack(dc.dec_start_state(byts, zeros + 1), 1)
        out[name] = (byts, torch.stack(dm._dec_states(st), 1).contiguous(),
                     Ns.to(torch.int32).contiguous(),
                     valid.to(torch.uint8).contiguous(), syms)
    return out


def time_decode(lib, byts, st0, Ns, v8, reps, dev):
    """(ms of one cz_fenwick_decode of `lib`, its symbols)."""
    L, B = byts.shape
    T = v8.shape[1]
    st = st0.clone()
    out = torch.empty((L, T), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = _cuda.stream_handle(dev)

    def launch():
        st.copy_(st0)
        _cuda.check(lib.cz_fenwick_decode(
            byts.data_ptr(), B, st.data_ptr(), Ns.data_ptr(), v8.data_ptr(),
            L, T, MAX_N, MAX_PROB, INCR, out.data_ptr(), err.data_ptr(),
            stream), 'fenwick_decode')
    ms = cs.cuda_ms(launch, reps)
    if int(err):
        raise AssertionError('fenwick_decode flagged its input')
    return ms, out


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


def split_encode(root, tmp, reps, dev):
    libs = build_variants(root, tmp, ENCODE_EDITS, ENCODE_FILES)
    res = {}
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
            r['model_ms'][v], outs = time_model(lib, syms, valid, Ns, reps,
                                                dev)
            if v == 'base':
                trip = outs
                r['model_ms']['tail'], trip_cut = time_model(
                    lib, *cut, Ns, reps, dev)
        for v in ('base', 'no_stores'):
            r['coder_ms'][v] = time_coder(libs[v], trip, init, cap, reps,
                                          dev)
        r['coder_ms']['tail'] = time_coder(libs['base'], trip_cut, init, cap,
                                           reps, dev)
        # the current kernels on the same inputs
        cur, _ = time_model(_cuda.lib(), syms, valid, Ns, reps, dev)
        r['current_ms'] = {
            'fenwick_encode': cur,
            'range_encode': time_coder(_cuda.lib(), trip, init, cap, reps,
                                       dev),
            'fenwick_code': time_fused(syms, valid, Ns, init, cap, reps,
                                       dev)}
        m, c = r['model_ms'], r['coder_ms']
        r['split_ms'] = {
            'model_masked_tail': m['base'] - m['tail'],
            'model_stores': m['base'] - m['no_stores'],
            'model_rescales': m['base'] - m['no_rescale'],
            'model_lanes_sharing_a_warp': m['base'] - m['lane_a_block'],
            'model_walk_above_the_leaf': m['base'] - m['leaf_only'],
            'coder_masked_tail': c['base'] - c['tail'],
            'coder_stores': c['base'] - c['no_stores']}
        res[name] = r
        print(name, json.dumps(r), flush=True)
    return res


def split_decode(root, tmp, reps, dev):
    cur = os.path.join(ROOT, 'compressjs_tpu_torch', 'csrc',
                       'fenwick_decode.cu')
    with open(cur) as f:
        has_levels = 'CZ_DECODE_LEVELS' in f.read()
    extra = {'current_k%d' % k: ([cur], ['CZ_DECODE_LEVELS=%d' % k])
             for k in (DECODE_LEVELS if has_levels else ())}
    if has_levels:
        # block 0 prints its chain's cycles by part (times not comparable)
        extra['current_profile'] = ([cur], ['CZ_DECODE_PROFILE=1'])
    libs = build_variants(root, tmp, DECODE_EDITS, DECODE_FILES, extra)
    res = {}
    for name, (byts, st0, Ns, v8, syms) in decode_shapes(dev).items():
        L, T = v8.shape
        end = int(torch.nonzero(v8.any(0))[-1]) + 1
        valid = v8.bool()
        r = {'lanes': L, 'steps': T, 'last_valid_step': end - 1,
             'valid_steps': int(valid.sum()), 'payload_bytes': byts.shape[1],
             'decode_ms': {}, 'decodes_to_symbols': {}}
        for v, lib in libs.items():
            r['decode_ms'][v], out = time_decode(lib, byts, st0, Ns, v8,
                                                 reps, dev)
            r['decodes_to_symbols'][v] = bool(torch.equal(out[valid],
                                                          syms[valid]))
            if v == 'base':
                r['decode_ms']['tail'], _ = time_decode(
                    lib, byts, st0, Ns, v8[:, :end].contiguous(), reps, dev)
        r['decode_ms']['current'], out = time_decode(
            _cuda.lib(), byts, st0, Ns, v8, reps, dev)
        r['decodes_to_symbols']['current'] = bool(
            torch.equal(out[valid], syms[valid]))
        d = r['decode_ms']
        r['split_ms'] = {
            'masked_tail': d['base'] - d['tail'],
            'lanes_sharing_a_warp': d['base'] - d['lane_a_block'],
            'global_byte_loads': d['lane_a_block'] - d['staged_bytes'],
            'read_add_write_descent': d['base'] - d['update_after'],
            'rescales': d['base'] - d['no_rescale']}
        for v, ok in r['decodes_to_symbols'].items():
            if v != 'no_rescale' and not ok:
                raise AssertionError('%s: %s does not decode to its symbols'
                                     % (name, v))
        res[name] = r
        print(name, json.dumps(r), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', required=True)
    ap.add_argument('--mode', choices=('encode', 'decode'), default='encode')
    ap.add_argument('--reps', type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_scan_split: no CUDA device', file=sys.stderr)
        return 1
    dev = torch.device('cuda')
    card = cs.card_line()
    split = split_encode if args.mode == 'encode' else split_decode
    with tempfile.TemporaryDirectory() as tmp:
        res = {'card': card, 'mode': args.mode,
               'shapes': split(os.path.abspath(args.root), tmp, args.reps,
                               dev)}
    os.makedirs(os.path.join(ROOT, 'chiprun_out'), exist_ok=True)
    name = 'scan_split.json' if args.mode == 'encode' else \
        'scan_split_decode.json'
    with open(os.path.join(ROOT, 'chiprun_out', name), 'w') as f:
        json.dump(res, f, indent=1)
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
