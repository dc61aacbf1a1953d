#!/usr/bin/env python3
"""Window and stage settings of the staged selector chase, on one CUDA
card.

    python3 tools/torch_chase_profile.py [--out PATH]

Builds ``compressjs_tpu_torch/csrc/selector_chase.cu`` as the package
does and with other window sizes and ring depths (the same 192 KB of
shared memory), each with its profiling counters on (the macros
CZ_CHASE_WINDOW_LOG, CZ_CHASE_STAGES and CZ_CHASE_PROFILE), and times
each on the chase of sample5's first -9 block at k = 50 and k = 10,
checked against the plain chase.  For each it reports the kernel's
device ms, the walking thread's clock cycles (in all, and the share
spent waiting for a window), its window changes, and the ns per step
of a chain that never leaves window 0 (the walker's own cost per step,
with no copies in flight).  Beside them: one thread's chain of
dependent shared-memory loads at the same step count.

Prints one JSON object with the card's name and power limit, and also
writes it to --out when given.
"""

import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (positions per window, windows in flight): kW * kStages is the same
VARIANTS = [(4096, 2), (2048, 4), (1024, 8)]


def build_variants(_cuda):
    """One library per variant, built through the package's build."""
    libs = {}
    for window, stages in VARIANTS:
        path = _cuda._build(('selector_chase.cu',), (
            'CZ_CHASE_WINDOW_LOG=%d' % (window.bit_length() - 1),
            'CZ_CHASE_STAGES=%d' % stages, 'CZ_CHASE_PROFILE=1'))
        lib = ctypes.CDLL(path)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cz_selector_chase.argtypes = [ptr, ptr, ptr, i32, ctypes.c_int64,
                                          i32, i32, ptr, ptr]
        lib.cz_selector_chase.restype = i32
        libs['%dx%d' % (window, stages)] = lib
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', help='also write the JSON here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('torch_chase_profile: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from compressjs_tpu_torch.ops import _cuda
    from compressjs_tpu_torch.ops import device_huffman as dh
    dev = torch.device('cuda')
    libs = build_variants(_cuda)
    stream = _cuda.stream_handle(dev)

    def run(name, lib, F, sel, sub, want):
        out = torch.empty_like(sel)
        stats = torch.zeros(8, dtype=torch.int64, device=dev)

        def launch():
            _cuda.check(lib.cz_selector_chase(
                F.data_ptr(), sel.data_ptr(), out.data_ptr(), F.shape[0],
                F.shape[1], sel.shape[0], sub, stats.data_ptr(), stream),
                'selector_chase')

        ms = cs.cuda_ms(launch, 10)
        if not torch.equal(out, want):
            raise AssertionError('chase variant differs from the plain chase')
        staged, _, window, stages, cycles, wait, _, advances = stats.tolist()
        if '%dx%d' % (window, stages) != name:
            raise AssertionError('variant %s built as %dx%d'
                                 % (name, window, stages))
        return {'ms': ms, 'cycles': cycles, 'wait_share': wait / cycles,
                'window_changes': advances, 'staged_bytes': staged}

    comp, _ = cs.golden('sample5_bzip2_9.bz2')
    walk, _ = cs.first_block_walk(comp, dev)
    result = {'card': cs.card_line(), 'device': torch.cuda.get_device_name(0),
              'chases': {}}
    for k in (50, 10):
        _, _, F, sel, sub = cs.first_block_maps(walk, k)
        want = dh.selector_chase_plain(F, sel, sub)
        steps = sel.shape[0] * sub
        row = {'steps': steps,
               'smem_chain_ms': cs.smem_chain_ms(steps, dev)[0]}
        for name, lib in libs.items():
            row[name] = run(name, lib, F, sel, sub, want)
        result['chases']['k=%d' % k] = row
        del F
    # a chain that stays in window 0: every step reads the ring, no copy
    # after the first is in flight
    G, cap, n = 6, 1 << 20, 5875
    pos = torch.arange(cap, device=dev, dtype=torch.int32)
    F = ((pos & ~4095) + ((pos + 97) & 1023)).repeat(G, 1).contiguous()
    sel = torch.arange(n, device=dev, dtype=torch.int32) % G
    want = dh.selector_chase_plain(F, sel, 1)
    result['in_window'] = {}
    for name, lib in libs.items():
        r = run(name, lib, F, sel, 1, want)
        r['ns_per_step'] = r['ms'] * 1e6 / n
        result['in_window'][name] = r
    text = json.dumps(result, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(text + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
