"""compressjs_tpu_torch's CUDA kernels on the card, each against its
plain version, and the -9 golden through the whole encode and decode on
the card.
Run on a machine with a CUDA card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX, which a machine with
only the port need not have.)  Without a card every test here skips."""

import bz2
import os
import threading

import numpy as np
import pytest
import torch

import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bzip2_parse as bp
from compressjs_tpu_torch.ops import _cuda
from compressjs_tpu_torch.ops import block_decode as bd
from compressjs_tpu_torch.ops import block_kernels as bk
from compressjs_tpu_torch.ops import compose as cm
from compressjs_tpu_torch.ops import device_entropy as de
from compressjs_tpu_torch.ops import device_huffman as dh
from compressjs_tpu_torch.parallel import decode as dec
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

pytestmark = pytest.mark.cuda

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


@pytest.mark.parametrize('width,n', [(256, 899981), (64, 5000), (256, 1)])
def test_mtf_kernel_matches_plain(cuda, width, n):
    rng = np.random.default_rng(n)
    d = torch.from_numpy(np.minimum(rng.zipf(1.3, n) - 1, width - 1)
                         .astype(np.int32)).to(cuda)
    before = _cuda.launches['mtf_scan']
    got = bk.mtf_encode(d, n)
    assert _cuda.launches['mtf_scan'] == before + 3
    assert torch.equal(got.cpu(), bk.mtf_encode_plain(d.cpu(), n))


def _cycle(period, n):
    return (np.arange(n) % period).astype(np.int32)


def _mtf_encode_case(case):
    """(symbols int32, n): the warp design's edge cases."""
    rng = np.random.default_rng(len(case))
    if case == 'runs':
        d = np.repeat(rng.integers(0, 40, 400), rng.integers(1, 90, 400))
        return d.astype(np.int32), len(d)
    if case in ('j31', 'j32', 'j255'):
        return _cycle(int(case[1:]) + 1, 9000), 9000
    if case == 'short':
        return np.array([5, 5, 3, 200, 5, 0, 0, 7], np.int32), 8
    if case == 'ragged':
        n = 40 * bk.CHUNK_LEN + 77
        return np.minimum(rng.zipf(1.2, n) - 1, 255).astype(np.int32), n
    if case == 'run_across_edges':
        c, t = bk.CHUNK_LEN, bk.TILE_CHUNKS * bk.CHUNK_LEN
        d = rng.integers(0, 256, 40 * c + 40)
        d[c - 12:c + 18] = 9
        d[60:70] = 4
        d[t - 3:t + 40] = 11
        return d.astype(np.int32), len(d)
    if case == 'uniform':
        return rng.integers(0, 256, 899981).astype(np.int32), 899981
    if case == 'zipf':
        return np.minimum(rng.zipf(1.3, 899981) - 1, 255).astype(
            np.int32), 899981
    raise ValueError(case)


@pytest.mark.parametrize('case', ['runs', 'j31', 'j32', 'j255', 'short',
                                  'ragged', 'run_across_edges', 'uniform',
                                  'zipf'])
def test_mtf_encode_edge_cases(cuda, case):
    d, n = _mtf_encode_case(case)
    got = bk.mtf_encode(torch.from_numpy(d).to(cuda), n)
    want = bk.mtf_encode_plain(torch.from_numpy(d), n)
    assert torch.equal(got.cpu(), want)
    if case in ('j31', 'j32', 'j255'):
        assert int(want[-1]) == int(case[1:])


def _kernels_launched(fn):
    """Device kernels one call of fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith('Memcpy')
               and not e.name.startswith('Memset'))


def test_mtf_stages_launch_three_kernels(cuda):
    """Each MTF stage is three launches of its own source and nothing
    else on the card (the profiler may miss a launch, never add one)."""
    rng = np.random.default_rng(8)
    d = torch.from_numpy(np.minimum(rng.zipf(1.3, 899981) - 1, 255)
                         .astype(np.int32)).to(cuda)
    for fn, counter in ((lambda: bk.mtf_encode(d, 899981), 'mtf_scan'),
                        (lambda: bd.mtf_decode(d, 899981), 'mtf_undo')):
        before = _cuda.launches[counter]
        fn()
        assert _cuda.launches[counter] - before == 3
        assert _kernels_launched(fn) <= 3


def test_mtf_start_list_kernels_match_plain(cuda):
    """The first two launches of each direction against the plain start
    lists: the encode's tile last occurrences and their prefix, the
    decode's chunk permutations and tile lists."""
    lib = _cuda.lib()
    stream = _cuda.stream_handle(cuda)
    d, n = _mtf_encode_case('ragged')
    dd = torch.from_numpy(d).to(cuda)
    chunks = -(-n // bk.CHUNK_LEN)
    tiles = -(-chunks // bk.TILE_CHUNKS)
    agg = torch.empty((tiles, 256), dtype=torch.int32, device=cuda)
    pre = torch.empty_like(agg)
    _cuda.check(lib.cz_mtf_encode_tiles(dd.data_ptr(), agg.data_ptr(), n,
                                        chunks, stream), 'mtf_scan')
    _cuda.check(lib.cz_mtf_encode_prefix(agg.data_ptr(), pre.data_ptr(),
                                         tiles, stream), 'mtf_scan')
    # each symbol's last position in each chunk, positions < n only
    last = np.full((tiles * bk.TILE_CHUNKS, 256), -1, dtype=np.int64)
    np.maximum.at(last, (np.arange(n) // bk.CHUNK_LEN, d), np.arange(n))
    assert torch.equal(agg.cpu().long(), torch.from_numpy(
        last.reshape(tiles, bk.TILE_CHUNKS, 256).max(1)))
    assert torch.equal(pre.cpu().long(), bk._last_before(
        torch.from_numpy(last[:chunks]))[::bk.TILE_CHUNKS])
    idx = torch.from_numpy(np.minimum(np.random.default_rng(2).zipf(
        1.3, n) - 1, 300).astype(np.int32)).to(cuda)
    chunks = -(-n // bd.CHUNK_LEN)
    tiles = -(-chunks // bd.TILE_CHUNKS)
    perm = torch.empty((chunks, 256), dtype=torch.uint8, device=cuda)
    tagg = torch.empty((tiles, 256), dtype=torch.uint8, device=cuda)
    tl = torch.empty_like(tagg)
    _cuda.check(lib.cz_mtf_undo_perm(idx.data_ptr(), perm.data_ptr(),
                                     tagg.data_ptr(), n, chunks, stream),
                'mtf_undo')
    _cuda.check(lib.cz_mtf_undo_prefix(tagg.data_ptr(), tl.data_ptr(),
                                       tiles, stream), 'mtf_undo')
    _, pperm = bd._chunk_perms(idx.cpu(), n)
    assert torch.equal(perm.cpu(), pperm)
    assert torch.equal(tl.cpu(), bd._start_lists(pperm)[::bd.TILE_CHUNKS])


def test_alloc_kernel_matches_plain(cuda):
    rng = np.random.default_rng(0)
    fib = [1, 1]
    while len(fib) < 29:
        fib.append(fib[-1] + fib[-2])
    tables = [fib[:22], fib, [5] * 258, [7], [1, 2], [0, 0, 4]]
    tables += [sorted(rng.integers(0, 3000, m).tolist())
               for m in (17, 130, 258)]
    arrs = torch.zeros(len(tables), de.N, dtype=torch.int32)
    for i, t in enumerate(tables):
        arrs[i, :len(t)] = torch.tensor(t)
    ms = torch.tensor([len(t) for t in tables], dtype=torch.int32)
    got = de.alloc_lengths(arrs.to(cuda), ms.to(cuda))
    assert torch.equal(got.cpu(), de.alloc_lengths_plain(arrs, ms)[0])


def test_wrappers_reject_bad_input(cuda):
    d = torch.zeros(100, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        bk.mtf_encode(d, 100)
    with pytest.raises(ValueError):
        bk.mtf_encode(d.int(), 101)
    with pytest.raises(ValueError):
        de.alloc_lengths(torch.zeros(2, 10, dtype=torch.int32, device=cuda),
                         torch.ones(2, dtype=torch.int32, device=cuda))
    freqs = torch.ones(2, de.N, dtype=torch.int32, device=cuda)
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        de.code_lengths_batch(freqs[:, :10], 5, err)
    with pytest.raises(ValueError):
        de.code_lengths_batch(freqs, de.N + 1, err)
    with pytest.raises(ValueError):
        de.code_lengths_batch(freqs.long(), 5, err)
    with pytest.raises(ValueError):
        de.code_lengths_batch(freqs, 5, err.cpu())
    with pytest.raises(ValueError):
        de.code_lengths_batch(freqs, 5, torch.zeros(2, dtype=torch.int32,
                                                    device=cuda))


def test_golden_sample5_on_card(cuda):
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    before = dict(_cuda.launches)
    assert cz.compress_file_device(bz2.decompress(gold), level=9) == gold
    assert _cuda.launches['mtf_scan'] - before['mtf_scan'] == 3 * 3
    # the table builds are one fused launch each, up to 9 a block
    assert _cuda.launches['code_lengths'] - before['code_lengths'] >= 3
    assert _cuda.launches['alloc_lengths'] == before['alloc_lengths']


@pytest.mark.parametrize('kw', [{'mode': 'full'}, {'mode': 'core'},
                                {'mode': 'hybrid'},
                                {'mode': 'hybrid', 'batch': True},
                                {'mode': 'hybrid', 'self_check': True}])
def test_modes_golden_sample5_on_card(cuda, kw):
    """Each split re-encodes the -9 golden; 'core' launches the MTF
    kernel 3 times a block and builds its tables on the host, 'hybrid'
    launches neither."""
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    before = dict(_cuda.launches)
    enc = cz.DeviceBzip2Encoder(9, **kw)
    assert enc.compress(bz2.decompress(gold)) == gold
    mtf = _cuda.launches['mtf_scan'] - before['mtf_scan']
    tables = _cuda.launches['code_lengths'] - before['code_lengths']
    if kw['mode'] == 'full':
        assert mtf == 3 * 3 and tables >= 3
    elif kw['mode'] == 'core':
        assert mtf == 3 * 3 and tables == 0
    else:
        assert mtf == 0 and tables == 0


def test_bwt_block_batch_on_card_equals_rows(cuda):
    rng = np.random.default_rng(12)
    blocks = torch.from_numpy(np.stack([
        rng.integers(0, 256, 99981).astype(np.uint8),
        np.frombuffer((b'abcabd' * 20000)[:99981], np.uint8)])).to(cuda)
    U, pidx = bk.bwt_block_batch(blocks, 99981)
    for b in range(2):
        U_b, p_b = bk.bwt_block(blocks[b], 99981)
        assert torch.equal(U[b], U_b) and int(pidx[b]) == int(p_b)


# ---------------------------------------------------------------------------
# csrc/seg_scan.cu: the sorts' group starts and RLE2's running maxima

SCAN_SIZES = [1, 2, bk.SCAN_TILE - 1, bk.SCAN_TILE, bk.SCAN_TILE + 1, 899981,
              (1 << 20) - 1, 8 * 899981]


def _scan_case(kind, n):
    """(flags, values) int64 of one named case: random flags and
    positions, all flags set (values 0..n-1), only flag 0 (values 0), or
    rle2_encode's shapes (its zero flags, its run_start input)."""
    rng = np.random.default_rng(n)
    idx = np.arange(n)
    if kind == 'random':
        return rng.random(n) < 0.3, rng.integers(0, 1 << 40, n)
    if kind == 'all_true':
        return np.ones(n, bool), idx
    if kind == 'first_only':
        flags = np.zeros(n, bool)
        flags[0] = True
        return flags, np.zeros(n, np.int64)
    if kind == 'rle2':
        seq = np.minimum(rng.zipf(1.3, n) - 1, 40)
        seq[n // 3:n // 2] = 0
        return seq == 0, np.where(seq == 0, 0, idx + 1)
    raise ValueError(kind)


@pytest.mark.parametrize('kind', ['random', 'all_true', 'first_only',
                                  'rle2'])
@pytest.mark.parametrize('n', SCAN_SIZES)
def test_seg_scan_kernels_match_cummax(cuda, n, kind):
    flags, vals = _scan_case(kind, n)
    d = torch.from_numpy(flags).to(cuda)
    v = torch.from_numpy(vals.astype(np.int64)).to(cuda)
    before = _cuda.launches['seg_scan']
    got_start, got_max = bk._seg_start(d), bk._max_scan(v)
    assert _cuda.launches['seg_scan'] == before + 2
    pos = torch.arange(n, device=cuda)
    assert torch.equal(got_start,
                       torch.cummax(torch.where(d, pos, 0), 0).values)
    assert torch.equal(got_max, torch.cummax(v, 0).values)


@pytest.mark.parametrize('n', [5, bk.SCAN_TILE + 1, 899981])
def test_seg_scan_kernels_unaligned_and_signed(cuda, n):
    """Inputs 1 and 8 bytes off a 16-byte boundary take the kernels'
    scalar accesses; the max-scan takes any int64."""
    rng = np.random.default_rng(n)
    flags = torch.from_numpy(rng.random(n + 1) < 0.01).to(cuda)[1:]
    vals = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, n + 1,
                                         dtype=np.int64)).to(cuda)[1:]
    pos = torch.arange(n, device=cuda)
    assert torch.equal(bk._seg_start(flags),
                       torch.cummax(torch.where(flags, pos, 0), 0).values)
    assert torch.equal(bk._max_scan(vals), torch.cummax(vals, 0).values)


def test_seg_scan_wrappers_reject_bad_input(cuda):
    before = _cuda.launches['seg_scan']
    for fn, bad in (
            (bk._seg_start, torch.zeros(8, dtype=torch.int64, device=cuda)),
            (bk._seg_start, torch.zeros((2, 8), dtype=torch.bool,
                                        device=cuda)),
            (bk._max_scan, torch.zeros(8, dtype=torch.int32, device=cuda)),
            (bk._max_scan, torch.zeros(16, dtype=torch.int64,
                                       device=cuda)[::2])):
        with pytest.raises(ValueError):
            fn(bad)
    assert _cuda.launches['seg_scan'] == before


@pytest.fixture(scope='module')
def scan_blocks():
    """sample5's first -9 block and an all-equal block (periodic: the
    cyclic sort runs every round), with each path's CPU result."""
    n = 899981
    blocks = {'sample5': np.frombuffer(_sample5()[:n], np.uint8).copy(),
              'equal': np.full(n, 7, np.uint8)}
    cpu = {}
    for name, b in blocks.items():
        t = torch.from_numpy(b)
        mtf = bk.mtf_encode(t.to(torch.int32), n)
        cpu[name] = {'bwt_block': bk.bwt_block(t, n),
                     'bwt_eof_block': bk.bwt_eof_block(t, n),
                     'mtf': mtf, 'rle2_encode': bk.rle2_encode(mtf, n, 257)}
    return n, blocks, cpu


def _same(got, want):
    return all(torch.equal(torch.as_tensor(g).cpu(), torch.as_tensor(w))
               for g, w in zip(got, want))


@pytest.mark.parametrize('fn', ['bwt_block', 'bwt_eof_block', 'rle2_encode'])
@pytest.mark.parametrize('block', ['sample5', 'equal'])
def test_sorts_and_rle2_on_card_equal_cpu(cuda, scan_blocks, fn, block):
    n, blocks, cpu = scan_blocks
    if fn == 'rle2_encode':
        got = bk.rle2_encode(cpu[block]['mtf'].to(cuda), n, 257)
    else:
        got = getattr(bk, fn)(torch.from_numpy(blocks[block]).to(cuda), n)
    assert _same(got, cpu[block][fn])


def test_bwt_block_batch_of_8_on_card_equals_cpu(cuda, scan_blocks):
    n, blocks, cpu = scan_blocks
    names = ['sample5', 'equal'] * 4
    U, pidx = bk.bwt_block_batch(torch.from_numpy(np.stack(
        [blocks[k] for k in names])).to(cuda), n)
    for b, name in enumerate(names):
        assert _same((U[b], pidx[b]), cpu[name]['bwt_block'])


def _kernel_names(fn):
    """Names of the device kernels one call of fn() launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith('Memcpy')
            and not e.name.startswith('Memset')]


def test_seg_scan_launches_per_sort_and_rle2(cuda, scan_blocks, monkeypatch):
    """seg_scan counts one call per sort seed and round and two per
    rle2_encode; no path launches torch.cummax's scan any more, and one
    call is at most three device kernels."""
    from compressjs_tpu_torch import tracer
    n, blocks, cpu = scan_blocks
    b = torch.from_numpy(blocks['sample5']).to(cuda)
    batch = torch.from_numpy(np.stack([blocks['sample5'],
                                       blocks['equal']])).to(cuda)
    mtf = cpu['sample5']['mtf'].to(cuda)
    for fn, per_round in ((lambda: bk.bwt_block(b, n), 1),
                          (lambda: bk.bwt_eof_block(b, n), 1),
                          (lambda: bk.bwt_block_batch(batch, n), 1),
                          (lambda: bk.rle2_encode(mtf, n, 257), 0)):
        timer = tracer.StageTimer(enabled=True)
        monkeypatch.setattr(tracer, '_global_timer', timer)
        before = _cuda.launches['seg_scan']
        fn()
        rounds = timer.counters['sort_rounds']
        want = 1 + rounds if per_round else 2
        assert _cuda.launches['seg_scan'] - before == want
        assert not [k for k in _kernel_names(fn)
                    if 'scan_innermost_dim_with_indices' in k]
    flags = torch.from_numpy(np.random.default_rng(1).random(n) < 0.5)
    flags, vals = flags.to(cuda), mtf.to(torch.int64)
    for fn in (lambda: bk._seg_start(flags), lambda: bk._max_scan(vals)):
        assert len(_kernel_names(fn)) <= 3


@pytest.mark.parametrize('G,cap,blo,bhi', [
    (6, 8192, 2, 40), (2, 8192, 1, 20), (6, 8192, 33, 635),
    (1, 100, 1, 20), (6, 1 << 20, 4, 80)])
def test_compose_kernel_matches_plain(cuda, G, cap, blo, bhi):
    rng = np.random.default_rng(cap + bhi)
    pos = np.arange(cap)[None, :]
    a = np.minimum(pos + rng.integers(blo, bhi + 1, (G, cap)), cap - 1)
    # jumps inside and outside the window, on both sides
    b = np.clip(pos + rng.integers(-blo - 5, 2 * bhi, (G, cap)), 0, cap - 1)
    a, b = (torch.from_numpy(x.astype(np.int32)).to(cuda) for x in (a, b))
    before = _cuda.launches['compose_windowed']
    got = cm.compose_windowed(a, b, blo, bhi)
    assert _cuda.launches['compose_windowed'] == before + 1
    assert torch.equal(got, cm.compose_windowed_plain(a, b, blo, bhi))


@pytest.mark.parametrize('sub', [1, 5, 25])
def test_chase_kernel_matches_plain(cuda, sub):
    rng = np.random.default_rng(sub)
    G, cap, s_cap = 6, 1 << 16, 512
    F = np.minimum(np.arange(cap)[None, :] + rng.integers(
        1, 20 * (50 // sub) + 1, (G, cap)), cap - 1)
    F = torch.from_numpy(F.astype(np.int32)).to(cuda)
    sel = torch.from_numpy(rng.integers(0, G, s_cap).astype(
        np.int32)).to(cuda)
    before = _cuda.launches['selector_chase']
    got = dh.selector_chase(F, sel, sub)
    assert _cuda.launches['selector_chase'] == before + 1
    assert torch.equal(got, dh.selector_chase_plain(F, sel, sub))


def test_decode_wrappers_reject_bad_input(cuda):
    a = torch.zeros(2, 64, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        cm.compose_windowed(a, a, 1, 20)
    with pytest.raises(ValueError):
        cm.compose_windowed(a.int(), a.int(), 5, 2)
    with pytest.raises(ValueError):
        dh.selector_chase(a.int(), torch.zeros(4, dtype=torch.int64,
                                               device=cuda), 5)
    with pytest.raises(ValueError):
        dh.selector_chase(a.int(), torch.zeros(
            dh.CHASE_MAX_SEL + 1, dtype=torch.int32, device=cuda), 1)


def test_decode_golden_sample5_on_card(cuda):
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    before = dict(_cuda.launches)
    assert cz.decompress_file_device(gold) == bz2.decompress(gold)
    assert _cuda.launches['compose_windowed'] - \
        before['compose_windowed'] == 7 * 3
    assert _cuda.launches['selector_chase'] - before['selector_chase'] == 3
    assert _cuda.launches['mtf_undo'] - before['mtf_undo'] == 3 * 3


@pytest.mark.parametrize('n', [899981, 5037, 512, 1])
def test_mtf_undo_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    idx = np.minimum(rng.zipf(1.3, n + 3) - 1, 255).astype(np.int32)
    idx[3::97] = 256      # past the list
    idx[5::89] = -1       # before it
    idx = torch.from_numpy(idx).to(cuda)
    before = _cuda.launches['mtf_undo']
    got = bd.mtf_decode(idx, n)
    assert _cuda.launches['mtf_undo'] == before + 3
    assert torch.equal(got, bd.mtf_decode_plain(idx, n))


def test_mtf_undo_rejects_bad_input(cuda):
    idx = torch.zeros(1000, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bd.mtf_decode(idx.long(), 1000)
    with pytest.raises(ValueError):
        bd.mtf_decode(idx.view(10, 100), 1000)
    with pytest.raises(ValueError):
        bd.mtf_decode(idx[::2], 500)
    with pytest.raises(ValueError):
        bd.mtf_decode(idx, 1001)


def _sample5_first_walk(dev):
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        data = np.frombuffer(f.read(), np.uint8)
    dbuf_size, _, cands, _ = bp._parse_candidates(data)
    return dec._walk_inputs(data, cands[0], cands[1], dbuf_size,
                            dev)['walk']


def test_walk_on_card_equals_cpu(cuda):
    """The walk of sample5's first block through the compose and chase
    kernels gives what the plain versions give on the CPU."""
    gs, gc, ge = dh.huffman_walk_dev(*_sample5_first_walk(cuda))
    ws, wc, we = dh.huffman_walk_dev(*_sample5_first_walk('cpu'))
    count = int(wc)
    assert count > 0 and int(gc) == count and int(ge) == int(we)
    assert torch.equal(gs[:count].cpu(), ws[:count])


def _walk_kernels_equal_plain(payload, bit0, nbits_cap, limits, bases,
                              perms, mins, sel, n_sel):
    """Both walk kernels against their plain versions on the CPU, whole
    outputs, one launch each; the chunk walk from the chase's starts and
    from arbitrary starts (some outside the cap)."""
    before = dict(_cuda.launches)
    val, nxt = dh.walk_maps(payload, bit0, nbits_cap, limits, mins)
    assert _cuda.launches['walk_maps'] == before['walk_maps'] + 1
    cpu = [t.cpu() for t in (payload, limits, bases, perms, mins, sel)]
    payload_c, limits_c, bases_c, perms_c, mins_c, sel_c = cpu
    val_c, _, nxt_c = dh._next_maps(payload_c, bit0, nbits_cap, limits_c,
                                    mins_c)
    assert torch.equal(val.cpu(), val_c)
    assert torch.equal(nxt.cpu(), nxt_c)
    m = min(n_sel, sel.shape[0])
    chased = dh.selector_chase(dh._power_k(nxt, dh.POWER_K_DEFAULT),
                               sel[:m].contiguous(), 1)
    rng = np.random.default_rng(nbits_cap + m)
    arbitrary = torch.from_numpy(rng.integers(
        -50, nbits_cap + 50, m).astype(np.int32)).to(payload.device)
    for starts in (chased, arbitrary):
        n = _cuda.launches['chunk_walk']
        syms, ends = dh.chunk_walk(val, sel, starts, limits, bases, perms,
                                   mins)
        assert _cuda.launches['chunk_walk'] == n + 1
        want_s, want_e = dh.chunk_walk_plain(val_c, sel_c, starts.cpu(),
                                             limits_c, bases_c, perms_c,
                                             mins_c)
        assert syms.dtype == want_s.dtype and ends.dtype == want_e.dtype
        assert torch.equal(syms.cpu(), want_s)
        assert torch.equal(ends.cpu(), want_e)


def test_walk_kernels_match_plain_sample5(cuda):
    """Sample5's first block at the stream decoder's caps."""
    payload, bit0, nbits_cap, s_cap, limits, bases, perms, mins, sel, \
        n_sel, _ = _sample5_first_walk(cuda)
    assert s_cap > n_sel
    _walk_kernels_equal_plain(payload, bit0, nbits_cap, limits, bases,
                              perms, mins, sel[:s_cap].contiguous(), n_sel)


def _random_walk_case(bit0, G, dev, nbits_cap=4096, s_cap=128):
    """Random payload and tables: lengths below a min_len above 1, limits
    of -1 (no code of that length), above every window, and at random, so
    that at some offsets no code fits; n_selectors below s_cap, and a
    payload that sometimes ends before the cap."""
    rng = np.random.default_rng(bit0 * 10 + G)
    n_bytes = (nbits_cap + bit0 + 7) // 8 + int(rng.integers(-40, 9))
    payload = rng.integers(0, 256, n_bytes).astype(np.uint8)
    limits = np.full((G, dh.MAX_CODE_BITS + 2), -1, np.int32)
    for g in range(G):
        for L in range(1, dh.MAX_CODE_BITS + 2):
            limits[g, L] = rng.choice([-1, int(rng.integers(
                0, 1 << min(L, 20))), dh.BIG_LIMIT])
    mins = rng.integers(1, 6, G).astype(np.int32)
    mins[0] = 3
    bases = rng.integers(-(1 << 20), 1 << 20, (G, 21)).astype(np.int32)
    bases[:, 5] = rng.integers(-300, 300, G)   # some j inside [0, 258)
    perms = rng.integers(0, 258, (G, 258)).astype(np.int32)
    n_sel = s_cap // 2 + bit0
    sel = np.zeros(s_cap, np.int32)
    sel[:n_sel] = rng.integers(0, G, n_sel)
    return [torch.from_numpy(x).to(dev) for x in (
        payload, limits, bases, perms, mins, sel)] + [n_sel]


@pytest.mark.parametrize('G', [2, 6])
@pytest.mark.parametrize('bit0', range(8))
def test_walk_kernels_match_plain_random(cuda, bit0, G):
    payload, limits, bases, perms, mins, sel, n_sel = _random_walk_case(
        bit0, G, cuda)
    _walk_kernels_equal_plain(payload, bit0, 4096, limits, bases, perms,
                              mins, sel, n_sel)


def test_walk_launches_each_kernel_once(cuda):
    """The whole walk of sample5's first block on the card: one launch of
    each walk kernel, and the whole symbol stream, count and end bit of
    the walk on the CPU."""
    before = dict(_cuda.launches)
    gs, gc, ge = dh.huffman_walk_dev(*_sample5_first_walk(cuda))
    for name in ('walk_maps', 'chunk_walk', 'selector_chase'):
        assert _cuda.launches[name] == before[name] + 1
    ws, wc, we = dh.huffman_walk_dev(*_sample5_first_walk('cpu'))
    assert torch.equal(gs.cpu(), ws)
    assert int(gc) == int(wc) > 0 and int(ge) == int(we)


def test_walk_wrappers_reject_bad_input(cuda):
    payload, limits, bases, perms, mins, sel, _ = _random_walk_case(
        0, 6, cuda)
    val, _ = dh.walk_maps(payload, 0, 4096, limits, mins)
    starts = sel[:10].contiguous()
    bad_maps = [
        (payload.int(), 0, 4096, limits, mins),          # dtype
        (payload, 0, 4096, limits.long(), mins),
        (payload.view(-1, 1), 0, 4096, limits, mins),    # shape
        (payload, 0, 4096, limits[:, :21], mins),
        (payload, 0, 4096, limits, mins[:5]),
        (payload, 8, 4096, limits, mins),
        (payload, 0, 0, limits, mins),
        (payload, 0, 4096, limits.cpu(), mins),          # device
        (payload[::2], 0, 4096, limits, mins),           # contiguity
        (payload, 0, 4096, limits.t().contiguous().t(), mins),
    ]
    for args in bad_maps:
        with pytest.raises(ValueError):
            dh.walk_maps(*args)
    bad_walks = [
        (val.long(), sel, starts, limits, bases, perms, mins),   # dtype
        (val, sel.long(), starts, limits, bases, perms, mins),
        (val, sel, starts, limits, bases.long(), perms, mins),
        (val, sel.view(2, -1), starts, limits, bases, perms, mins),  # shape
        (val, sel, torch.zeros(129, dtype=torch.int32, device=cuda),
         limits, bases, perms, mins),
        (val, sel, starts, limits, bases[:, :20], perms, mins),
        (val, sel, starts, limits, bases, perms[:5], mins),
        (val, sel, starts.cpu(), limits, bases, perms, mins),    # device
        (val, sel, starts, limits, bases, perms.cpu(), mins),
        (val, sel[::2], starts, limits, bases, perms, mins),     # contiguity
        (val, sel, starts, limits, bases, perms.t().contiguous().t(), mins),
    ]
    for args in bad_walks:
        with pytest.raises(ValueError):
            dh.chunk_walk(*args)
    meta = torch.empty(4096, dtype=torch.int32, device='meta')
    with pytest.raises(RuntimeError):
        dh.chunk_walk(meta, sel, starts, limits, bases, perms, mins)


def test_decode_multiblock_launches_walk_kernels_once_a_candidate(cuda):
    """A five-block stdlib stream through `decompress_file_device`: the
    bytes back, and each walk kernel launched once a candidate block."""
    rng = np.random.default_rng(5)
    data = rng.choice(np.frombuffer(b'abcdefgh \n', np.uint8),
                      450000).tobytes()
    comp = bz2.compress(data, 1)
    n_cands = len(bp._parse_candidates(np.frombuffer(comp, np.uint8))[2])
    assert n_cands >= 5
    before = dict(_cuda.launches)
    assert cz.decompress_file_device(comp) == data
    for name in ('walk_maps', 'chunk_walk', 'selector_chase'):
        assert _cuda.launches[name] - before[name] == n_cands


@pytest.mark.parametrize('sub', [1, 5])
def test_chase_kernel_bounded_equals_full(cuda, sub):
    """The kernel's chase over the first n_selectors selectors gives the
    first n_selectors starts of its chase over the padded s_cap."""
    walk = _sample5_first_walk(cuda)
    payload, bit0, nbits_cap, s_cap, limits, _, _, mins, sel, n_sel, _ = \
        walk
    assert s_cap > n_sel
    _, _, nxt = dh._next_maps(payload, bit0, nbits_cap, limits, mins)
    F = dh._power_k(nxt, dh.GROUP_SIZE // sub)
    sel = sel[:s_cap].to(torch.int32).contiguous()
    full = dh.selector_chase(F, sel, sub)
    assert torch.equal(dh.selector_chase(F, sel[:n_sel], sub),
                       full[:n_sel])


def _chase_case(case):
    """(F (G, cap) int32, sel int32, sub) for the edge cases of a chase
    that stages F's windows ahead of the chain (the CPU tests hold the
    plain version against the JAX package on the same kinds of input)."""
    rng = np.random.default_rng(len(case))
    G, cap, n, sub = 6, 1 << 15, 200, 1
    lo, hi = 50, 1001            # one chunk moves 50..1000 bits
    if case == 'clamped_tail':   # the last chunks sit at cap - 1
        cap, n = 1 << 14, 120
    elif case == 'longest_steps':  # every code 20 bits: 1000 a chunk
        lo, hi, n = 1000, 1001, 30
    elif case == 'sub5':
        sub, lo, hi = 5, 10, 201
    elif case == 'cap_below_window':
        cap, n = 1000, 30
    elif case == 'cap_ragged':   # not a multiple of a window, nor of 4
        cap, n = 5001, 80
    elif case == 'far_jumps':    # steps past the whole ring of windows
        lo, hi, cap = 50, 12000, 1 << 20
    elif case == 'backward':     # not monotone: read from global memory
        lo, hi = -3000, 1001
    pos = np.arange(cap)[None, :]
    F = np.clip(pos + rng.integers(lo, hi, (G, cap)), 0, cap - 1)
    sel = rng.integers(0, G, n)
    if case == 'alternating':
        sel = np.arange(n) % G
    elif case == 'selector_past_G':
        sel[::7] = G
        sel[3::11] = G + 40
    elif case == 'two_groups':
        G = 2
        F = F[:2]
        sel = sel % 2
    return F.astype(np.int32), sel.astype(np.int32), sub


@pytest.mark.parametrize('case', [
    'clamped_tail', 'longest_steps', 'alternating', 'selector_past_G',
    'cap_below_window', 'cap_ragged', 'sub5', 'far_jumps', 'backward',
    'two_groups'])
def test_staged_chase_edge_cases(cuda, case):
    F, sel, sub = _chase_case(case)
    F, sel = torch.from_numpy(F).to(cuda), torch.from_numpy(sel).to(cuda)
    before = _cuda.launches['selector_chase']
    got = dh.selector_chase(F, sel, sub)
    assert _cuda.launches['selector_chase'] == before + 1
    assert torch.equal(got.cpu(), dh.selector_chase_plain(F, sel, sub).cpu())


def test_staged_chase_reads_shared_memory(cuda):
    """On sample5's first block every step of the chain reads a staged
    window: no load goes to global memory, and nothing past the ring's
    reach beyond the last start is copied."""
    walk = _sample5_first_walk(cuda)
    payload, bit0, nbits_cap, s_cap, limits, _, _, mins, sel, n_sel, _ = \
        walk
    _, _, nxt = dh._next_maps(payload, bit0, nbits_cap, limits, mins)
    F = dh._power_k(nxt, dh.POWER_K_DEFAULT)
    sel = sel[:n_sel].to(torch.int32).contiguous()
    starts = torch.empty_like(sel)
    stats = torch.zeros(4, dtype=torch.int64, device=cuda)
    _cuda.check(_cuda.lib().cz_selector_chase(
        F.data_ptr(), sel.data_ptr(), starts.data_ptr(), F.shape[0],
        F.shape[1], n_sel, 1, stats.data_ptr(),
        _cuda.stream_handle(cuda)), 'selector_chase')
    assert torch.equal(starts, dh.selector_chase_plain(F, sel, 1))
    staged, global_loads, window, stages = stats.tolist()
    assert global_loads == 0
    reach = int(starts[-1]) + window * stages
    assert 0 < staged <= F.shape[0] * reach * 4


def _fused_rows(m, B):
    rng = np.random.default_rng(10 * m + B)
    fib = [1, 1]
    while len(fib) < 29:
        fib.append(fib[-1] + fib[-2])
    rows = np.zeros((B, de.N), dtype=np.int32)
    rows[0, :m] = rng.permutation(np.resize(fib[:min(m, 29)], m))
    top = 900001 // max(m, 1)
    for i in range(1, B):
        rows[i, :m] = (rng.integers(0, top, m) if i % 2 else
                       np.minimum(rng.zipf(1.3, m), top))
    return torch.from_numpy(rows)


@pytest.mark.parametrize('B', [1, 2, 6])
@pytest.mark.parametrize('m', [0, 3, 4, 258, 260])
def test_code_lengths_kernel_matches_plain(cuda, m, B):
    freqs = _fused_rows(m, B)
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = _cuda.launches['code_lengths']
    got = de.code_lengths_batch(freqs.to(cuda), m, err)
    assert _cuda.launches['code_lengths'] == before + 1
    want, flags = de.code_lengths_plain(freqs, m)
    assert torch.equal(got.cpu(), want)
    assert int(err) == int(flags.max()) == 0


def test_code_lengths_kernel_flags_bad_keys(cuda):
    freqs = _fused_rows(258, 3)
    freqs[1, 7] = 1 << 22
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = de.code_lengths_batch(freqs.to(cuda), 258, err)
    assert int(err) == 1
    assert torch.equal(got[0].cpu(), de.code_lengths_plain(freqs, 258)[0][0])


def test_code_lengths_equals_alloc_on_encode_tables(cuda):
    """Every table build of a sample5x4 -9 encode, through the fused
    kernel and through torch.sort + cz_alloc_lengths + scatter."""
    with open(os.path.join(GOLDEN, 'sample5x4_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    seen = []
    orig = de.code_lengths_batch

    def recorder(freqs, m, err):
        seen.append((freqs.clone(), m))
        return orig(freqs, m, err)

    de.code_lengths_batch = recorder
    try:
        assert cz.compress_file_device(bz2.decompress(gold), level=9) == gold
    finally:
        de.code_lengths_batch = orig
    assert len(seen) >= 10 * 5
    err = torch.zeros(1, dtype=torch.int32, device=cuda)
    for freqs, m in seen:
        arrs, sym_of_slot, valid = de._sym_sorted(freqs, m)
        ms = torch.full((freqs.shape[0],), m, dtype=torch.int32,
                        device=cuda)
        old = de._unsort(de.alloc_lengths(arrs.to(torch.int32).contiguous(),
                                          ms), sym_of_slot, valid)
        assert torch.equal(de.code_lengths_batch(freqs, m, err), old)
    assert int(err) == 0


def test_deferred_flag_raises_on_card(cuda):
    """A frequency the table build cannot take sets the block's flag in
    the kernel; optimize_groups_dev raises when it reads the flag with
    the Lloyd loop's cost."""
    rng = np.random.default_rng(3)
    m, n_syms = 100, 3000
    buf = np.minimum(rng.zipf(1.5, n_syms + 13) - 1, m - 2).astype(np.int16)
    buf[n_syms - 1:] = m - 1
    freq = np.bincount(buf[:n_syms], minlength=de.N).astype(np.int32)
    syms = torch.from_numpy(buf).to(cuda)
    n_chunks = -(-buf.shape[0] // 50)
    de.optimize_groups_dev(syms, n_syms, n_chunks,
                           torch.from_numpy(freq).to(cuda), m)
    freq[5] = 1 << 22
    with pytest.raises(RuntimeError, match='loop bound'):
        de.optimize_groups_dev(syms, n_syms, n_chunks,
                               torch.from_numpy(freq).to(cuda), m)


def _sample5():
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        return bz2.decompress(f.read())


@pytest.mark.parametrize('kind', ['text', 'zeros', 'random'])
def test_eof_bwt_on_card_equals_native(cuda, kind):
    """bwt_eof_block and inverse_bwt_eof_block on the card against the
    native host transform, at the BWTC -9 block size."""
    from compressjs_tpu_torch import native
    n = 900000
    rng = np.random.default_rng(3)
    block = {'text': np.frombuffer(_sample5()[:n], np.uint8),
             'zeros': np.zeros(n, np.uint8),
             'random': rng.integers(0, 256, n).astype(np.uint8)}[kind]
    U, pidx = bk.bwt_eof_block(torch.from_numpy(block.copy()).to(cuda), n)
    Un, pn = native.bwt_eof(block)
    assert int(pidx) == pn
    assert np.array_equal(U.cpu().numpy(), Un)
    back = bd.inverse_bwt_eof_block(U, n, pidx)
    assert np.array_equal(back.cpu().numpy(), block)


def test_device_bwtc_encoder_on_card(cuda):
    from compressjs_tpu_torch.host.bwtc import BWTC
    data = _sample5()[:2000000]
    got = bytes(cz.DeviceBWTCEncoder(9, device='cuda').compress(data))
    assert got == bytes(BWTC.compress_file(data, None, 9))
    assert bytes(BWTC.decompress_file(got)) == data


def _fenwick_lanes(seed, sizes, T, max_prob, dev):
    """Ragged zipf lanes of the given model sizes, masked holes in one
    lane, through the plain encode on the CPU and the kernel on `dev`."""
    from compressjs_tpu_torch.ops import device_model as dm
    rng = np.random.default_rng(seed)
    L = len(sizes)
    syms = np.zeros((L, T), np.int32)
    valid = np.zeros((L, T), bool)
    for l, sz in enumerate(sizes):
        tl = int(rng.integers(0, T + 1))
        syms[l, :tl] = np.minimum(rng.zipf(1.2, tl) - 1, sz - 1)
        syms[l, tl:] = rng.integers(0, sz, T - tl)
        valid[l, :tl] = True
    valid[0, ::5] = False
    Ns = torch.tensor([s + 1 for s in sizes], dtype=torch.int32)
    args = (torch.from_numpy(syms), torch.from_numpy(valid), Ns)
    want = dm.fenwick_encode_streams(*args, 258, max_prob, 0x100)
    before = _cuda.launches['fenwick_encode']
    got = dm.fenwick_encode_streams(*(a.to(dev) for a in args), 258,
                                    max_prob, 0x100)
    assert _cuda.launches['fenwick_encode'] == before + 1
    return want, got, Ns


@pytest.mark.parametrize('max_prob', [0xFF00, 0x400])
def test_fenwick_encode_kernel_matches_plain(cuda, max_prob):
    """20 lanes (two blocks of 16), model sizes 1 to 256, a low max_prob
    for escapes and rescales."""
    sizes = [256, 1, 3, 40, 200, 255, 17, 2, 90, 9, 30, 31, 32, 33, 100,
             200, 150, 255, 64, 5]
    want, got, _ = _fenwick_lanes(1, sizes, 400, max_prob, cuda)
    for w, g in zip(want, got):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize('tok_cap', [None, 11])
def test_range_encode_kernel_matches_plain(cuda, tok_cap):
    from compressjs_tpu_torch.ops import device_coder as dc
    want, _, _ = _fenwick_lanes(2, [60, 256, 7, 129], 500, 0xFF00, cuda)
    init = dc.encoder_states(torch.tensor([0, 5, 255, 9]),
                             torch.tensor([0, 1, 2, 3]))
    plain = dc.batched_range_encode(*want, None, None, tok_cap,
                                    init_state=init)
    before = _cuda.launches['range_encode']
    got = dc.batched_range_encode(*(w.to(cuda) for w in want), None, None,
                                  tok_cap, init_state=init.to(cuda))
    assert _cuda.launches['range_encode'] == before + 1
    for p, g in zip(plain, got):
        assert torch.equal(g.cpu(), p)
    b, n = dc.token_bytes(*got, 3000)
    pb, pn = dc.token_bytes(*plain, 3000)
    assert torch.equal(b.cpu(), pb) and torch.equal(n.cpu(), pn)


@pytest.mark.parametrize('max_prob', [0xFF00, 0x400])
def test_fenwick_decode_kernel_matches_plain(cuda, max_prob):
    """Lanes coded by the plain encode and coder, each payload row exactly
    its lane's length where it is the longest (the EOF byte), decoded by
    the kernel and by the plain version from the free byte's state."""
    from compressjs_tpu_torch.ops import device_coder as dc
    from compressjs_tpu_torch.ops import device_model as dm
    sizes = [256, 3, 40, 200, 17, 2, 90, 255]
    want, _, Ns = _fenwick_lanes(3, sizes, 600, max_prob, cuda)
    L = len(sizes)
    zeros = torch.zeros(L, dtype=torch.int64)
    byts, lens = dc.token_bytes(*dc.batched_range_encode(*want, zeros,
                                                         zeros), 5000)
    byts = byts[:, :int(lens.max())].contiguous()
    state = torch.stack(dc.dec_start_state(byts, torch.ones(L,
                                                          dtype=torch.int64)),
                        1)
    valid = want[3][:, 1::2]
    plain, pst = dm.fenwick_decode_streams(byts, state, Ns, 258, max_prob,
                                           0x100, valid)
    before = _cuda.launches['fenwick_decode']
    got, gst = dm.fenwick_decode_streams(byts.to(cuda), state.to(cuda),
                                         Ns.to(cuda), 258, max_prob, 0x100,
                                         valid.to(cuda))
    assert _cuda.launches['fenwick_decode'] == before + 1
    assert torch.equal(got.cpu(), plain)
    for a, b in zip(gst, pst):
        assert torch.equal(a.cpu(), b)


def _scan_lanes(seed, L, T):
    """(symbols, valid, Ns) of L ragged zipf lanes on the CPU, model sizes
    1 to 256 in turn: lane 0 has no valid step, lane 1 only its first,
    lane 2 holes every fifth step, the others end anywhere."""
    rng = np.random.default_rng(seed)
    sizes = [1 + (37 * l) % 256 for l in range(L)]
    syms = np.zeros((L, T), np.int32)
    valid = np.zeros((L, T), bool)
    for l, sz in enumerate(sizes):
        tl = [0, 1][l] if l < 2 else int(rng.integers(0, T + 1))
        syms[l, :tl] = np.minimum(rng.zipf(1.2, tl) - 1, sz - 1)
        syms[l, tl:] = rng.integers(0, sz, T - tl)
        valid[l, :tl] = True
    if L > 2:
        valid[2, ::5] = False
    return (torch.from_numpy(syms), torch.from_numpy(valid),
            torch.tensor([s + 1 for s in sizes], dtype=torch.int32))


@pytest.mark.parametrize('max_prob', [0xFF00, 0x400])
@pytest.mark.parametrize('L', [1, 8, 20, 128])
def test_encode_entries_match_plain(cuda, L, max_prob):
    """The three entries of csrc/fenwick_encode.cu (the model alone, the
    coder alone, the two fused) against their plain versions at L = 1,
    8, 20 and 128 lanes (a block a lane: 20 and 128 are no multiple of
    the old 16 lanes a block), with a lane of no valid step, a lane
    whose last valid slot is its first, holes, coders continuing
    exported states and a token cap that overflows."""
    from compressjs_tpu_torch.ops import device_coder as dc
    from compressjs_tpu_torch.ops import device_model as dm
    T = 700 if L <= 20 else 150
    syms, valid, Ns = _scan_lanes(L + max_prob, L, T)
    rng = np.random.default_rng(L)
    init = dc.encoder_states(torch.from_numpy(rng.integers(0, 256, L)),
                             torch.from_numpy(rng.integers(0, 4, L)))
    args = (syms, valid, Ns, 258, max_prob, 0x100)
    trip = dm.fenwick_encode_streams(*args)
    before = dict(_cuda.launches)
    got = dm.fenwick_encode_streams(*(a.to(cuda) for a in args[:3]),
                                    *args[3:])
    for w, g in zip(trip, got):
        assert torch.equal(g.cpu(), w)
    for cap in (None, 2 * T // 3):
        want = dm.fenwick_code_streams(*args, init, cap)
        assert torch.equal(want[0], dc.batched_range_encode(
            *trip, None, None, cap, init_state=init)[0])
        coded = dc.batched_range_encode(*(t.to(cuda) for t in trip), None,
                                        None, cap, init_state=init.to(cuda))
        fused = dm.fenwick_code_streams(*(a.to(cuda) for a in args[:3]),
                                        *args[3:], init.to(cuda), cap)
        for w, c, f in zip(want, coded, fused):
            assert torch.equal(c.cpu(), w) and torch.equal(f.cpu(), w)
    assert _cuda.launches['fenwick_encode'] == before['fenwick_encode'] + 1
    assert _cuda.launches['range_encode'] == before['range_encode'] + 2
    assert _cuda.launches['fenwick_code'] == before['fenwick_code'] + 2


@pytest.mark.parametrize('max_prob', [0xFF00, 0x400])
@pytest.mark.parametrize('L', [1, 8, 20, 128])
def test_decode_entry_matches_plain(cuda, L, max_prob):
    """csrc/fenwick_decode.cu (a block a lane) against its plain version
    symbol for symbol and state for state at L = 1, 8, 20 and 128 lanes:
    the lanes of _scan_lanes (one with no valid step, one whose only
    valid step is its first, holes every fifth step, model sizes down to
    N = 2) coded from exported coder states, payload rows exactly the
    longest lane's length and 8 bytes wider, decoders started fresh and
    from the states a decode of the first third of the steps exported;
    one launch a call."""
    from compressjs_tpu_torch.ops import device_coder as dc
    from compressjs_tpu_torch.ops import device_model as dm
    T = 400 if L <= 20 else 150
    syms, valid, Ns = _scan_lanes(L + max_prob + 1, L, T)
    rng = np.random.default_rng(L + 1)
    init = dc.encoder_states(torch.from_numpy(rng.integers(0, 256, L)),
                             torch.from_numpy(rng.integers(0, 4, L)))
    args = (Ns, 258, max_prob, 0x100)
    tok = dm.fenwick_code_streams(syms, valid, *args, init)
    byts, lens = dc.token_bytes(*tok, 6 * T + 64)
    fresh = torch.stack(dc.dec_start_state(
        byts, torch.ones(L, dtype=torch.int64)), 1)
    part = valid.clone()
    part[:, T // 3:] = False
    mid = torch.stack(dm.fenwick_decode_streams(byts, fresh, *args,
                                                part)[1], 1)
    assert bool((mid[:, 3] > 1).any())
    for wide in (0, 8):
        pay = byts[:, :int(lens.max()) + wide].contiguous()
        for state in (fresh, mid):
            want, wst = dm.fenwick_decode_streams(pay, state, *args, valid)
            before = _cuda.launches['fenwick_decode']
            got, gst = dm.fenwick_decode_streams(
                pay.to(cuda), state.to(cuda), Ns.to(cuda), *args[1:],
                valid.to(cuda))
            assert _cuda.launches['fenwick_decode'] == before + 1
            assert torch.equal(got.cpu(), want)
            for a, b in zip(gst, wst):
                assert torch.equal(a.cpu(), b)


def test_decode_kernel_wide_counts_match_plain(cuda):
    """max_prob + increment above 0x10000, where a root's symbol count
    can pass 16 bits (and a node's count its plane's total): the
    kernel's clamped variant against the plain version, symbols and
    states."""
    from compressjs_tpu_torch.ops import device_coder as dc
    from compressjs_tpu_torch.ops import device_model as dm
    L, T = 8, 1500
    syms, valid, Ns = _scan_lanes(5, L, T)
    zeros = torch.zeros(L, dtype=torch.int64)
    args = (Ns, 258, 0xFFF0, 0x100)
    tok = dm.fenwick_code_streams(syms, valid, *args,
                                  dc.encoder_states(zeros, zeros), 6 * T + 8)
    byts, lens = dc.token_bytes(*tok, 6 * T + 64)
    byts = byts[:, :int(lens.max())].contiguous()
    state = torch.stack(dc.dec_start_state(byts, zeros + 1), 1)
    want, wst = dm.fenwick_decode_streams(byts, state, *args, valid)
    got, gst = dm.fenwick_decode_streams(byts.to(cuda), state.to(cuda),
                                         Ns.to(cuda), *args[1:],
                                         valid.to(cuda))
    assert torch.equal(got.cpu(), want)
    for a, b in zip(gst, wst):
        assert torch.equal(a.cpu(), b)


def test_fenwick_code_flags_bad_input(cuda):
    from compressjs_tpu_torch.ops import device_model as dm
    s = torch.tensor([[5]], dtype=torch.int32, device=cuda)
    v = torch.ones((1, 1), dtype=torch.bool, device=cuda)
    init = torch.zeros((1, 5), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):   # a symbol outside the model
        dm.fenwick_code_streams(s, v, torch.tensor([3], device=cuda), 8,
                                0xFF00, 0x100, init)
    with pytest.raises(ValueError):   # a lane wider than max_n
        dm.fenwick_code_streams(s, v, torch.tensor([9], device=cuda), 8,
                                0xFF00, 0x100, init)


def test_fenwick_kernels_flag_bad_input(cuda):
    from compressjs_tpu_torch.ops import device_model as dm
    s = torch.tensor([[5]], dtype=torch.int32, device=cuda)
    v = torch.ones((1, 1), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):   # a symbol outside the model
        dm.fenwick_encode_streams(s, v, torch.tensor([3], device=cuda), 8,
                                  0xFF00, 0x100)
    with pytest.raises(ValueError):   # a lane wider than max_n
        dm.fenwick_encode_streams(s, v, torch.tensor([9], device=cuda), 8,
                                  0xFF00, 0x100)
    with pytest.raises(ValueError):
        dm.fenwick_decode_streams(s.to(torch.uint8), torch.zeros(
            (1, 4), dtype=torch.int64, device=cuda),
            torch.tensor([9], device=cuda), 8, 0xFF00, 0x100, v)


def test_bwtcp_and_bwtcl_on_card(cuda):
    """sample5's first 2,000,000 bytes at -9 through both formats on the
    card, equal to the host codecs, and the BWTC-L stream back; both
    encodes launch the fused model and coder and neither unfused one."""
    data = _sample5()[:2000000]
    before = dict(_cuda.launches)
    got = bytes(cz.bwtcp_compress_device(data, level=9, device='cuda'))
    assert got == bytes(cz.BWTCP.compress_file(data, None, 9))
    got = bytes(cz.bwtcl_compress_device(data, level=9, device='cuda'))
    assert got == bytes(cz.BWTCL.compress_file(data, None, 9))
    assert bytes(cz.bwtcl_decompress_device(got, device='cuda')) == data
    for k in ('fenwick_code', 'fenwick_decode', 'mtf_scan', 'mtf_undo'):
        assert _cuda.launches[k] > before[k], k
    # the encodes code through the fused entry alone
    for k in ('fenwick_encode', 'range_encode'):
        assert _cuda.launches[k] == before[k], k


def test_bwtcl_encode_syncs_on_card(cuda, monkeypatch):
    """Two level-1 blocks of text on the card, a full block of one byte
    (fewer RLE2 symbols than lanes) and a tail on the host: host_syncs
    13 a card block + 11 a full block that takes the host after its
    launch + 2 x sort_rounds (README), and as many synchronising
    operations as torch's sync debug mode reports."""
    import warnings
    from compressjs_tpu_torch import tracer
    from compressjs_tpu_torch.parallel import pipeline
    s5 = _sample5()
    data = s5[:200000] + b'q' * 100000 + s5[200000:250000]
    cz.bwtcl_compress_device(data, level=1, device='cuda')      # warm
    torch.cuda.synchronize()
    timer = tracer.StageTimer(enabled=True)
    monkeypatch.setattr(tracer, '_global_timer', timer)
    monkeypatch.setattr(timer, 'report', lambda out=None: None)
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            got = bytes(cz.bwtcl_compress_device(data, level=1,
                                                 device='cuda'))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got == bytes(cz.BWTCL.compress_file(data, None, 1))
    assert pipeline.bwtcl_compress_device.last_stats == {
        'device_blocks': 2, 'host_blocks': 2, 'overflow_blocks': 0}
    rounds = timer.counters['sort_rounds']
    assert timer.counters['host_syncs'] == 13 * 2 + 11 + 2 * rounds
    assert timer.counters['host_syncs'] == sum(
        1 for w in caught if 'synchroniz' in str(w.message))


def _bwtcp_five_blocks_and_tail():
    """Five level-6 blocks of text and a 123,457-byte tail."""
    s5 = _sample5()
    return (s5 + s5[::-1])[:5 * 600000 + 123457]


def test_bwtcp_pipeline_on_card_equals_host(cuda):
    """Level 6, two blocks a dispatch: three coder jobs on the worker
    thread and its side stream, each behind the next dispatch's sorts,
    byte for byte the host codec's, twice in a row, and no worker left
    running.  The second call reuses the first's cached device memory:
    the jobs run on one side stream, call after call, where a new stream
    would allocate at least the coder's token buffers anew (2 lanes of
    750,064 tokens, 12 bytes each)."""
    from compressjs_tpu_torch.parallel import pipeline as pl
    data = _bwtcp_five_blocks_and_tail()
    want = bytes(cz.BWTCP.compress_file(data, None, 6))
    threads = set(threading.enumerate())
    reserved = []
    for _ in range(2):
        got = bytes(cz.bwtcp_compress_device(data, level=6, batch=2,
                                             device='cuda'))
        assert got == want
        assert pl.bwtcp_compress_device.last_stats == {
            'device_blocks': 5, 'host_blocks': 1, 'overflow_blocks': 0}
        reserved.append(torch.cuda.memory_reserved(cuda))
    assert set(threading.enumerate()) <= threads
    assert reserved[1] - reserved[0] < 2 * 750064 * 12


def test_bwtcp_pipeline_raises_a_coder_flag(cuda, monkeypatch):
    """A model size past MAX_N in the second of three dispatches: the
    fused kernel's flag, read on the worker thread, raises the wrapper's
    ValueError from the call, and no worker is left running."""
    from compressjs_tpu_torch.ops import device_lane as dl
    from compressjs_tpu_torch.parallel import pipeline as pl
    group, calls = pl._bwtcp_group, []

    def bad_second(*args, **kwargs):
        heads, syms, valid, Ns, states = group(*args, **kwargs)
        calls.append(1)
        if len(calls) == 2:
            Ns = torch.full_like(Ns, dl.MAX_N + 1)
        return heads, syms, valid, Ns, states

    monkeypatch.setattr(pl, '_bwtcp_group', bad_second)
    threads = set(threading.enumerate())
    with pytest.raises(ValueError, match='fenwick_code_streams: a lane '
                                         r'size outside \[2, max_n\]'):
        cz.bwtcp_compress_device(_bwtcp_five_blocks_and_tail(), level=6,
                                 batch=2, device='cuda')
    assert len(calls) == 3
    assert set(threading.enumerate()) <= threads


@pytest.mark.parametrize('golden', ['sample5_bzip2_9.bz2',
                                    'sample5x4_bzip2_9.bz2'])
def test_cli_bzip2_encode_on_card_equals_golden(cuda, tmp_path, golden):
    """`python -m compressjs_tpu_torch.cli -z -t bzip2 -9` (in-process)
    on the card gives the golden's bytes, through the MTF scan and the
    fused code-length kernel; `-d` gives the input back."""
    from compressjs_tpu_torch import cli
    with open(os.path.join(GOLDEN, golden), 'rb') as f:
        want = f.read()
    src, out, back = tmp_path / 'in', tmp_path / 'out.bz2', tmp_path / 'back'
    src.write_bytes(bz2.decompress(want))
    before = dict(_cuda.launches)
    assert cli.main(['-z', '-t', 'bzip2', '-9', str(src), str(out)]) == 0
    assert _cuda.launches['mtf_scan'] > before['mtf_scan']
    assert _cuda.launches['code_lengths'] > before['code_lengths']
    assert out.read_bytes() == want
    assert cli.main(['-d', '-t', 'bzip2', str(out), str(back)]) == 0
    assert back.read_bytes() == src.read_bytes()
