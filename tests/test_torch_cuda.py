"""compressjs_tpu_torch's CUDA kernels on the card, each against its
plain version, and the -9 golden through the whole encode and decode on
the card.
Run on a machine with a CUDA card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX, which a machine with
only the port need not have.)  Without a card every test here skips."""

import bz2
import os

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
    starts = bk._chunk_start_positions(bk._pad_chunks(d, n), width)
    before = _cuda.launches['mtf_scan']
    got = bk.mtf_scan(d, starts)
    assert _cuda.launches['mtf_scan'] == before + 1
    assert torch.equal(got, bk.mtf_scan_plain(d, starts))


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
    assert torch.equal(got.cpu(), de.alloc_lengths_plain(arrs, ms))


def test_wrappers_reject_bad_input(cuda):
    d = torch.zeros(100, dtype=torch.int64, device=cuda)
    starts = torch.zeros(1, 256, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        bk.mtf_scan(d, starts)
    with pytest.raises(ValueError):
        de.alloc_lengths(torch.zeros(2, 10, dtype=torch.int32, device=cuda),
                         torch.ones(2, dtype=torch.int32, device=cuda))


def test_golden_sample5_on_card(cuda):
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    before = dict(_cuda.launches)
    assert cz.compress_file_device(bz2.decompress(gold), level=9) == gold
    assert _cuda.launches['mtf_scan'] - before['mtf_scan'] == 3
    assert _cuda.launches['alloc_lengths'] - before['alloc_lengths'] >= 3


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


def test_decode_golden_sample5_on_card(cuda):
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        gold = f.read()
    before = dict(_cuda.launches)
    assert cz.decompress_file_device(gold) == bz2.decompress(gold)
    assert _cuda.launches['compose_windowed'] - \
        before['compose_windowed'] == 7 * 3
    assert _cuda.launches['selector_chase'] - before['selector_chase'] == 3
    assert _cuda.launches['mtf_undo'] - before['mtf_undo'] == 2 * 3


@pytest.mark.parametrize('n', [899981, 5037, 512, 1])
def test_mtf_undo_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    idx = np.minimum(rng.zipf(1.3, n + 3) - 1, 255).astype(np.int32)
    idx[3::97] = 256      # past the list
    idx[5::89] = -1       # before it
    idx = torch.from_numpy(idx).to(cuda)
    before = _cuda.launches['mtf_undo']
    got = bd.mtf_decode(idx, n)
    assert _cuda.launches['mtf_undo'] == before + 2
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
