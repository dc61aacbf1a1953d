"""The encoder's 'core' and 'hybrid' splits on the CPU: the host entropy
stage and the batched BWT against the JAX package, the batch dispatch,
self_check, the mode check, and the ported profiling helpers."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressjs_tpu.codecs import bzip2 as bzip2_ref
from compressjs_tpu.ops import bwt as bwt_ref
from compressjs_tpu.ops import jax_kernels as jk
from compressjs_tpu.parallel import pipeline as pipeline_ref
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bzip2 as pbz
from compressjs_tpu_torch.ops import block_kernels as bk
from compressjs_tpu_torch.parallel import profiling
from tests import _cpu_share  # noqa: F401 -- caps torch's threads


def _text(seed, n):
    rng = np.random.default_rng(seed)
    words = [rng.integers(97, 123, rng.integers(1, 9)).astype(
        np.uint8).tobytes() for _ in range(500)]
    return b' '.join(words[i] for i in rng.integers(0, 500, n // 4))[:n]


def _batch_rows(n):
    rng = np.random.default_rng(8)
    return np.stack([
        rng.integers(0, 256, n).astype(np.uint8),                 # random
        np.frombuffer((b'abcabd' * n)[:n], np.uint8),             # periodic
        np.repeat(rng.integers(0, 3, n), rng.integers(1, 9, n))[:n]
        .astype(np.uint8)])                                       # runs


@pytest.mark.parametrize('n', [2003, 2400])
def test_bwt_block_batch_matches_jax_and_rows(n):
    blocks = _batch_rows(n)
    U, pidx = bk.bwt_block_batch(torch.from_numpy(blocks), n)
    U_ref, pidx_ref = jk.bwt_block_batch(jnp.asarray(blocks), n)
    np.testing.assert_array_equal(U.numpy(), np.asarray(U_ref))
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(pidx_ref))
    for b in range(blocks.shape[0]):
        U_b, p_b = bk.bwt_block(torch.from_numpy(blocks[b]), n)
        assert torch.equal(U[b], U_b) and int(pidx[b]) == int(p_b)


def test_bwt_block_batch_all_periodic():
    """Rows that never resolve: the periodic tie-break in every row."""
    blocks = np.stack([np.frombuffer(b'ab' * 50, np.uint8),
                       np.frombuffer(b'aab' * 33 + b'a', np.uint8)])
    U, pidx = bk.bwt_block_batch(torch.from_numpy(blocks), 100)
    for b in range(2):
        U_b, p_b = bk.bwt_block(torch.from_numpy(blocks[b]), 100)
        assert torch.equal(U[b], U_b) and int(pidx[b]) == int(p_b)


@pytest.mark.parametrize('kind', ['text', 'runs', 'one_byte'])
def test_finish_block_matches_jax(kind):
    if kind == 'text':
        data = np.frombuffer(_text(1, 60000), np.uint8)
    elif kind == 'runs':
        rng = np.random.default_rng(2)
        data = np.repeat(rng.integers(0, 4, 900), rng.integers(1, 300, 900)) \
            .astype(np.uint8)
    else:
        data = np.array([7], np.uint8)
    block, _ = next(pbz.split_blocks(data, 99981))
    used, alphabet_size, _ = pbz.block_meta(block)
    U = np.zeros(block.shape[0], np.uint8)
    pidx = bwt_ref.bwtransform2(block, U, block.shape[0], 256)
    alphabet = np.flatnonzero(used).astype(np.uint8)
    syms, freq = bzip2_ref.mtf_rle2(U, alphabet, alphabet_size)
    want_bits, (want_pay, want_n) = pipeline_ref._finish_block(
        block, pidx, syms, len(syms), freq, alphabet_size, used)
    got_bits, (got_pay, got_n) = pbz._finish_block(
        block, pidx, syms, len(syms), freq, alphabet_size, used)
    np.testing.assert_array_equal(got_bits, want_bits)
    np.testing.assert_array_equal(got_pay, want_pay)
    assert got_n == want_n


def test_hybrid_batch_is_one_call(monkeypatch):
    """With batch=True every full-size block's BWT is one batched call;
    the tail goes through bwt_block."""
    data = _text(3, 260000)
    batched, single = [], []
    real_batch, real_single = bk.bwt_block_batch, bk.bwt_block
    monkeypatch.setattr(bk, 'bwt_block_batch', lambda b, n: (
        batched.append(tuple(b.shape)), real_batch(b, n))[1])
    monkeypatch.setattr(bk, 'bwt_block', lambda b, n: (
        single.append(n), real_single(b, n))[1])
    got = cz.compress_file_device(data, level=1, mode='hybrid', batch=True,
                                  device='cpu')
    assert got == bytes(bzip2_ref.compress_file(data, None, 1))
    assert batched == [(2, 99981)] and len(single) == 1 and single[0] < 99981


@pytest.mark.parametrize('mode', ['full', 'core', 'hybrid'])
def test_self_check_catches_wrong_pidx(monkeypatch, mode):
    real = bk.bwt_block

    def wrong(block, n):
        U, pidx = real(block, n)
        return U, (pidx + 1) % n

    monkeypatch.setattr(bk, 'bwt_block', wrong)
    enc = cz.DeviceBzip2Encoder(1, mode=mode, self_check=True, device='cpu')
    with pytest.raises(AssertionError, match='pidx'):
        enc.compress(_text(4, 5000))


def test_self_check_catches_wrong_bwt(monkeypatch):
    real = bk.bwt_block
    monkeypatch.setattr(bk, 'bwt_block', lambda b, n: (
        torch.flip(real(b, n)[0], [0]), real(b, n)[1]))
    enc = cz.DeviceBzip2Encoder(1, mode='hybrid', self_check=True,
                                device='cpu')
    with pytest.raises(AssertionError, match='BWT'):
        enc.compress(_text(5, 5000))


@pytest.mark.parametrize('mode', ['hybird', 'host', None])
def test_bad_mode(mode):
    with pytest.raises(ValueError):
        cz.DeviceBzip2Encoder(9, mode=mode, device='cpu')
    with pytest.raises(ValueError):
        cz.compress_file_device(b'abc', mode=mode, device='cpu')


def test_stage_timer_reports(capsys, monkeypatch):
    monkeypatch.setenv('COMPRESSJS_TPU_TRACE', '1')
    timer = profiling.StageTimer()
    with timer.stage('a'):
        pass
    with timer.stage('a'):
        pass
    timer.report()
    assert timer.counts['a'] == 2
    assert 'stage timing' in capsys.readouterr().err
    assert not profiling.StageTimer(enabled=False).enabled


def test_roofline_and_chain_throughput():
    r = profiling.roofline('mtf', 1000000, 0.001)
    assert r['bytes_moved_mb'] == 8.0 and r['bound'] == 'hbm'
    assert r['pct_of_bound'] == pytest.approx(
        100 * 8e6 / profiling.HBM_PEAK_BYTES_PER_S / 0.001)
    with pytest.raises(RuntimeError):
        profiling.chain_throughput(lambda x: x + 1, torch.zeros(4), 16)


def test_device_trace_writes_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        torch.arange(1000).sum()
    with open(tmp_path / 'trace.json') as f:
        assert 'traceEvents' in json.load(f)

