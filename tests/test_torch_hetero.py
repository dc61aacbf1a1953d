"""compressjs_tpu_torch.hetero_compress_bzip2 (host workers and a device
worker draining one block queue) against the JAX package's host codec,
on the CPU: the device is a stand-in with controllable latency, or the
real encoder on the CPU.  Pins the scheduling contract (byte identity
with and without a device worker; a stalled device never lengthens the
run; the claim gate starves a slow device and needs a deep queue while
uncalibrated; steal and abandon bookkeeping) and the rule that a device
error reaches the caller instead of a host-only stream."""

import bz2
import os
import time

import numpy as np
import pytest
import torch

from compressjs_tpu.codecs import bzip2 as jbz
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bzip2 as pbz
from compressjs_tpu_torch.parallel import hetero
from compressjs_tpu_torch.parallel.hetero import _Scheduler, \
    hetero_compress_bzip2
from compressjs_tpu_torch.parallel.pipeline import block_bits
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The CPU runs of the device paths here are long chains of small
    torch ops: one intra-op thread keeps them from spinning against the
    threads of other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(nbytes):
    """sample5 (the golden's input), tiled to nbytes."""
    with open(os.path.join(GOLDEN, 'sample5_bzip2_9.bz2'), 'rb') as f:
        data = np.frombuffer(bz2.decompress(f.read()), dtype=np.uint8)
    return np.tile(data, -(-nbytes // len(data)))[:nbytes]


class HostComputed:
    """Device stand-in whose results the host computes (a 'hybrid'
    result from the native BWT, through the encoder's host stage
    ``pipeline.block_bits``): byte-exact by construction, with a
    controllable wait in each job's `bits`."""

    def __init__(self, fetch_delay=0.0):
        self.fetch_delay = fetch_delay
        self.submitted = []
        self.cancelled = 0
        self.closed = False

    def submit(self, block, meta):
        self.submitted.append(block.shape[0])
        return _Job(self, block, meta)

    def fetch(self, block, meta):
        time.sleep(self.fetch_delay)
        U, pidx = pbz.bwt_stage(block)
        return block_bits(block, meta, ('hybrid', pidx, U))

    def close(self):
        self.closed = True


class _Job:
    """A stand-in's queued block: its work happens in `bits`."""

    def __init__(self, enc, block, meta):
        self.enc, self.block, self.meta = enc, block, meta

    def bits(self):
        return self.enc.fetch(self.block, self.meta)

    def cancel(self):
        self.enc.cancelled += 1      # the work happens in bits: none ran
        return True


class Stuck(HostComputed):
    """A device wedged on its first fetch for `stall` seconds."""

    def __init__(self, stall):
        super().__init__(fetch_delay=stall)


class Failing(HostComputed):
    """A device whose work fails (after `fetch_delay` seconds)."""

    def fetch(self, block, meta):
        time.sleep(self.fetch_delay)
        raise RuntimeError('device lost')


def test_hetero_no_device_matches_host():
    data = _corpus(450000)
    got = hetero_compress_bzip2(data, None, 1, device=None)
    assert got == bytes(jbz.compress_file(data, None, 1))
    assert hetero_compress_bzip2.last_stats['device'] == 0


def test_hetero_fake_device_matches_host_and_participates():
    data = _corpus(1200000)   # 13 level-1 blocks
    enc = HostComputed()
    got = hetero_compress_bzip2(data, None, 1, device='cpu',
                                min_queue_factor=1,
                                _encoder_factory=lambda: enc)
    assert got == bytes(jbz.compress_file(data, None, 1))
    stats = hetero_compress_bzip2.last_stats
    assert stats['device'] >= 1, stats
    assert enc.closed
    # only full-size blocks are claimable: the short tail never goes
    assert set(enc.submitted) == {99981}


def test_hetero_cpu_encoder_matches_host(tmp_path):
    """The real encoder (every kernel's plain version on the CPU) as the
    device worker; output to a file object."""
    data = _corpus(250000)
    with open(tmp_path / 'out', 'wb') as f:
        assert hetero_compress_bzip2(data, f, 1, host_workers=1,
                                     device='cpu', device_inflight=1,
                                     min_queue_factor=1) is f
    assert (tmp_path / 'out').read_bytes() == \
        bytes(jbz.compress_file(data, None, 1))


def test_hetero_stuck_device_never_extends_makespan():
    """A device that wedges on its first block does not stall the file:
    the hosts steal its claimed blocks and the assembly completes; the
    call then waits only for the block in progress, and the device's
    queued blocks are dropped."""
    data = _corpus(1200000)
    enc = Stuck(8.0)
    t0 = time.perf_counter()
    got = hetero_compress_bzip2(data, None, 1, device='cpu',
                                min_queue_factor=1, device_inflight=2,
                                _encoder_factory=lambda: enc)
    wall = time.perf_counter() - t0
    assert got == bytes(jbz.compress_file(data, None, 1))
    stats = hetero_compress_bzip2.last_stats
    assert stats['stolen'] >= 1, stats
    assert enc.closed and enc.cancelled >= 1, enc.cancelled
    # far below the 16 s+ a device-serialised schedule would take
    assert wall < 14.0, (wall, stats)


def test_hetero_device_error_raises():
    """The JAX scheduler hands a failed device's blocks to the hosts and
    returns a host-only stream; here the error reaches the caller."""
    data = _corpus(1200000)
    with pytest.raises(RuntimeError, match='device lost'):
        hetero_compress_bzip2(data, None, 1, device='cpu',
                              min_queue_factor=1,
                              _encoder_factory=lambda: Failing())


def test_hetero_late_device_error_raises():
    """A device that fails long after the hosts stole its blocks and the
    stream was assembled: the call waits for that block's fetch and
    raises its error, and the device worker has ended (its encoder
    closed) when the call returns."""
    data = _corpus(1200000)
    enc = Failing(fetch_delay=9.0)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match='device lost'):
        hetero_compress_bzip2(data, None, 1, device='cpu',
                              min_queue_factor=1, device_inflight=2,
                              _encoder_factory=lambda: enc)
    assert time.perf_counter() - t0 >= 9.0
    stats = hetero_compress_bzip2.last_stats
    assert stats['stolen'] >= 1 and stats['device'] == 0, stats
    assert enc.closed


def test_claim_heuristic_starves_slow_device():
    s = _Scheduler(20, host_workers=2, min_queue_factor=2)
    # calibrated: hosts do 0.1 s/block, the device needs 3 s/block
    s.t_host = 0.1
    s.t_dev = 3.0
    s.dev_done = 2
    # a queue of 20 drains in 20*0.1/2 = 1.0 s < 1.3*3.0: deny
    assert s.try_claim_device() is None
    assert s.stats['dev_claims_denied'] == 1
    # a fast device (0.2 s/block) may claim
    s.t_dev = 0.2
    assert s.try_claim_device() == 19   # claims from the back
    # host order is kept from the front
    assert s.pop_host() == (0, False)


def test_claim_heuristic_uncalibrated_needs_deep_queue():
    s = _Scheduler(5, host_workers=2, min_queue_factor=8)
    assert s.try_claim_device() is None      # 5 < 16
    s2 = _Scheduler(40, host_workers=2, min_queue_factor=8)
    assert s2.try_claim_device() == 39


def test_steal_and_abandon():
    s = _Scheduler(3, host_workers=1, min_queue_factor=1)
    assert s.try_claim_device() == 2
    assert s.pop_host() == (0, False)
    assert s.pop_host() == (1, False)
    # the queue is empty: a host steals the device's claimed block
    assert s.pop_host() == (2, True)
    # abandoning a stolen block must not requeue it
    s.device_abandoned(2)
    assert s.pop_host() == (None, False)


def test_warm_device_and_card_rule(monkeypatch):
    out = hetero.warm_device(level=1, device='cpu')
    assert len(bz2.decompress(out)) == 99981 + 4
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        hetero_compress_bzip2(b'abc')
    with pytest.raises(RuntimeError):
        cz.hetero_compress_bzip2(b'abc', device='cuda')
