"""The BWTC-P codec: the host copy (compressjs_tpu_torch.host.bwtcp)
against ``compressjs_tpu.codecs.bwtcp``, its Python block-body twins
against the native runtime, ``bwtcp_compress_device`` with device='cpu'
(each kernel's plain version) against the JAX host bytes with its
routes (host levels, tails, the token-cap re-encode), and
``mesh_compress_bwtcp`` on a one-rank mesh and across two gloo
processes.  Every comparison is exact."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from compressjs_tpu.codecs import bwtcp as jbwtcp
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bwtcp as hbwtcp
from compressjs_tpu_torch.parallel import pipeline
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(800)]
    return b' '.join(words[i] for i in rng.integers(0, 800, n // 4))[:n]


def _repeated(n, period=512):
    """A text-like pattern of `period` bytes repeated to n bytes.  Its
    600,000-byte blocks BWT into long runs, so that their RLE2 streams
    are ~4,900 symbols: the plain Fenwick and coder loops walk those
    steps in seconds (a 4 KB pattern gives ~25,000, over a minute), while
    the random and rescale cases of test_torch_device_model cover the
    walk's semantics."""
    pat = _text_like(5, period)
    return (pat * (n // period + 1))[:n]


def _input(kind):
    if kind == 'empty':
        return b''
    if kind == 'one':
        return b'x'
    if kind == 'text_250k':
        return _text_like(3, 250000)
    if kind == 'random_30k':
        return np.random.default_rng(2).integers(
            0, 256, 30000).astype(np.uint8).tobytes()
    raise ValueError(kind)


@pytest.mark.parametrize('level', [1, 3, 6])
@pytest.mark.parametrize('kind', ['empty', 'one', 'text_250k', 'random_30k'])
def test_host_codec_matches_jax(kind, level):
    data = _input(kind)
    want = bytes(jbwtcp.BWTCP.compress_file(data, None, level))
    got = bytes(hbwtcp.BWTCP.compress_file(data, None, level))
    assert got == want
    assert bytes(hbwtcp.BWTCP.decompress_file(got)) == data


@pytest.mark.parametrize('level', [3, 6])
def test_block_body_twins_equal_native(level):
    block = np.frombuffer(_text_like(7, 20000), np.uint8)
    nat = hbwtcp._encode_block(block, level)
    twin = hbwtcp._encode_block(block, level, native_body=False)
    np.testing.assert_array_equal(nat, twin)
    np.testing.assert_array_equal(hbwtcp._decode_block(nat, level), block)
    np.testing.assert_array_equal(
        hbwtcp._decode_block(nat, level, native_body=False), block)


def test_device_encode_matches_jax_host():
    """Level 6, 1,250,000 bytes: two full blocks as the lanes of one
    dispatch (batch=2) and a 50,000-byte tail on the host."""
    data = _repeated(1250000)
    want = bytes(jbwtcp.BWTCP.compress_file(data, None, 6))
    got = bytes(cz.bwtcp_compress_device(data, None, 6, batch=2,
                                         device='cpu'))
    assert got == want
    assert pipeline.bwtcp_compress_device.last_stats == {
        'device_blocks': 2, 'host_blocks': 1, 'overflow_blocks': 0}
    assert bytes(hbwtcp.BWTCP.decompress_file(got)) == data


@pytest.mark.parametrize('level', [1, 5])
def test_low_levels_take_the_host_codec(level):
    data = _text_like(8, 230000)
    want = bytes(jbwtcp.BWTCP.compress_file(data, None, level))
    assert bytes(cz.bwtcp_compress_device(data, None, level,
                                          device='cpu')) == want
    assert pipeline.bwtcp_compress_device.last_stats == {
        'device_blocks': 0, 'host_blocks': -(-230000 // (level * 100000)),
        'overflow_blocks': 0}


def test_token_overflow_reencodes_on_the_host(monkeypatch):
    """A tiny token cap: the block's device tokens overflow, the host
    codes it again, and the stream is the same."""
    monkeypatch.setattr(pipeline, '_bwtcp_tok_cap', lambda bs: 100)
    data = _repeated(650000)
    want = bytes(jbwtcp.BWTCP.compress_file(data, None, 6))
    assert bytes(cz.bwtcp_compress_device(data, None, 6,
                                          device='cpu')) == want
    assert pipeline.bwtcp_compress_device.last_stats == {
        'device_blocks': 0, 'host_blocks': 1, 'overflow_blocks': 1}


def test_bwtcp_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        cz.bwtcp_compress_device(b'abc')
    assert bytes(cz.bwtcp_compress_device(b'abc', device='cpu')) == \
        bytes(jbwtcp.BWTCP.compress_file(b'abc', None, 9))


def test_mesh_compress_bwtcp_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        cz.mesh_compress_bwtcp(cz.make_mesh(), b'abc')
    assert bytes(cz.mesh_compress_bwtcp(cz.make_mesh('cpu'), b'abc')) == \
        bytes(jbwtcp.BWTCP.compress_file(b'abc', None, 9))


def test_mesh_one_rank_uses_the_sharded_transform(monkeypatch):
    """On a one-rank mesh the full blocks' transforms come from
    sharded_bwt_eof and the stream equals the JAX host codec's."""
    from compressjs_tpu_torch.parallel import mesh as pm
    calls = []
    real = pm.sharded_bwt_eof

    def spy(mesh, blocks):
        calls.append(blocks.shape)
        return real(mesh, blocks)

    monkeypatch.setattr(pm, 'sharded_bwt_eof', spy)
    data = _text_like(4, 250000)
    got = bytes(cz.mesh_compress_bwtcp(cz.make_mesh('cpu'), data, level=1))
    assert got == bytes(jbwtcp.BWTCP.compress_file(data, None, 1))
    assert calls == [(2, 100000)]


_WORKER = r'''
import os, sys
rank, world, store, out_dir, repo = sys.argv[1:6]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(2)
dist.init_process_group('gloo', store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
import compressjs_tpu_torch as cz
mesh = cz.make_mesh('cpu')
assert (mesh.rank, mesh.size) == (rank, world), mesh
data = np.fromfile(os.path.join(out_dir, 'input'), dtype=np.uint8)
out = cz.mesh_compress_bwtcp(mesh, data, level=1)
dist.destroy_process_group()
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'compressjs_tpu')]
assert not bad, bad
with open(os.path.join(out_dir, 'comp%d' % rank), 'wb') as f:
    f.write(bytes(out))
print('WORKER_OK', rank, flush=True)
'''


def test_mesh_two_gloo_ranks(tmp_path):
    """Two processes form one gloo group (a FileStore, loopback) and each
    encodes 3 full level-1 blocks and a tail: the ranks transform 2 and 1
    blocks, and both return the JAX host codec's bytes."""
    data = _text_like(6, 330000)
    (tmp_path / 'input').write_bytes(data)
    script = tmp_path / 'worker.py'
    script.write_text(_WORKER)
    env = dict(os.environ, GLOO_SOCKET_IFNAME='lo', OMP_NUM_THREADS='2')
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), '2',
         str(tmp_path / 'store'), str(tmp_path), ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:   # a hung rendezvous fails here, not forever
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, out, err in outs:
        assert rc == 0 and 'WORKER_OK' in out, (rc, out[-500:], err[-2000:])
    want = bytes(jbwtcp.BWTCP.compress_file(data, None, 1))
    for rank in range(2):
        assert (tmp_path / ('comp%d' % rank)).read_bytes() == want
