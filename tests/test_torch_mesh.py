"""compressjs_tpu_torch.parallel.mesh (data parallelism over blocks with
torch.distributed) and decompress_file_mesh against the JAX package:
the sharded block encodes and inverse BWTs array for array on a one-rank
CPU mesh against the JAX functions on a 2-device mesh, whole streams
byte for byte against the JAX host codec and stdlib bz2, and two gloo
ranks in subprocesses."""

import bz2
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressjs_tpu.codecs import bzip2 as jbz
from compressjs_tpu.ops import jax_kernels as jk
from compressjs_tpu.parallel import mesh as jm
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host import bzip2_parse as bp
from compressjs_tpu_torch.host.bwt import bwtransform2
from compressjs_tpu_torch.ops import block_decode as bd
from compressjs_tpu_torch.parallel import mesh as pm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, 'tests', 'golden')


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The CPU runs of the device paths here are long chains of small
    torch ops: one intra-op thread keeps them from spinning against the
    threads of other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(800)]
    return b' '.join(words[i] for i in rng.integers(0, 800, n // 4))[:n]


@pytest.fixture(scope='module')
def meshes():
    """(the port's one-rank CPU mesh, the JAX package's 2-device mesh)."""
    return cz.make_mesh('cpu'), jm.make_mesh(jax.devices()[:2])


def _equal_blocks(n=2048, count=4):
    base = b'the quick brown fox jumps over the lazy dog. ' * 100
    return [np.frombuffer(base[(i * 131) % (len(base) - n):][:n], np.uint8)
            for i in range(count)]


def test_sharded_block_encode(meshes):
    mesh, jmesh = meshes
    raw, remaps, eobs = pm.prepare_blocks(_equal_blocks())
    jraw, jremaps, jeobs = jm.prepare_blocks(_equal_blocks())
    np.testing.assert_array_equal(raw, jraw)
    np.testing.assert_array_equal(remaps, jremaps)
    np.testing.assert_array_equal(eobs, jeobs)
    got = [t.numpy() for t in pm.sharded_block_encode(mesh, raw, remaps,
                                                      eobs)]
    want = [np.asarray(a) for a in jm.sharded_block_encode(
        jmesh, jnp.asarray(raw), jnp.asarray(remaps), jnp.asarray(eobs))]
    pidx, syms, count, freq, all_counts = got
    w = syms.shape[1]
    assert w == int(want[2].max())      # syms: up to the largest count
    for g, j in zip((pidx, syms, count, freq, all_counts),
                    (want[0], want[1][:, :w], want[2], want[3], want[4])):
        np.testing.assert_array_equal(g, j)


def test_sharded_block_encode_full(meshes):
    mesh, jmesh = meshes
    raw, remaps, eobs = pm.prepare_blocks(_equal_blocks())
    got = [t.numpy() for t in pm.sharded_block_encode_full(
        mesh, raw, remaps, eobs)]
    want = [np.asarray(a) for a in jm.sharded_block_encode_full(
        jmesh, jnp.asarray(raw), jnp.asarray(remaps), jnp.asarray(eobs))]
    pidx, payload, bits, lens, g, sel, count, all_bits = got
    # the payload is sized from the manifest, not from a fixed cap
    assert payload.shape[1] == (int(bits.max()) + 7) // 8
    for i in range(len(raw)):
        nb = (int(bits[i]) + 7) // 8
        np.testing.assert_array_equal(payload[i, :nb], want[1][i, :nb])
    for a, j in zip((pidx, bits, lens, g, sel, count, all_bits),
                    (want[0], want[2], want[3], want[4], want[5], want[6],
                     want[7])):
        np.testing.assert_array_equal(a, j)


def _stream_input():
    """330,000 bytes of text: three full level-1 blocks and a tail."""
    return _text_like(2, 330000)


def test_mesh_compress_matches_host_codec(meshes):
    data = _stream_input()
    got = cz.mesh_compress_bzip2(meshes[0], data, level=1)
    assert got == bytes(jbz.compress_file(data, props=1))
    assert len(bp._scan_magic(np.frombuffer(got, np.uint8),
                              bp.MAGIC_BYTES)) == 4


@pytest.mark.parametrize('data', [b'', b'x'])
def test_mesh_compress_short(meshes, data):
    got = cz.mesh_compress_bzip2(meshes[0], data, level=9)
    assert got == bytes(jbz.compress_file(data, props=9))


def _columns(blocks):
    Us, pidxs = [], []
    for b in blocks:
        U = np.zeros(b.shape[0], np.uint8)
        pidxs.append(bwtransform2(b, U, b.shape[0]))
        Us.append(U)
    return np.stack(Us), np.asarray(pidxs, np.int32)


def _decode_blocks(kind):
    rng = np.random.default_rng(5)
    if kind == 'random':
        return [rng.integers(0, 256, 3000).astype(np.uint8)
                for _ in range(3)]
    if kind == 'periodic':      # orbits shorter than the block
        return [np.frombuffer(p * (3000 // len(p)), np.uint8)
                for p in (b'abcabd', b'aaaa', b'xyz')]
    return _equal_blocks(3000, 3)


@pytest.mark.parametrize('kind', ['random', 'periodic', 'text'])
def test_sharded_block_decode(meshes, kind):
    mesh, jmesh = meshes
    blocks = _decode_blocks(kind)
    Us, pidxs = _columns(blocks)
    got = pm.sharded_block_decode(mesh, Us, pidxs).numpy()
    np.testing.assert_array_equal(got, np.stack(blocks))
    np.testing.assert_array_equal(
        got, np.asarray(jm.sharded_block_decode(jmesh, Us, pidxs)))
    n = Us.shape[1]
    for U, p in zip(Us, pidxs):
        np.testing.assert_array_equal(
            bd.inverse_bwt_block(torch.from_numpy(U), n, int(p)).numpy(),
            np.asarray(jk.inverse_bwt_block(jnp.asarray(U), n,
                                            jnp.int32(p))))
    with pytest.raises(NotImplementedError):
        pm.sharded_block_decode(mesh, Us, pidxs, eof=True)


@pytest.mark.parametrize('kind', ['random', 'periodic', 'text'])
def test_sharded_ragged_inverse_bwt(meshes, kind):
    mesh, jmesh = meshes
    cap = 3000
    blocks = [b[:n] for b, n in zip(_decode_blocks(kind), (3000, 1777, 5))]
    Us = np.zeros((3, cap), np.uint8)
    pidxs = np.zeros(3, np.int32)
    ns = np.array([b.shape[0] for b in blocks], np.int32)
    for i, b in enumerate(blocks):
        pidxs[i] = bwtransform2(b, Us[i], ns[i])
    got = pm.sharded_ragged_inverse_bwt(mesh, Us, ns, pidxs).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jm.sharded_ragged_inverse_bwt(jmesh, Us, ns, pidxs)))
    for i, b in enumerate(blocks):
        np.testing.assert_array_equal(got[i, :ns[i]], b)
        assert not got[i, ns[i]:].any()


@pytest.mark.parametrize('entropy', ['host', 'device'])
@pytest.mark.parametrize('name', ['sample5_bzip2_9.bz2',
                                  'sample5x4_bzip2_9.bz2'])
def test_decompress_file_mesh_goldens(meshes, name, entropy):
    with open(os.path.join(GOLDEN, name), 'rb') as f:
        gold = f.read()
    assert cz.decompress_file_mesh(gold, mesh=meshes[0],
                                   entropy=entropy) == bz2.decompress(gold)


@pytest.mark.parametrize('entropy', ['host', 'device'])
def test_decompress_file_mesh_false_end_magic(meshes, monkeypatch,
                                              entropy):
    """A 3-block stream whose magic scan also reports an end magic and a
    block magic inside block 0's payload (the false end magic the device
    decode once failed on)."""
    rng = np.random.default_rng(0)
    data = rng.choice(np.frombuffer(b'abcd', np.uint8), 250000).tobytes()
    comp = bz2.compress(data, 1)
    scan = bp._scan_magic
    blocks = scan(np.frombuffer(comp, np.uint8), bp.MAGIC_BYTES)
    assert len(blocks) == 3
    false_hit = np.asarray([int(blocks[0]) + 5000], dtype=np.int64)
    monkeypatch.setattr(bp, '_scan_magic', lambda buf, pattern: np.sort(
        np.concatenate([scan(buf, pattern), false_hit])))
    assert cz.decompress_file_mesh(comp, mesh=meshes[0],
                                   entropy=entropy) == data


@pytest.mark.parametrize('entropy', ['host', 'device'])
@pytest.mark.parametrize('where', ['payload', 'stream_crc'])
def test_decompress_file_mesh_corrupt_raises(meshes, entropy, where):
    data = _text_like(3, 150000)
    comp = bytearray(jbz.compress_file(data, props=1))
    comp[{'payload': 3000, 'stream_crc': len(comp) - 2}[where]] ^= 0x24
    with pytest.raises(ValueError):
        cz.decompress_file_mesh(bytes(comp), mesh=meshes[0],
                                entropy=entropy)


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        cz.make_mesh()
    with pytest.raises(RuntimeError):
        cz.decompress_file_mesh(bz2.compress(b'abc'))
    assert cz.make_mesh('cpu').size == 1


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
outputs = {'comp': cz.mesh_compress_bzip2(mesh, data, level=1)}
for entropy in ('host', 'device'):
    outputs[entropy] = cz.decompress_file_mesh(outputs['comp'], mesh=mesh,
                                               entropy=entropy)
from compressjs_tpu_torch.parallel import mesh as pm
raw, remaps, eobs = pm.prepare_blocks(
    list(np.load(os.path.join(out_dir, 'blocks.npy'))))
arrays = {}
for name, fn in (('core', pm.sharded_block_encode),
                 ('full', pm.sharded_block_encode_full)):
    for k, t in enumerate(fn(mesh, raw, remaps, eobs)):
        arrays['%s%d' % (name, k)] = t.numpy()
np.savez(os.path.join(out_dir, 'arrays%d.npz' % rank), **arrays)
dist.destroy_process_group()
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'compressjs_tpu')]
assert not bad, bad
for name, blob in outputs.items():
    with open(os.path.join(out_dir, '%s%d' % (name, rank)), 'wb') as f:
        f.write(blob)
print('WORKER_OK', rank, flush=True)
'''


def test_two_gloo_ranks(tmp_path):
    """Two processes form one gloo group (a FileStore, loopback): each
    runs mesh_compress_bzip2 and decompress_file_mesh on the same input,
    3 level-1 blocks (the ranks own 2 and 1), and sharded_block_encode
    and sharded_block_encode_full on three small equal blocks.  Both
    ranks' streams equal the JAX host codec's, both decodes equal the
    input, and both ranks' arrays equal the JAX functions'."""
    data = _text_like(4, 250000)
    (tmp_path / 'input').write_bytes(data)
    blocks = _equal_blocks(count=3)
    np.save(tmp_path / 'blocks.npy', np.stack(blocks))
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
    want = bytes(jbz.compress_file(data, props=1))
    assert len(bp._scan_magic(np.frombuffer(want, np.uint8),
                              bp.MAGIC_BYTES)) == 3
    for rank in range(2):
        assert (tmp_path / ('comp%d' % rank)).read_bytes() == want
        for entropy in ('host', 'device'):
            assert (tmp_path / ('%s%d' % (entropy, rank))).read_bytes() \
                == data
    jmesh = jm.make_mesh(jax.devices()[:1])
    jargs = [jnp.asarray(a) for a in jm.prepare_blocks(blocks)]
    want = {'core': [np.asarray(a) for a in jm.sharded_block_encode(
                jmesh, *jargs)],
            'full': [np.asarray(a) for a in jm.sharded_block_encode_full(
                jmesh, *jargs)]}
    for rank in range(2):
        got = np.load(tmp_path / ('arrays%d.npz' % rank))
        syms = got['core1']
        assert syms.dtype == np.int16
        np.testing.assert_array_equal(syms,
                                      want['core'][1][:, :syms.shape[1]])
        for k in (0, 2, 3, 4):
            np.testing.assert_array_equal(got['core%d' % k], want['core'][k])
        bits = got['full2']
        for i in range(len(blocks)):
            nb = (int(bits[i]) + 7) // 8
            np.testing.assert_array_equal(got['full1'][i, :nb],
                                          want['full'][1][i, :nb])
        for k in (0, 2, 3, 4, 5, 6, 7):
            np.testing.assert_array_equal(got['full%d' % k], want['full'][k])
