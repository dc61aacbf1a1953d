"""compressjs_tpu_torch.parallel.sharded_sort (the context-parallel
rotation sort on torch.distributed) against the JAX package's
sharded_cyclic_suffix_sort on its CPU mesh and against the host
rotation sort, in gloo groups of 2 and 4 ranks (subprocesses that
rendezvous through a FileStore on loopback)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compressjs_tpu.parallel import mesh as jm
from compressjs_tpu.parallel.sharded_sort import \
    sharded_cyclic_suffix_sort as jax_sort
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.host.bwt import cyclic_suffix_array
from compressjs_tpu_torch.parallel.sharded_sort import \
    sharded_cyclic_suffix_sort
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text_like(seed, n):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), np.uint8))
             for _ in range(300)]
    text = b' '.join(words[i] for i in rng.integers(0, 300, n // 3))
    return np.frombuffer(text[:n], np.uint8)


def _repeats(seed, n):
    """A 300-byte random string repeated, with 40 bytes changed at random
    places: rotations tie for hundreds of bytes and break their ties in
    no order of their indices, so the sort needs every round."""
    rng = np.random.default_rng(seed)
    block = np.resize(rng.integers(0, 256, 300).astype(np.uint8), n)
    block[rng.integers(0, n, 40)] = rng.integers(0, 256, 40)
    return block


# name -> (block, rounds): text at two sizes, the degenerate inputs of
# tests/test_sharded_sort.py, and long repeats sorted whole and cut after
# the first round (whose order then differs from the whole sort's)
CASES = {
    'text_1024': (_text_like(1, 1024), None),
    'text_16384': (_text_like(2, 16384), None),
    'zeros': (np.zeros(2048, np.uint8), None),
    'ab': (np.frombuffer(b'ab' * 1024, np.uint8), None),
    'aaab': (np.frombuffer(b'aaab' * 512, np.uint8), None),
    'repeats': (_repeats(3, 16384), None),
    'repeats_one_round': (_repeats(3, 16384), 1),
}


def test_one_rank_mesh():
    """A mesh of this process alone: every exchange is a local copy."""
    mesh = cz.make_mesh('cpu')
    for name, (block, rounds) in CASES.items():
        got = sharded_cyclic_suffix_sort(mesh, block, rounds).numpy()
        want = np.asarray(jax_sort(jm.make_mesh(jax.devices()[:1]),
                                   jnp.asarray(block), rounds))
        np.testing.assert_array_equal(got, want, err_msg=name)


_WORKER = r'''
import os, sys
rank, world, store, out_dir, repo = sys.argv[1:6]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group('gloo', store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
import compressjs_tpu_torch as cz
from compressjs_tpu_torch.parallel.sharded_sort import \
    sharded_cyclic_suffix_sort

# every point-to-point exchange goes through batch_isend_irecv: record
# the largest tensor this rank sends or receives
largest = [0]
real = dist.batch_isend_irecv


def counted(ops):
    for op in ops:
        largest[0] = max(largest[0], op.tensor.numel())
    return real(ops)


dist.batch_isend_irecv = counted
mesh = cz.make_mesh('cpu')
cases = np.load(os.path.join(out_dir, 'cases.npz'))
out = {}
for name in cases.files:
    if name.startswith('rounds_'):
        continue
    rounds = int(cases['rounds_' + name])
    block = cases[name]
    s = block.shape[0] // world
    largest[0] = 0
    out[name] = sharded_cyclic_suffix_sort(
        mesh, block, None if rounds < 0 else rounds).numpy()
    local = sharded_cyclic_suffix_sort(
        mesh, block, None if rounds < 0 else rounds, gather=False).numpy()
    assert local.shape == (s,), (name, local.shape)
    assert (local == out[name][rank * s:(rank + 1) * s]).all(), name
    assert 0 < largest[0] <= s, (name, largest[0], s)
np.savez(os.path.join(out_dir, 'order%d.npz' % rank), **out)
dist.destroy_process_group()
bad = [m for m in sys.modules
       if m.split('.')[0] in ('jax', 'jaxlib', 'compressjs_tpu')]
assert not bad, bad
print('WORKER_OK', rank, flush=True)
'''


@pytest.mark.parametrize('world', [2, 4])
def test_gloo_ranks(tmp_path, world):
    """`world` processes form one gloo group and sort every case (one
    launch for all of them).  On each rank the gathered order equals the
    JAX function's on a `world`-device CPU mesh and (for the uncut sorts)
    the host rotation sort; with gather=False each rank returns its n/d
    entries of it; and no tensor a rank exchanged held more than n/d
    elements."""
    np.savez(tmp_path / 'cases.npz',
             **{name: block for name, (block, _) in CASES.items()},
             **{'rounds_' + name: -1 if r is None else r
                for name, (_, r) in CASES.items()})
    script = tmp_path / 'worker.py'
    script.write_text(_WORKER)
    env = dict(os.environ, GLOO_SOCKET_IFNAME='lo', OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(world),
         str(tmp_path / 'store'), str(tmp_path), ROOT],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for rank in range(world)]
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
    jmesh = jm.make_mesh(jax.devices()[:world])
    for name, (block, rounds) in CASES.items():
        want = np.asarray(jax_sort(jmesh, jnp.asarray(block), rounds))
        host = cyclic_suffix_array(block, len(block))
        assert (want == host).all() == (rounds is None), name
        for rank in range(world):
            got = np.load(tmp_path / ('order%d.npz' % rank))[name]
            np.testing.assert_array_equal(got, want, err_msg=name)
