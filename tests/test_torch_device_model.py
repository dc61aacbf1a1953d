"""The batched Fenwick model (compressjs_tpu_torch.ops.device_model)
against ``compressjs_tpu.ops.device_model`` and the host FenwickModel,
on the CPU, where each wrapper runs its plain version: the encode's
triples with the codecs' max_prob and with a low one (escapes and
rescales, among them rescales inside the escape sub-step, whose sy_f
the host reads before it), the decode from host-encoded lanes through
the host coder's exported states (lanes that end exactly at their last
byte, so the decoder reads the EOF byte), the encode -> coder ->
decode round trip, and `fenwick_code_streams` (model and coder in one)
against the JAX encode -> coder -> token_bytes composition.  Every
comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.ops import device_coder as jdc
from compressjs_tpu.ops import device_model as jdm
from compressjs_tpu_torch.convert import coder_states
from compressjs_tpu_torch.host.fenwick_model import FenwickModel
from compressjs_tpu_torch.host.range_coder import RangeCoder
from compressjs_tpu_torch.host.stream import ArrayInputStream, BufferStream
from compressjs_tpu_torch.ops import device_coder as dc
from compressjs_tpu_torch.ops import device_model as dm
from tests import _cpu_share  # noqa: F401 -- caps torch's threads

INCR = 0x100


def _lanes(seed, sizes, T, zipf=1.3):
    """(symbols (L, T) int32, valid (L, T) bool): ragged zipf lanes; the
    masked tail holds arbitrary symbols of the lane's alphabet."""
    rng = np.random.default_rng(seed)
    L = len(sizes)
    syms = np.zeros((L, T), np.int32)
    valid = np.zeros((L, T), bool)
    for l, sz in enumerate(sizes):
        tl = T - 13 * l
        syms[l, :tl] = np.minimum(rng.zipf(zipf, tl) - 1, sz - 1)
        syms[l, tl:] = rng.integers(0, sz, T - tl)
        valid[l, :tl] = True
    return syms, valid


def _host_lane(syms, size, max_prob, first_byte=0, init_len=0):
    """One lane through the host model and coder: its bytes."""
    out = BufferStream()
    rc = RangeCoder(out)
    rc.encode_start(first_byte, init_len)
    model = FenwickModel(rc, size, max_prob, INCR)
    for s in syms:
        model.encode(int(s))
    rc.encode_finish()
    return out.get_buffer()


@pytest.mark.parametrize('max_prob', [0xFF00, 0x400])
def test_fenwick_encode_streams_matches_jax(max_prob):
    """L = 4, T = 120, max_n 64: the (L, 2T) triples equal the JAX
    function's, masked slots included."""
    sizes = [5, 20, 50, 63]
    syms, valid = _lanes(1, sizes, 120)
    Ns = np.array([s + 1 for s in sizes], np.int32)
    want = jdm.fenwick_encode_streams(jnp.asarray(syms), jnp.asarray(valid),
                                      jnp.asarray(Ns), 64, max_prob, INCR)
    got = dm.fenwick_encode_streams(torch.from_numpy(syms),
                                    torch.from_numpy(valid),
                                    torch.from_numpy(Ns), 64, max_prob, INCR)
    for g, w in zip(got, want):
        assert g.shape == (4, 240)
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64))


@pytest.mark.parametrize('max_prob', [0xFF00, 0x400, 0x300])
def test_escape_reads_leaf_before_rescale(max_prob):
    """The encode -> coder bytes of each lane equal the host model's,
    also at a low max_prob, where a rescale inside an escape sub-step
    changes the leaf that the host reads sy_f from before it."""
    sizes = [4, 37, 200, 256]
    syms, valid = _lanes(2, sizes, 400, zipf=1.1)
    Ns = torch.tensor([s + 1 for s in sizes])
    L = len(sizes)
    sy, lt, tot, v = dm.fenwick_encode_streams(
        torch.from_numpy(syms), torch.from_numpy(valid), Ns, 258, max_prob,
        INCR)
    zeros = torch.zeros(L, dtype=torch.int64)
    byts, lens = dc.token_bytes(*dc.batched_range_encode(sy, lt, tot, v,
                                                         zeros, zeros),
                                3 * 800 + 16)
    for l in range(L):
        hb = _host_lane(syms[l][valid[l]], sizes[l], max_prob)
        assert int(lens[l]) == len(hb)
        np.testing.assert_array_equal(byts[l, :len(hb)].numpy(), hb)


def test_lanes_rescale_alone():
    """Each lane's triples are the same coded alone as beside other lanes
    (the JAX scan rescales every lane that needs it once any does; the
    card kernel tests each lane's own root)."""
    sizes = [9, 60, 30]
    syms, valid = _lanes(3, sizes, 300, zipf=1.2)
    Ns = torch.tensor([s + 1 for s in sizes])
    together = dm.fenwick_encode_streams(
        torch.from_numpy(syms), torch.from_numpy(valid), Ns, 64, 0x300, INCR)
    for l in range(len(sizes)):
        alone = dm.fenwick_encode_streams(
            torch.from_numpy(syms[l:l + 1]), torch.from_numpy(valid[l:l + 1]),
            Ns[l:l + 1], 64, 0x300, INCR)
        for a, b in zip(alone, together):
            assert torch.equal(a[0], b[l])


@pytest.mark.parametrize('max_n', [2, 5, 64, 258])
def test_init_and_rescale_match_jax(max_n):
    rng = np.random.default_rng(max_n)
    Ns = rng.integers(2, max_n + 1, 6).astype(np.int32)
    tree = dm.fenwick_init(torch.from_numpy(Ns), max_n, INCR)
    jtree = jdm.fenwick_init(jnp.asarray(Ns), max_n, INCR)
    np.testing.assert_array_equal(tree.numpy(), np.asarray(jtree))
    # random leaves with either plane set, then the rescale
    leaves = rng.integers(0, 1 << 32, tree.shape, dtype=np.int64)
    leaves &= np.where(rng.random(tree.shape) < 0.5, 0xFFFF, 0xFFFF0000)
    got = dm._rescale(torch.from_numpy(leaves), torch.from_numpy(Ns), max_n,
                      INCR)
    want = jdm._rescale(jnp.asarray(leaves.astype(np.uint32)),
                        jnp.asarray(Ns), max_n, INCR)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _host_streams(seed, sizes, T, max_prob, exact):
    """Host-encoded lanes, their symbols and their decoders' states after
    decode_start (the export_dec_state seam).  `exact`: the payload
    matrix is as wide as the longest lane, else 8 bytes wider."""
    rng = np.random.default_rng(seed)
    L = len(sizes)
    streams, states = [], []
    syms = np.zeros((L, T), np.int32)
    for l in range(L):
        syms[l] = np.minimum(rng.geometric(0.1, T) - 1, sizes[l] - 1)
        data = _host_lane(syms[l], sizes[l], max_prob, 0x42, 1)
        streams.append(data)
        ins = ArrayInputStream(data)
        dec = RangeCoder(ins)
        assert dec.decode_start(False) == 0x42
        states.append(dec.export_dec_state(ins.pos)[:4])
    B = max(len(s) for s in streams) + (0 if exact else 8)
    payload = np.zeros((L, B), np.uint8)
    for l, s in enumerate(streams):
        payload[l, :len(s)] = s
    return payload, np.stack(states), syms


@pytest.mark.parametrize('max_prob,exact', [(0x500, False), (0x500, True),
                                            (0xFF00, False)])
def test_fenwick_decode_streams_matches_jax_and_host(max_prob, exact):
    """Host-encoded lanes (escapes, and rescales at a low max_prob) decode
    from the exported host states equal to the host's symbols and to the
    JAX function, state included; steps masked off write 1 - N."""
    sizes = [4, 16, 100, 256, 256]
    T = 400
    payload, states, syms = _host_streams(3, sizes, T, max_prob, exact)
    Ns = np.array([s + 1 for s in sizes], np.int32)
    valid = np.ones((len(sizes), T), bool)
    valid[1, 300:] = False
    got, st = dm.fenwick_decode_streams(
        torch.from_numpy(payload), coder_states(states, 'cpu'),
        torch.from_numpy(Ns), 257, max_prob, INCR, torch.from_numpy(valid))
    want, jst = jdm.fenwick_decode_streams(
        jnp.asarray(payload), jnp.asarray(states), jnp.asarray(Ns), 257,
        max_prob, INCR, jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got.numpy()[valid], syms[valid])
    assert (got.numpy()[1, 300:] == 1 - Ns[1]).all()


@pytest.mark.parametrize('case', ['no_valid_step', 'holes', 'n2',
                                  'lanes20'])
def test_fenwick_decode_plain_edge_cases_match_jax(case):
    """The plain decode against the JAX function on the edge cases the
    card kernel is held to it on: a lane with no valid step, holes inside
    lanes, a model of N = 2, 20 lanes; host-encoded lanes from their
    exported states, symbols and states exact."""
    sizes = {'no_valid_step': [7, 30, 256], 'holes': [12, 100, 200],
             'n2': [1, 1, 5],
             'lanes20': [1 + (37 * l) % 256 for l in range(20)]}[case]
    T = 120
    payload, states, syms = _host_streams(11, sizes, T, 0x500, False)
    Ns = np.array([s + 1 for s in sizes], np.int32)
    valid = np.ones((len(sizes), T), bool)
    if case == 'no_valid_step':
        valid[1] = False
    if case in ('holes', 'lanes20'):
        valid[0, ::5] = False
        valid[2, 30:50] = False
    got, st = dm.fenwick_decode_streams(
        torch.from_numpy(payload), coder_states(states, 'cpu'),
        torch.from_numpy(Ns), 257, 0x500, INCR, torch.from_numpy(valid))
    want, jst = jdm.fenwick_decode_streams(
        jnp.asarray(payload), jnp.asarray(states), jnp.asarray(Ns), 257,
        0x500, INCR, jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got.numpy()[~valid] == np.repeat(1 - Ns, T).reshape(-1, T)[
        ~valid]).all()
    if case in ('no_valid_step', 'n2'):
        # no hole before a lane's steps: they decode to the host's symbols
        np.testing.assert_array_equal(got.numpy()[valid], syms[valid])


def test_encode_coder_decode_round_trip():
    """Port encode -> coder -> bytes -> port decode, from the free byte
    (decode_start's skip-initial-read form at byte 1), no host coder in
    the loop; the bytes equal the JAX chain's."""
    rng = np.random.default_rng(9)
    L, T, size, max_n = 3, 300, 64, 65
    syms = rng.integers(0, size, (L, T)).astype(np.int32)
    Ns = torch.full((L,), size + 1)
    valid = torch.ones((L, T), dtype=torch.bool)
    sy, lt, tot, v = dm.fenwick_encode_streams(torch.from_numpy(syms), valid,
                                               Ns, max_n, 0xFF00, INCR)
    tok, n, nb = dc.batched_range_encode(sy, lt, tot, v,
                                         torch.full((L,), 0x42),
                                         torch.ones(L, dtype=torch.int64))
    byts, lens = dc.token_bytes(tok, n, nb, 4 * T + 32)
    jsy = jdm.fenwick_encode_streams(jnp.asarray(syms), jnp.asarray(
        valid.numpy()), jnp.asarray(Ns.numpy()), max_n, 0xFF00, INCR)
    jbyts, _ = jdc.token_bytes(*jdc.batched_range_encode(
        *jsy, jnp.full(L, 0x42, jnp.uint32), jnp.ones(L, jnp.uint32)),
        4 * T + 32)
    np.testing.assert_array_equal(byts.numpy(), np.asarray(jbyts))
    state = torch.stack(dc.dec_start_state(
        byts, torch.ones(L, dtype=torch.int64)), 1)
    got, _ = dm.fenwick_decode_streams(byts, state, Ns, max_n, 0xFF00, INCR,
                                       valid)
    np.testing.assert_array_equal(got.numpy(), syms)


def _host_states(L, seed):
    """(L, 5) exported states of host coders started on a random free
    byte and length and advanced a few triples."""
    rng = np.random.default_rng(seed)
    states = []
    for l in range(L):
        rc = RangeCoder(BufferStream())
        rc.encode_start(int(rng.integers(0, 256)), int(rng.integers(0, 4)))
        for k in range(int(rng.integers(0, 40))):
            rc.encode_freq(1 + k % 3, k % 5, 9)
        states.append(rc.export_enc_state())
    return np.stack(states)


def _jax_code(syms, valid, Ns, max_n, max_prob, states, tok_cap, out_cap):
    """The JAX package's encode -> coder -> token_bytes composition."""
    trip = jdm.fenwick_encode_streams(jnp.asarray(syms), jnp.asarray(valid),
                                      jnp.asarray(Ns), max_n, max_prob, INCR)
    tok = jdc.batched_range_encode(*trip, None, None, tok_cap,
                                   init_state=jnp.asarray(states))
    return tok, jdc.token_bytes(*tok, out_cap)


@pytest.mark.parametrize('max_prob,tok_cap', [(0xFF00, None),
                                              (0x400, None), (0xFF00, 40)])
def test_fenwick_code_streams_matches_jax(max_prob, tok_cap):
    """Model and coder in one call equal the JAX package's encode ->
    coder -> token_bytes composition bit for bit: ragged lanes of model
    sizes 1 to 256 with holes in `valid` and one lane with no valid step,
    coders continuing exported host states; tok_cap 40 overflows the
    longer lanes (their counts still counted)."""
    sizes = [1, 256, 2, 3, 40, 200, 255, 17, 90, 128]
    T = 160
    syms, valid = _lanes(4, sizes, T, zipf=1.2)
    valid[1] = False                   # a lane with no valid step
    valid[3, ::4] = False              # holes
    valid[5, 10:30] = False
    Ns = np.array([s + 1 for s in sizes], np.int32)
    L = len(sizes)
    states = _host_states(L, 5)
    out_cap = 3 * 2 * T + 64
    (jtok, jn, jbc), (jbyts, jlens) = _jax_code(syms, valid, Ns, 258,
                                                max_prob, states, tok_cap,
                                                out_cap)
    tok, n, bc = dm.fenwick_code_streams(
        torch.from_numpy(syms), torch.from_numpy(valid), torch.from_numpy(Ns),
        258, max_prob, INCR, coder_states(states, 'cpu'), tok_cap)
    cap = tok_cap if tok_cap is not None else 6 * T + 8
    assert tok.shape == (L, cap, 3)
    np.testing.assert_array_equal(tok.numpy().astype(np.int64),
                                  np.asarray(jtok).astype(np.int64))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(bc.numpy(), np.asarray(jbc))
    byts, lens = dc.token_bytes(tok, n, bc, out_cap)
    np.testing.assert_array_equal(byts.numpy(), np.asarray(jbyts))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    if tok_cap is not None:
        assert int(n.max()) > tok_cap
    # the same as the two plain versions in series
    want = dc.batched_range_encode(*dm.fenwick_encode_streams(
        torch.from_numpy(syms), torch.from_numpy(valid), torch.from_numpy(Ns),
        258, max_prob, INCR), None, None, tok_cap,
        init_state=coder_states(states, 'cpu'))
    for a, b in zip((tok, n, bc), want):
        assert torch.equal(a, b)


def test_fenwick_code_streams_host_bytes():
    """Lanes from fresh coders: each lane's bytes are the host model's."""
    sizes = [4, 37, 200, 256]
    syms, valid = _lanes(6, sizes, 300, zipf=1.1)
    Ns = torch.tensor([s + 1 for s in sizes])
    L = len(sizes)
    zeros = torch.zeros(L, dtype=torch.int64)
    tok = dm.fenwick_code_streams(torch.from_numpy(syms),
                                  torch.from_numpy(valid), Ns, 258, 0x400,
                                  INCR, dc.encoder_states(zeros, zeros))
    byts, lens = dc.token_bytes(*tok, 3 * 600 + 16)
    for l in range(L):
        hb = _host_lane(syms[l][valid[l]], sizes[l], 0x400)
        assert int(lens[l]) == len(hb)
        np.testing.assert_array_equal(byts[l, :len(hb)].numpy(), hb)


def test_max_n_bounds():
    s = torch.zeros((1, 2), dtype=torch.int32)
    v = torch.ones((1, 2), dtype=torch.bool)
    for max_n in (1, dm.MAX_N_LIMIT + 1):
        with pytest.raises(ValueError):
            dm.fenwick_encode_streams(s, v, torch.tensor([2]), max_n,
                                      0xFF00, INCR)


def test_no_plain_version_off_the_cpu():
    s = torch.zeros((2, 3), dtype=torch.int32, device='meta')
    with pytest.raises(RuntimeError):
        dm.fenwick_encode_streams(s, s.bool(), torch.full((2,), 5), 8,
                                  0xFF00, INCR)
    with pytest.raises(RuntimeError):
        dm.fenwick_code_streams(s, s.bool(), torch.full((2,), 5), 8, 0xFF00,
                                INCR, torch.zeros((2, 5), dtype=torch.int64))
    with pytest.raises(RuntimeError):
        dm.fenwick_decode_streams(s.to(torch.uint8), torch.zeros((2, 4)),
                                  torch.full((2,), 5), 8, 0xFF00, INCR,
                                  s.bool())
