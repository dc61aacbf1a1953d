"""The batched range coder (compressjs_tpu_torch.ops.device_coder) against
``compressjs_tpu.ops.device_coder`` and the host coder, on the CPU, where
each wrapper runs its plain version: the tokens, their counts and the
byte counts of random ragged triple lanes, with and without exported
coder states; the 0-33 coded-bit flush sweep; `token_bytes` against the
JAX function and each lane's host RangeCoder bytes; the decoder's steps.
Integer codecs: every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from compressjs_tpu.coders.range_coder import RangeCoder as JaxRangeCoder
from compressjs_tpu.ops import device_coder as jdc
from compressjs_tpu.utils.stream import BufferStream as JaxBuffer
from compressjs_tpu_torch.convert import coder_states
from compressjs_tpu_torch.host.range_coder import RangeCoder
from compressjs_tpu_torch.host.stream import BufferStream
from compressjs_tpu_torch.ops import device_coder as dc
from tests import _cpu_share  # noqa: F401 -- caps torch's threads


def _host_encode(triples, first_byte, init_len, coder=RangeCoder,
                 buf=BufferStream):
    out = buf()
    rc = coder(out)
    rc.encode_start(first_byte, init_len)
    for sy, lt, tot in triples:
        rc.encode_freq(sy, lt, tot)
    bc = rc.encode_finish()
    return out.buffer[:out.pos].copy(), bc


def _random_lanes(seed, L=6, T=200):
    """(sy, lt, tot, valid) uint32/bool (L, T) with ragged lane lengths,
    one lane empty and one full, and each lane's triples."""
    rng = np.random.default_rng(seed)
    sy = np.ones((L, T), np.uint32)
    lt = np.zeros((L, T), np.uint32)
    tot = np.ones((L, T), np.uint32)
    valid = np.zeros((L, T), bool)
    lanes = []
    for l in range(L):
        tl = [0, T][l] if l < 2 else int(rng.integers(1, T))
        triples = []
        for t in range(tl):
            tf = int(rng.integers(2, 1 << 20))
            s = int(rng.integers(1, tf + 1))
            lf = int(rng.integers(0, tf - s + 1))
            triples.append((s, lf, tf))
            sy[l, t], lt[l, t], tot[l, t], valid[l, t] = s, lf, tf, True
        lanes.append(triples)
    return sy, lt, tot, valid, lanes


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


@pytest.mark.parametrize('with_states', [False, True])
def test_batched_range_encode_matches_jax(with_states):
    sy, lt, tot, valid, lanes = _random_lanes(1)
    L = sy.shape[0]
    rng = np.random.default_rng(2)
    fbs = rng.integers(0, 256, L).astype(np.uint32)
    ils = rng.integers(0, 4, L).astype(np.uint32)
    jargs = [jnp.asarray(x) for x in (sy, lt, tot, valid, fbs, ils)]
    args = [_t(x) for x in (sy, lt, tot)] + [torch.from_numpy(valid),
                                             _t(fbs), _t(ils)]
    kw, jkw = {}, {}
    if with_states:
        # host coders started and advanced a few steps: their states
        states = []
        for l in range(L):
            rc = RangeCoder(BufferStream())
            rc.encode_start(int(fbs[l]), int(ils[l]))
            for k in range(l):
                rc.encode_freq(1, k, 7)
            states.append(rc.export_enc_state())
        kw['init_state'] = coder_states(np.stack(states), 'cpu')
        jkw['init_state'] = jnp.asarray(np.stack(states))
    jt, jn, jb = jdc.batched_range_encode(*jargs, **jkw)
    tok, n, nb = dc.batched_range_encode(*args, **kw)
    assert tok.dtype == torch.int32 and tok.shape == tuple(jt.shape)
    np.testing.assert_array_equal(tok.numpy().view(np.uint32),
                                  np.asarray(jt))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jb))
    if not with_states:
        byts, lens = dc.token_bytes(tok, n, nb, 3 * sy.shape[1] + 16)
        for l in range(L):
            hb, hbc = _host_encode(lanes[l], int(fbs[l]), int(ils[l]))
            assert int(nb[l]) == hbc
            assert int(lens[l]) == len(hb)
            np.testing.assert_array_equal(byts[l, :len(hb)].numpy(), hb)


@pytest.mark.parametrize('nbits', range(34))
def test_coder_flush_sweep(nbits):
    """0-33 coded bits: every tail and flush case of the reference's
    test/range.js (encode_shift(1, b, 1) is encode_freq with tot 2),
    against the host coder and the JAX tokens."""
    bits = [(i * 7) % 2 for i in range(nbits)]
    hb, _ = _host_encode([(1, b, 2) for b in bits], 0x42, 0)
    sy = np.ones((1, 34), np.uint32)
    lt = np.zeros((1, 34), np.uint32)
    tot = np.full((1, 34), 2, np.uint32)
    valid = np.zeros((1, 34), bool)
    lt[0, :nbits] = bits
    valid[0, :nbits] = True
    fb, il = np.array([0x42], np.uint32), np.array([0], np.uint32)
    jt, jn, jb = jdc.batched_range_encode(
        *[jnp.asarray(x) for x in (sy, lt, tot, valid, fb, il)])
    tok, n, nb = dc.batched_range_encode(
        _t(sy), _t(lt), _t(tot), torch.from_numpy(valid), _t(fb), _t(il))
    np.testing.assert_array_equal(tok.numpy().view(np.uint32),
                                  np.asarray(jt))
    assert int(n[0]) == int(jn[0]) and int(nb[0]) == int(jb[0])
    byts, lens = dc.token_bytes(tok, n, nb, 34 * 3 + 16)
    assert int(lens[0]) == len(hb)
    np.testing.assert_array_equal(byts[0, :len(hb)].numpy(), hb)


@pytest.mark.parametrize('out_cap', [16, 700])
def test_token_bytes_matches_jax_and_host(out_cap):
    """Every lane's bytes equal the JAX expansion and, where they fit,
    the host coder's; lengths count the bytes past out_cap too."""
    sy, lt, tot, valid, lanes = _random_lanes(3)
    L = sy.shape[0]
    zeros = np.zeros(L, np.uint32)
    jt, jn, jb = jdc.batched_range_encode(
        *[jnp.asarray(x) for x in (sy, lt, tot, valid, zeros, zeros)])
    tok = torch.from_numpy(np.asarray(jt).view(np.int32).copy())
    n, nb = torch.from_numpy(np.array(jn)), _t(np.asarray(jb))
    byts, lens = dc.token_bytes(tok, n, nb, out_cap)
    jbyts, jlens = jdc.token_bytes(jt, jn, jb, out_cap)
    np.testing.assert_array_equal(byts.numpy(), np.asarray(jbyts))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    for l in range(L):
        hb, _ = _host_encode(lanes[l], 0, 0)
        jhb, _ = _host_encode(lanes[l], 0, 0, JaxRangeCoder, JaxBuffer)
        np.testing.assert_array_equal(hb, jhb)
        assert int(lens[l]) == len(hb)
        m = min(len(hb), out_cap)
        np.testing.assert_array_equal(byts[l, :m].numpy(), hb[:m])
        assert not byts[l, m:].any()


def test_token_cap_drops_and_counts():
    """Tokens past tok_cap are dropped but counted, as the JAX scan
    does."""
    sy, lt, tot, valid, _ = _random_lanes(4)
    L = sy.shape[0]
    zeros = np.zeros(L, np.uint32)
    jt, jn, jb = jdc.batched_range_encode(
        *[jnp.asarray(x) for x in (sy, lt, tot, valid, zeros, zeros)], 9)
    tok, n, nb = dc.batched_range_encode(
        *[_t(x) for x in (sy, lt, tot)], torch.from_numpy(valid),
        _t(zeros), _t(zeros), 9)
    assert tok.shape == (L, 9, 3)
    np.testing.assert_array_equal(tok.numpy().view(np.uint32),
                                  np.asarray(jt))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    assert int(n.max()) > 9


def test_encoder_states_equal_host_start():
    fb, il = [0, 7, 255], [0, 1, 3]
    st = dc.encoder_states(torch.tensor(fb), torch.tensor(il))
    for l in range(3):
        rc = RangeCoder(BufferStream())
        rc.encode_start(fb[l], il[l])
        np.testing.assert_array_equal(st[l].numpy(), rc.export_enc_state())


def test_decoder_steps_match_jax():
    """dec_start_state, then decode_cul_freq and decode_update steps on
    random payloads (reads run past their ends: the EOF byte), against
    the JAX functions."""
    rng = np.random.default_rng(5)
    L, B = 5, 12
    payload = rng.integers(0, 256, (L, B)).astype(np.uint8)
    pos = np.array([0, 1, 2, 5, 11], np.int32)
    st = dc.dec_start_state(torch.from_numpy(payload), torch.from_numpy(pos))
    jst = jdc.dec_start_state(jnp.asarray(payload), jnp.asarray(pos))
    pay, jpay = torch.from_numpy(payload), jnp.asarray(payload)
    for step in range(12):
        tot = rng.integers(1, 1 << 16, L)
        active = rng.random(L) < 0.8
        for a, b in zip(st, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        st, help_, cul = dc.dec_cul_freq(st, pay, _t(tot),
                                         torch.from_numpy(active))
        jst, jhelp, jcul = jdc.dec_cul_freq(
            jst, jpay, jnp.asarray(tot.astype(np.uint32)),
            jnp.asarray(active))
        np.testing.assert_array_equal(help_.numpy(), np.asarray(jhelp))
        np.testing.assert_array_equal(cul.numpy(), np.asarray(jcul))
        lt = np.minimum(cul.numpy(), tot - 1)
        sy = np.ones(L, np.int64)
        st = dc.dec_update(st, help_, _t(sy), _t(lt), _t(tot))
        jst = jdc.dec_update(jst, jhelp, jnp.asarray(sy.astype(np.uint32)),
                             jnp.asarray(lt.astype(np.uint32)),
                             jnp.asarray(tot.astype(np.uint32)))
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_coder_states_shapes():
    enc = coder_states(np.zeros((3, 5), np.int64), 'cpu')
    dec = coder_states(np.zeros((2, 4), np.int64), 'cpu')
    assert enc.dtype == dec.dtype == torch.int64
    assert tuple(enc.shape) == (3, 5) and tuple(dec.shape) == (2, 4)
    with pytest.raises(ValueError):
        coder_states(np.zeros((3, 6), np.int64), 'cpu')


def test_no_plain_version_off_the_cpu():
    """A tensor on neither the CPU nor a card gets no plain version: the
    wrapper raises."""
    sy = torch.ones((2, 3), dtype=torch.int32, device='meta')
    with pytest.raises(RuntimeError):
        dc.batched_range_encode(sy, sy, sy, sy.bool(), torch.zeros(2),
                                torch.zeros(2))
