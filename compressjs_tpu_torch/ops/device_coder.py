"""Batched Schindler range coder (counterpart of
``compressjs_tpu.ops.device_coder``).

One range coder's carry chain is sequential, so the batch is over
independent lanes: lane l codes its own (sy_f, lt_f, tot_f) triples byte
for byte as the host coder (``host.range_coder.RangeCoder``).  Lanes are
BWTC-P blocks (``parallel.pipeline.bwtcp_compress_device``) or the
round-robin sub-streams of one BWTC-L block (``ops.device_lane``).

* `batched_range_encode` emits (byte, run, fill) tokens: each byte the
  coder shifts out with its settled carry is one token, the pending-carry
  run of 0xFF or 0x00 bytes behind it its run.  For a CUDA tensor it is
  one launch of ``csrc/fenwick_encode.cu``'s coder entry
  (``cz_range_encode``); for a CPU tensor its plain version
  `batched_range_encode_plain` runs, one vector step per triple.  The
  BWTC-P and BWTC-L encodes code through
  ``ops.device_model.fenwick_code_streams``, model and coder in one
  launch.
* `token_bytes` expands the tokens into each lane's bytes: a count sum,
  a searchsorted of every byte's token and a gather.
* `dec_start_state`, `_dec_normalize`, `dec_cul_freq` and `dec_update`
  are the decoder's steps over lane vectors, the pieces of the plain
  version of ``ops.device_model.fenwick_decode_streams`` (its kernel,
  ``csrc/fenwick_decode.cu``, inlines them).

The JAX package computes in uint32 and wraps; torch has no full uint32
arithmetic on the CPU, so the plain code computes in int64 and masks to
32 bits where the JAX code wraps.  Tensors that the kernels write hold
the u32 bits in int32 (triples, tokens) or int64 (states, byte counts).
"""

from __future__ import annotations

import torch

from . import _cuda

M32 = 0xFFFFFFFF
TOP = 1 << 31
BOTTOM = 1 << 23
SHIFT_BITS = 23
EXTRA_BITS = 7   # (CODE_BITS - 2) % 8 + 1 of the reference coder


def encoder_states(first_byte, init_len):
    """(L, 5) int64 encoder states after encode_start(first_byte,
    init_len): (low, range, buffer, help, bytecount) = (0, 2^31,
    first_byte, 0, init_len), on first_byte's device."""
    fb = torch.as_tensor(first_byte).to(torch.int64) & M32
    st = torch.zeros((fb.shape[0], 5), dtype=torch.int64, device=fb.device)
    st[:, 1] = TOP
    st[:, 2] = fb
    st[:, 4] = torch.as_tensor(init_len, device=fb.device).to(
        torch.int64) & M32
    return st


def _u32(t):
    """int64 tensor of the u32 bits of `t` (any integer or bool dtype)."""
    return t.to(torch.int64) & M32


def _last_step(valid):
    """1 + the last column where any lane is valid (0 if none): the plain
    versions stop there, since later steps change no state."""
    cols = torch.nonzero(valid.any(0))
    return int(cols[-1]) + 1 if cols.numel() else 0


def _normalize_iter(st, tokens, tok_n, rows, active):
    """One enc_normalize iteration for every lane (masked by `active`);
    tokens past the cap go to the trash row tokens[:, cap]."""
    low, rng, buf, help_, bc = st
    cap = tokens.shape[1] - 1
    need = (rng <= BOTTOM) & active
    cond1 = low < (0xFF << SHIFT_BITS)
    emit = need & (cond1 | ((low & TOP) != 0))
    col = torch.where(emit & (tok_n < cap), tok_n, cap)
    tokens[rows, col, 0] = torch.where(cond1, buf, (buf + 1) & 0xFF)
    tokens[rows, col, 1] = help_
    tokens[rows, col, 2] = torch.where(cond1, 0xFF, 0)
    tok_n = tok_n + emit.to(torch.int64)
    buf = torch.where(emit, (low >> SHIFT_BITS) & 0xFF, buf)
    help_ = torch.where(emit, 0, torch.where(need, (help_ + 1) & M32,
                                             help_))
    rng = torch.where(need, (rng << 8) & M32, rng)
    low = torch.where(need, (low << 8) & (TOP - 1), low)
    bc = torch.where(need, (bc + 1) & M32, bc)
    return (low, rng, buf, help_, bc), tok_n


def batched_range_encode_plain(sy_f, lt_f, tot_f, step_valid, init, cap):
    """Plain version of `batched_range_encode` from the (L, 5) states
    `init`: one vector step per triple over all lanes, up to the last
    valid one, then encode_finish."""
    L, T = sy_f.shape
    dev = sy_f.device
    rows = torch.arange(L, device=dev)
    tokens = torch.zeros((L, cap + 1, 3), dtype=torch.int64, device=dev)
    tok_n = torch.zeros(L, dtype=torch.int64, device=dev)
    st = tuple(init[:, k] & M32 for k in range(5))
    sy_f, lt_f, tot_f = _u32(sy_f), _u32(lt_f), _u32(tot_f)
    for t in range(_last_step(step_valid)):
        valid = step_valid[:, t]
        for _ in range(3):
            st, tok_n = _normalize_iter(st, tokens, tok_n, rows, valid)
        low, rng, buf, help_, bc = st
        sy, lt, tot = sy_f[:, t], lt_f[:, t], tot_f[:, t]
        r = rng // tot.clamp(min=1)
        tmp = (r * lt) & M32
        rng2 = torch.where(((lt + sy) & M32) < tot, (r * sy) & M32,
                           (rng - tmp) & M32)
        st = (torch.where(valid, (low + tmp) & M32, low),
              torch.where(valid, rng2, rng), buf, help_, bc)
    always = torch.ones(L, dtype=torch.bool, device=dev)
    for _ in range(3):
        st, tok_n = _normalize_iter(st, tokens, tok_n, rows, always)
    low, rng, buf, help_, bc = st
    bc = (bc + 5) & M32
    top = (low >> SHIFT_BITS) + (
        (low & (BOTTOM - 1)) >= ((bc & 0xFFFFFF) >> 1)).to(torch.int64)
    carry = top > 0xFF
    tail = [(torch.where(carry, (buf + 1) & 0xFF, buf), help_,
             torch.where(carry, 0, 0xFF))]
    tail += [(v, 0, 0) for v in (top & 0xFF, (bc >> 16) & 0xFF,
                                 (bc >> 8) & 0xFF, bc & 0xFF)]
    for byte, run, fill in tail:
        col = torch.where(tok_n < cap, tok_n, cap)
        tokens[rows, col, 0] = byte
        tokens[rows, col, 1] = run
        tokens[rows, col, 2] = fill
        tok_n = tok_n + 1
    return tokens[:, :cap].to(torch.int32), tok_n.to(torch.int32), bc


def batched_range_encode(sy_f, lt_f, tot_f, step_valid, first_byte,
                         init_len, tok_cap=None, init_state=None):
    """Code L independent triple streams.

    sy_f, lt_f, tot_f: (L, T) integer tensors of u32 values (tot_f <
    2^23; an encode_shift is tot_f = 1 << shift); step_valid: (L, T)
    bool (lanes may be ragged); first_byte, init_len: (L,) the
    encode_start free byte and initial byte count.  init_state, (L, 5)
    int64 exported host coder states (``RangeCoder.export_enc_state``),
    replaces first_byte and init_len, to continue coders that the host
    started.

    Returns (tokens (L, cap, 3) int32 of u32 bits, tok_n (L,) int32,
    bytecounts (L,) int64), cap = tok_cap or 3T + 8; tokens past cap are
    dropped and counted.  For a CUDA tensor one launch of
    ``csrc/fenwick_encode.cu``'s ``cz_range_encode``; for a CPU tensor
    `batched_range_encode_plain`."""
    L, T = sy_f.shape
    cap = tok_cap if tok_cap is not None else 3 * T + 8
    dev = sy_f.device
    init = (init_state.to(device=dev, dtype=torch.int64)
            if init_state is not None else
            encoder_states(torch.as_tensor(first_byte, device=dev),
                           init_len))
    if dev.type == 'cpu':
        return batched_range_encode_plain(sy_f, lt_f, tot_f, step_valid,
                                          init, cap)
    _cuda.require_cuda(sy_f, 'batched_range_encode')
    sy, lt, tot = (x.to(torch.int32).contiguous() for x in (sy_f, lt_f,
                                                             tot_f))
    valid = step_valid.to(device=dev, dtype=torch.uint8).contiguous()
    init = init.contiguous()
    if valid.shape != (L, T) or init.shape != (L, 5):
        raise ValueError('batched_range_encode: step_valid (L, T) and '
                         'states (L, 5), not %s and %s'
                         % (tuple(valid.shape), tuple(init.shape)))
    tokens = torch.zeros((L, cap, 3), dtype=torch.int32, device=dev)
    tok_n = torch.empty(L, dtype=torch.int32, device=dev)
    nbytes = torch.empty(L, dtype=torch.int64, device=dev)
    _cuda.launches['range_encode'] += 1
    _cuda.check(_cuda.lib().cz_range_encode(
        sy.data_ptr(), lt.data_ptr(), tot.data_ptr(), valid.data_ptr(),
        init.data_ptr(), L, T, tokens.data_ptr(), cap, tok_n.data_ptr(),
        nbytes.data_ptr(), _cuda.stream_handle(dev)), 'range_encode')
    return tokens, tok_n, nbytes


def token_bytes(tokens, tok_counts, bytecounts, out_cap):
    """Each lane's bytes from its (byte, run, fill) tokens: (bytes
    (L, out_cap) uint8, lengths (L,) int64).  Token k writes its byte,
    then `run` bytes of `fill`, from the sum of the earlier tokens'
    counts; the first token's byte is the encode_start free byte, as the
    host coder's first write.  A lane's length is its full count, also
    where it passes out_cap (the bytes past out_cap are dropped)."""
    L, cap, _ = tokens.shape
    dev = tokens.device
    if cap == 0:
        return (torch.zeros((L, out_cap), dtype=torch.uint8, device=dev),
                torch.zeros(L, dtype=torch.int64, device=dev))
    tvalid = torch.arange(cap, device=dev)[None, :] < \
        tok_counts.to(torch.int64)[:, None]
    out_cnt = torch.where(tvalid, 1 + _u32(tokens[..., 1]), 0)
    ends = torch.cumsum(out_cnt, 1)
    total = ends[:, -1]
    slots = torch.arange(out_cap, device=dev).expand(L, out_cap) \
        .contiguous()
    iat = torch.searchsorted(ends, slots, right=True).clamp_(max=cap - 1)
    first = slots == ends.gather(1, iat) - out_cnt.gather(1, iat)
    val = torch.where(first, tokens[..., 0].to(torch.int64).gather(1, iat),
                      tokens[..., 2].to(torch.int64).gather(1, iat))
    out = torch.where(slots < total[:, None], val & 0xFF, 0)
    return out.to(torch.uint8), total


def dec_start_state(payload, pos):
    """Per-lane decoder state after decode_start(skip_initial_read) at
    byte pos (L,) of payload (L, B) uint8: (low, range, buffer, pos + 1)
    int64 lane vectors."""
    L, B = payload.shape
    pos = torch.as_tensor(pos, device=payload.device).to(torch.int64)
    rows = torch.arange(L, device=payload.device)
    buf = payload[rows, pos.clamp(max=B - 1)].to(torch.int64)
    low = buf >> (8 - EXTRA_BITS)
    rng = torch.full((L,), 1 << EXTRA_BITS, dtype=torch.int64,
                     device=payload.device)
    return low, rng, buf, pos + 1


def _dec_normalize(state, payload, active):
    """Masked _dec_normalize of every lane (4 iterations bring the range
    above 2^23); a read past the payload's end yields 0xFFFFFFFF, the
    u32 bits of the host coder's -1."""
    low, rng, buf, pos = state
    L, B = payload.shape
    rows = torch.arange(L, device=payload.device)
    for _ in range(4):
        need = (rng <= BOTTOM) & active
        nxt = torch.where(pos < B,
                          payload[rows, pos.clamp(max=B - 1)].to(torch.int64),
                          M32)
        low2 = ((low << 8) | ((buf << EXTRA_BITS) & 0xFF)) & M32
        low2 = low2 | (nxt >> (8 - EXTRA_BITS))
        low = torch.where(need, low2, low)
        buf = torch.where(need, nxt & 0xFF, buf)
        pos = torch.where(need, pos + 1, pos)
        rng = torch.where(need, (rng << 8) & M32, rng)
    return low, rng, buf, pos


def dec_cul_freq(state, payload, tot, active):
    """decode_cul_freq of every lane: (state', help, cul)."""
    low, rng, buf, pos = _dec_normalize(state, payload, active)
    help_ = rng // tot.clamp(min=1)
    q = low // help_.clamp(min=1)
    cul = torch.where(q >= tot, (tot - 1) & M32, q)
    return (low, rng, buf, pos), help_, cul


def dec_update(state, help_, sy, lt, tot):
    """decode_update of every lane."""
    low, rng, buf, pos = state
    tmp = (help_ * lt) & M32
    rng = torch.where(((lt + sy) & M32) < tot, (help_ * sy) & M32,
                      (rng - tmp) & M32)
    return (low - tmp) & M32, rng, buf, pos
