"""Batched adaptive Fenwick model (counterpart of
``compressjs_tpu.ops.device_model``).

The host model's heap-layout u32 tree (``host.fenwick_model``) becomes
one (L, 2 * max_n) row per lane: L independent lanes (BWTC-P blocks, or
the sub-streams of a BWTC-L block) walk their own trees, each with its
own alphabet size N (model size + 1, padded to max_n), bit for bit as
the host model: the escape sub-step first, the last-escape removal, and
the halving rescale with re-escape.

* `fenwick_encode_streams` turns (L, T) symbols into the (L, 2T)
  triples that ``ops.device_coder.batched_range_encode`` codes.
* `fenwick_code_streams` is those two in one: symbols to the coder's
  tokens, the triples never leaving the kernel (the BWTC-P and BWTC-L
  encodes call it).
* `fenwick_decode_streams` decodes (L, T) symbols from the lanes' bytes,
  with the range decoder fused in (the root -> leaf walk depends on
  every decoded frequency).

For a CUDA tensor each is one launch of its kernel
(``csrc/fenwick_encode.cu`` and ``csrc/fenwick_decode.cu``: a block a
lane, its tree in shared memory); for a CPU tensor its plain
version runs, one vector step per symbol over all lanes, in int64
masked to 32 bits where the JAX package's uint32 wraps.  Symbols are
non-negative.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import device_coder as dc
from ..tracer import stage_timer, staged

M32 = dc.M32
ESC_MASK = 0x0000FFFF
SYM_MASK = 0xFFFF0000
SYM_SHIFT = 16
SCALE_MASK = 0xFFFEFFFE
MAX_N_LIMIT = 4096   # trees of 2 * max_n words; the kernels' bound


def _depth(max_n):
    return (2 * max_n - 1).bit_length()


def fenwick_init(Ns, max_n, increment):
    """Initial (L, 2 * max_n) int64 trees for per-lane sizes Ns (host
    FenwickModel.__init__): the N - 1 symbol leaves hold one escape
    count, the escape leaf the increment in the symbol plane, then the
    internal sums."""
    Ns = Ns.to(torch.int64)
    cols = torch.arange(2 * max_n, device=Ns.device)[None, :]
    N = Ns[:, None]
    tree = ((cols >= N) & (cols < 2 * N - 1)).to(torch.int64)
    tree = torch.where(cols == 2 * N - 1, increment << SYM_SHIFT, tree)
    return _sum_tree(tree, Ns, max_n)


def _sum_tree(tree, Ns, max_n):
    """Internal sums, level by level from the deepest (so every parent
    reads final children); nodes >= each lane's N are its leaves and are
    kept."""
    width = tree.shape[1]
    N = Ns.to(torch.int64)[:, None]
    tree = tree.clone()
    for lev in range((max_n - 1).bit_length(), -1, -1):
        lo, hi = 1 << lev, min(2 << lev, width)
        if lo >= hi:
            continue
        idx = torch.arange(lo, hi, device=tree.device)
        c0, c1 = 2 * idx, 2 * idx + 1
        s = torch.where(c0 < width, tree[:, c0.clamp(max=width - 1)], 0) + \
            torch.where(c1 < width, tree[:, c1.clamp(max=width - 1)], 0)
        tree[:, lo:hi] = torch.where(idx[None, :] < N, s & M32,
                                     tree[:, lo:hi])
    return tree


def _rescale(tree, Ns, max_n, increment):
    """Host _rescale, over every lane: halve the symbol leaves (a leaf
    still carrying an escape count is kept), re-escape those that halve
    to 0, then the escape leaf, then the internal sums."""
    cols = torch.arange(tree.shape[1], device=tree.device)[None, :]
    N = Ns.to(torch.int64)[:, None]
    sym_leaf = (cols >= N) & (cols < 2 * N - 1)
    esc_leaf = cols == 2 * N - 1
    has_esc = (tree & ESC_MASK) != 0
    halved = (tree & SCALE_MASK) >> 1
    newly = sym_leaf & ~has_esc & (halved == 0)
    new_sym = torch.where(has_esc, tree, torch.where(newly, 1, halved))
    no_escape = ~(sym_leaf & (has_esc | newly)).any(1, keepdim=True)
    new_esc = torch.where(no_escape, 0,
                          torch.where(halved == 0, 1 << SYM_SHIFT, halved))
    tree = torch.where(sym_leaf, new_sym, torch.where(esc_leaf, new_esc,
                                                      tree))
    return _sum_tree(tree, Ns, max_n)


class _Trees:
    """The plain versions' (L, width) trees, with a trash column at
    `width` that masked-off adds go to."""

    def __init__(self, Ns, max_n, increment):
        self.Ns = Ns.to(torch.int64)
        self.max_n, self.increment = max_n, increment
        self.width = 2 * max_n
        L = Ns.shape[0]
        self.t = torch.zeros((L, self.width + 1), dtype=torch.int64,
                             device=Ns.device)
        self.t[:, :self.width] = fenwick_init(Ns, max_n, increment)
        self.rows = torch.arange(L, device=Ns.device)

    def get(self, i):
        return self.t[self.rows, i.clamp(0, self.width - 1)]

    def add(self, i, val, on):
        col = torch.where(on, i, self.width)
        self.t[self.rows, col] = (self.t[self.rows, col] + val) & M32

    def root(self):
        return self.t[:, 1].clone()

    def rescale_where(self, need):
        """Rescale the lanes where `need` (one host sync to skip the
        common case where none does)."""
        if bool(need.any()):
            body = self.t[:, :self.width]
            self.t[:, :self.width] = torch.where(
                need[:, None],
                _rescale(body, self.Ns, self.max_n, self.increment), body)


def _planes(plane_esc):
    """(mask, shift) per lane of a bool plane choice (True: escapes)."""
    return (torch.where(plane_esc, ESC_MASK, SYM_MASK),
            torch.where(plane_esc, 0, SYM_SHIFT))


def _sub_encode(tr, sym, plane_esc, active, upd_sym, max_prob, depth,
                raw_pre=None):
    """One host encode() body without its escape recursion, for every
    lane (walks only where `active`): returns (sy, lt, tot)."""
    Ns = tr.Ns
    i = Ns + sym
    raw = tr.get(i)
    last_esc = ~plane_esc & (sym == Ns - 1) & ((tr.root() & ESC_MASK) == 1)
    update = torch.where(plane_esc, upd_sym - 1,
                         torch.where(last_esc, (0 - raw) & M32, upd_sym))
    lt = torch.zeros_like(raw)
    for _ in range(depth):
        cont = (i > 1) & active
        lt = torch.where(cont & ((i & 1) == 1), (lt + tr.get(i - 1)) & M32,
                         lt)
        tr.add(i, update, cont)
        i = torch.where(cont, i >> 1, i)
    tot = tr.root()
    tr.add(torch.ones_like(i), update, active)
    mask, shift = _planes(plane_esc)
    src = raw if raw_pre is None else raw_pre
    out = ((src & mask) >> shift, (lt & mask) >> shift, (tot & mask) >> shift)
    tr.rescale_where((tr.root() >> SYM_SHIFT) >= max_prob)
    return out


def fenwick_encode_streams_plain(symbols, step_valid, Ns, max_n, max_prob,
                                 increment):
    """Plain version of `fenwick_encode_streams`: one vector step per
    symbol over all lanes up to the last valid one, then the masked steps
    after it in one pass (they change no tree)."""
    L, T = symbols.shape
    dev = symbols.device
    tr = _Trees(Ns, max_n, increment)
    depth = _depth(max_n)
    upd_sym = increment << SYM_SHIFT
    syms = symbols.to(torch.int64)
    out = torch.zeros((4, L, T, 2), dtype=torch.int64, device=dev)
    no_esc = torch.zeros(L, dtype=torch.bool, device=dev)
    t, last = 0, dc._last_step(step_valid)
    # a masked step still rescales a lane whose root reached max_prob
    while t < T and (t < last or bool(
            ((tr.root() >> SYM_SHIFT) >= max_prob).any())):
        sym, active = syms[:, t], step_valid[:, t]
        raw = tr.get(tr.Ns + sym)
        escapes = ((raw & SYM_MASK) == 0) & active
        a = _sub_encode(tr, torch.where(escapes, tr.Ns - 1, sym), no_esc,
                        escapes, upd_sym, max_prob, depth)
        b = _sub_encode(tr, sym, escapes, active, upd_sym, max_prob, depth,
                        raw_pre=raw)
        for k in range(3):
            out[k, :, t, 0], out[k, :, t, 1] = a[k], b[k]
        out[3, :, t, 0], out[3, :, t, 1] = escapes, active
        t += 1
    if t < T:
        # masked steps: sy of the clamped leaf, lt 0, tot of the root
        leaf = tr.t.gather(1, (tr.Ns[:, None] + syms[:, t:]).clamp(
            0, tr.width - 1))
        out[0, :, t:] = ((leaf & SYM_MASK) >> SYM_SHIFT)[..., None]
        out[2, :, t:] = (tr.root() >> SYM_SHIFT)[:, None, None]
    sy, lt, tot, valid = (x.reshape(L, 2 * T) for x in out)
    return (sy.to(torch.int32), lt.to(torch.int32), tot.to(torch.int32),
            valid.to(torch.bool))


def _check_max_n(max_n):
    if not 2 <= max_n <= MAX_N_LIMIT:
        raise ValueError('max_n %d outside [2, %d]' % (max_n, MAX_N_LIMIT))


def fenwick_encode_streams(symbols, step_valid, Ns, max_n, max_prob,
                           increment):
    """Code (L, T) symbol streams through per-lane Fenwick models of N =
    Ns[l] symbols (model size + 1; the symbols below N).

    Returns (sy, lt, tot, valid) of shape (L, 2T), int32 and bool: two
    triple slots per symbol, the escape sub-step first (valid only where
    the symbol escaped), for ``device_coder.batched_range_encode``.  For
    a CUDA tensor one launch of ``csrc/fenwick_encode.cu`` (raises if a
    lane's N or an unmasked symbol is out of range); for a CPU tensor
    `fenwick_encode_streams_plain`."""
    _check_max_n(max_n)
    if symbols.device.type == 'cpu':
        return fenwick_encode_streams_plain(symbols, step_valid, Ns, max_n,
                                            max_prob, increment)
    _cuda.require_cuda(symbols, 'fenwick_encode_streams')
    dev = symbols.device
    L, T = symbols.shape
    syms = symbols.to(torch.int32).contiguous()
    valid = step_valid.to(device=dev, dtype=torch.uint8).contiguous()
    Ns = Ns.to(device=dev, dtype=torch.int32).contiguous()
    if valid.shape != (L, T) or Ns.shape != (L,):
        raise ValueError('fenwick_encode_streams: step_valid (L, T) and Ns '
                         '(L,), not %s and %s' % (tuple(valid.shape),
                                                  tuple(Ns.shape)))
    sy, lt, tot = (torch.empty((L, 2 * T), dtype=torch.int32, device=dev)
                   for _ in range(3))
    vout = torch.empty((L, 2 * T), dtype=torch.bool, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    _cuda.launches['fenwick_encode'] += 1
    _cuda.check(_cuda.lib().cz_fenwick_encode(
        syms.data_ptr(), valid.data_ptr(), Ns.data_ptr(), L, T, max_n,
        max_prob, increment, sy.data_ptr(), lt.data_ptr(), tot.data_ptr(),
        vout.data_ptr(), err.data_ptr(), _cuda.stream_handle(dev)),
        'fenwick_encode')
    stage_timer().add('host_syncs')
    _raise_flag(int(err), 'fenwick_encode_streams')
    return sy, lt, tot, vout


def fenwick_code_streams_plain(symbols, step_valid, Ns, max_n, max_prob,
                               increment, init_state, tok_cap=None):
    """Plain version of `fenwick_code_streams`: the two plain versions in
    series."""
    T = symbols.shape[1]
    cap = tok_cap if tok_cap is not None else 6 * T + 8
    return dc.batched_range_encode_plain(
        *fenwick_encode_streams_plain(symbols, step_valid, Ns, max_n,
                                      max_prob, increment),
        init_state.to(torch.int64), cap)


@staged('ops.fenwick_code_streams')
def fenwick_code_streams(symbols, step_valid, Ns, max_n, max_prob,
                         increment, init_state, tok_cap=None):
    """Code (L, T) symbol streams through per-lane Fenwick models (as
    `fenwick_encode_streams`) straight into per-lane range coders that
    continue from init_state, (L, 5) int64 exported encoder states
    (``RangeCoder.export_enc_state``, or ``device_coder.encoder_states``).

    Returns (tokens (L, cap, 3) int32, tok_n (L,) int32, bytecounts (L,)
    int64), cap = tok_cap or 6T + 8: exactly
    ``batched_range_encode(*fenwick_encode_streams(...), None, None,
    tok_cap, init_state=init_state)``.  For a CUDA tensor one launch of
    ``csrc/fenwick_encode.cu``'s fused entry (raises if a lane's N or an
    unmasked symbol is out of range); for a CPU tensor
    `fenwick_code_streams_plain`."""
    _check_max_n(max_n)
    if symbols.device.type == 'cpu':
        return fenwick_code_streams_plain(symbols, step_valid, Ns, max_n,
                                          max_prob, increment, init_state,
                                          tok_cap)
    _cuda.require_cuda(symbols, 'fenwick_code_streams')
    dev = symbols.device
    L, T = symbols.shape
    cap = tok_cap if tok_cap is not None else 6 * T + 8
    syms = symbols.to(torch.int32).contiguous()
    valid = step_valid.to(device=dev, dtype=torch.uint8).contiguous()
    Ns = Ns.to(device=dev, dtype=torch.int32).contiguous()
    init = init_state.to(device=dev, dtype=torch.int64).contiguous()
    if valid.shape != (L, T) or Ns.shape != (L,) or init.shape != (L, 5):
        raise ValueError('fenwick_code_streams: step_valid (L, T), Ns (L,) '
                         'and states (L, 5), not %s, %s and %s'
                         % (tuple(valid.shape), tuple(Ns.shape),
                            tuple(init.shape)))
    tokens = torch.zeros((L, cap, 3), dtype=torch.int32, device=dev)
    tok_n = torch.empty(L, dtype=torch.int32, device=dev)
    nbytes = torch.empty(L, dtype=torch.int64, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    _cuda.launches['fenwick_code'] += 1
    _cuda.check(_cuda.lib().cz_fenwick_code(
        syms.data_ptr(), valid.data_ptr(), Ns.data_ptr(), L, T, max_n,
        max_prob, increment, init.data_ptr(), tokens.data_ptr(), cap,
        tok_n.data_ptr(), nbytes.data_ptr(), err.data_ptr(),
        _cuda.stream_handle(dev)), 'fenwick_code')
    stage_timer().add('host_syncs')
    _raise_flag(int(err), 'fenwick_code_streams')
    return tokens, tok_n, nbytes


def _raise_flag(flag, what):
    if flag:
        raise ValueError('%s: %s' % (what, 'a lane size outside [2, max_n]'
                                     if flag & 1 else
                                     'a symbol outside its lane\'s model'))


def _sub_decode(tr, state, payload, plane_esc, active, upd_sym, max_prob,
                depth):
    """One host _decode(is_escape) for the active lanes: (state',
    symbol)."""
    Ns = tr.Ns
    mask, shift = _planes(plane_esc)
    update = torch.where(plane_esc, upd_sym - 1, upd_sym)
    tot = (tr.root() & mask) >> shift
    state, help_, cul = dc.dec_cul_freq(state, payload, tot, active)
    i = torch.ones_like(Ns)
    lt = torch.zeros_like(tot)
    for _ in range(depth):
        cont = (i < Ns) & active
        tr.add(i, update, cont)
        left = (tr.get(2 * i) & mask) >> shift
        right = ((cul - lt) & M32) >= left
        lt = torch.where(cont & right, (lt + left) & M32, lt)
        i = torch.where(cont, 2 * i + right.to(torch.int64), i)
    symbol = i - Ns
    sy = (tr.get(i) & mask) >> shift
    tr.add(i, update, active)
    new = dc.dec_update(state, help_, sy, lt, tot)
    state = tuple(torch.where(active, n, o) for n, o in zip(new, state))
    # last-escape removal (host _decode's tail)
    last = active & (symbol == Ns - 1) & ((tr.root() & ESC_MASK) == 1)
    neg = (0 - tr.get(i)) & M32
    j = torch.where(last, i, 0)
    for _ in range(depth + 1):
        tr.add(j, neg, j >= 1)
        j = j >> 1
    tr.rescale_where(((tr.root() >> SYM_SHIFT) >= max_prob) & active)
    return state, symbol


def _dec_states(coder_state):
    """(low, range, buffer, pos) int64 lane vectors of (L, 4+) states."""
    st = coder_state.to(torch.int64)
    return st[:, 0] & M32, st[:, 1] & M32, st[:, 2] & M32, st[:, 3]


def fenwick_decode_streams_plain(payload, coder_state, Ns, max_n, max_prob,
                                 increment, step_valid):
    """Plain version of `fenwick_decode_streams`: one vector step per
    symbol over all lanes up to the last valid one; a masked step writes
    1 - N."""
    L, T = step_valid.shape
    tr = _Trees(Ns, max_n, increment)
    depth = _depth(max_n)
    upd_sym = increment << SYM_SHIFT
    state = _dec_states(coder_state)
    out = (1 - tr.Ns)[:, None].repeat(1, T)
    no_esc = torch.zeros(L, dtype=torch.bool, device=payload.device)
    for t in range(dc._last_step(step_valid)):
        active = step_valid[:, t]
        state, s1 = _sub_decode(tr, state, payload, no_esc, active, upd_sym,
                                max_prob, depth)
        escaped = active & (s1 == tr.Ns - 1)
        state, s2 = _sub_decode(tr, state, payload, ~no_esc, escaped,
                                upd_sym, max_prob, depth)
        out[:, t] = torch.where(escaped, s2, s1)
    return out.to(torch.int32), state


@staged('ops.fenwick_decode_streams')
def fenwick_decode_streams(payload, coder_state, Ns, max_n, max_prob,
                           increment, step_valid):
    """Decode (L, T) symbol streams through per-lane Fenwick models.

    payload: (L, B) uint8, each row one lane's coder bytes; coder_state:
    (L, 4+) int64 (low, range, buffer, next read position), the host
    coder's ``export_dec_state`` seam; step_valid (L, T) bool: the steps
    to decode (a lane's state does not move on the others).

    Returns (symbols (L, T) int32, (low, range, buffer, pos) int64 lane
    vectors): symbols in [0, N - 2], 1 - N at masked steps.  Read
    positions are not negative.  For a CUDA tensor one launch of
    ``csrc/fenwick_decode.cu`` (raises if a lane's N is out of range);
    for a CPU tensor `fenwick_decode_streams_plain`."""
    _check_max_n(max_n)
    if payload.device.type == 'cpu':
        return fenwick_decode_streams_plain(payload, coder_state, Ns, max_n,
                                            max_prob, increment, step_valid)
    _cuda.require_cuda(payload, 'fenwick_decode_streams')
    dev = payload.device
    L, B = payload.shape
    T = step_valid.shape[1]
    pay = payload.to(torch.uint8).contiguous()
    state = torch.stack(_dec_states(coder_state.to(dev)), 1).contiguous()
    valid = step_valid.to(device=dev, dtype=torch.uint8).contiguous()
    Ns = Ns.to(device=dev, dtype=torch.int32).contiguous()
    if valid.shape[0] != L or Ns.shape != (L,):
        raise ValueError('fenwick_decode_streams: step_valid (L, T) and Ns '
                         '(L,) for %d lanes' % L)
    out = torch.empty((L, T), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    _cuda.launches['fenwick_decode'] += 1
    _cuda.check(_cuda.lib().cz_fenwick_decode(
        pay.data_ptr(), B, state.data_ptr(), Ns.data_ptr(),
        valid.data_ptr(), L, T, max_n, max_prob, increment, out.data_ptr(),
        err.data_ptr(), _cuda.stream_handle(dev)), 'fenwick_decode')
    stage_timer().add('host_syncs')
    if int(err):
        raise ValueError('fenwick_decode_streams: a lane size outside '
                         '[2, max_n]')
    return out, tuple(state.unbind(1))
