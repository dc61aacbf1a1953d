"""Share of the HBM bound that the fused Fenwick model and range coder
(``csrc/fenwick_encode.cu`` ``cz_fenwick_code``, kernel ``encode_kernel``)
reaches over its device time in the slice.

A byte bound is no floor for this kernel: each lane's coder is a chain
of dependent steps, so its time is set by the chain, and the share stays
far below 100 %.

The counts stay on the card until the run has ended: each call adds its
valid-symbol and byte counts as device tensors (two reductions launched
after the call, no read-back), summed when the metric is read."""

NAME = 'fenwick_code_roofline_pct'
SPANS = ['compressjs_tpu_torch.ops.device_model.fenwick_code_streams']
KERNELS = ('encode_kernel',)


def bytes_of_call(symbols, coded_bytes, lanes):
    """Each valid symbol read once (2 bytes: symbols reach 256), each
    byte the coders emit written once, and each lane's coder state read
    and written once at 16 bytes, as the decode's roofline counts a
    state."""
    return 2 * symbols + coded_bytes + 2 * 16 * lanes


def _count(args, kwargs, out):
    """fenwick_code_streams(symbols, step_valid, Ns, max_n, max_prob,
    increment, init_state, tok_cap) -> (tokens, tok_n, bytecounts): the
    valid steps, and each lane's final byte count less the one it
    started from."""
    valid, init = args[1], args[6]
    return bytes_of_call(valid.sum(), (out[2] - init[:, 4]).sum(),
                         valid.shape[0])


BYTES = {SPANS[0]: _count}


def read(run):
    s = run.slice
    t = s.kernel_s(*KERNELS)
    b = float(s.bytes(NAME))
    if not t or not b:
        return None
    return 100.0 * b / s.peaks['hbm_bytes_per_s'] / t
