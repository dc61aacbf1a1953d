"""Share of the HBM bound that the windowed map composition
(``csrc/compose_windowed.cu``) reaches over its device time in the
slice."""

NAME = 'compose_windowed_roofline_pct'
SPANS = ['compressjs_tpu_torch.ops.compose.compose_windowed']
KERNELS = ('compose_windowed_kernel',)


def bytes_of_call(groups, cap):
    """c[g, p] = a[g, b[g, p]] over (groups, cap) maps of bit positions:
    a and b read once and c written once, 4 bytes an entry (a position
    in a block's payload passes 2^16)."""
    return 3 * 4 * groups * cap


BYTES = {SPANS[0]: lambda args, kwargs, out: bytes_of_call(
    *map(int, args[0].shape))}


def read(run):
    s = run.slice
    t = s.kernel_s(*KERNELS)
    if not t or not s.bytes(NAME):
        return None
    return 100.0 * s.bytes(NAME) / s.peaks['hbm_bytes_per_s'] / t
