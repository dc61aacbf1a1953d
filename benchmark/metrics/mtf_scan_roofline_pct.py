"""Share of the HBM bound that the MTF encode kernels
(``csrc/mtf_scan.cu``, three launches a call) reach: the least time the
card's memory allows for the bytes the algorithm needs, over the
kernels' device time in the slice."""

NAME = 'mtf_scan_roofline_pct'
SPANS = ['compressjs_tpu_torch.ops.block_kernels.mtf_encode']
KERNELS = ('mtf_tiles_kernel', 'mtf_prefix_kernel', 'mtf_encode_kernel')


def bytes_of_call(n):
    """MTF encode of n symbols: each symbol read once and each index
    written once, one byte each (both lie in 0..255)."""
    return 2 * n


BYTES = {SPANS[0]: lambda args, kwargs, out: bytes_of_call(int(args[1]))}


def read(run):
    s = run.slice
    t = s.kernel_s(*KERNELS)
    if not t or not s.bytes(NAME):
        return None
    return 100.0 * s.bytes(NAME) / s.peaks['hbm_bytes_per_s'] / t
