"""Share of the HBM bound that the MTF undo kernels
(``csrc/mtf_undo.cu``, three launches a call) reach over their device
time in the slice.

The bytes are counted where the block's real column length is known on
the host, with no added sync: the bzip2 decode runs the kernels at the
block size of the stream's header, so its count is taken from each block
its read-back accepts (``parallel.decode._device_entropy_collect``); the
BWTC-L decode runs them on whole blocks (``device_lane.decode_block_lanes``,
whose blocks all have the length it is given).  A block the read-back
refuses (a false magic) adds time and no bytes."""

NAME = 'mtf_undo_roofline_pct'
SPANS = ['compressjs_tpu_torch.parallel.decode._device_entropy_collect',
         'compressjs_tpu_torch.ops.device_lane.decode_block_lanes']
KERNELS = ('mtf_undo_perm_kernel', 'mtf_undo_prefix_kernel',
           'mtf_undo_decode_kernel')


def bytes_of_call(n):
    """MTF undo of n indices: each index read once and each symbol
    written once, one byte each (both lie in 0..255)."""
    return 2 * n


BYTES = {
    # returns (U[:column length], orig_ptr, crc, end bit), or None
    SPANS[0]: lambda args, kwargs, out: (
        0 if out is None else bytes_of_call(int(out[0].shape[0]))),
    # decode_block_lanes(payload, block_size, ...)
    SPANS[1]: lambda args, kwargs, out: bytes_of_call(int(args[1])),
}


def read(run):
    s = run.slice
    t = s.kernel_s(*KERNELS)
    if not t or not s.bytes(NAME):
        return None
    return 100.0 * s.bytes(NAME) / s.peaks['hbm_bytes_per_s'] / t
