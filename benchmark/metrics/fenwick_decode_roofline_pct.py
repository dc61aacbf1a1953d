"""Share of the HBM bound that the lanes' Fenwick model and range decode
(``csrc/fenwick_decode.cu``) reaches over its device time in the
slice."""

NAME = 'fenwick_decode_roofline_pct'
SPANS = ['compressjs_tpu_torch.ops.device_model.fenwick_decode_streams']
KERNELS = ('fenwick_decode_kernel',)


def bytes_of_call(lanes, payload_bytes, steps):
    """Each lane's coded bytes read once (payload_bytes a lane), each
    step's symbol written once (2 bytes: symbols reach 256), and each
    lane's coder state (low, range, buffer, position: 4 bytes each) read
    and written once."""
    return lanes * payload_bytes + 2 * lanes * steps + 2 * 16 * lanes


BYTES = {SPANS[0]: lambda args, kwargs, out: bytes_of_call(
    int(args[0].shape[0]), int(args[0].shape[1]), int(args[6].shape[1]))}


def read(run):
    s = run.slice
    t = s.kernel_s(*KERNELS)
    if not t or not s.bytes(NAME):
        return None
    return 100.0 * s.bytes(NAME) / s.peaks['hbm_bytes_per_s'] / t
