"""Device ms, per block, of the operations launched under the rotation
sort and BWT call (``ops.block_kernels.bwt_block``)."""

SPANS = ['compressjs_tpu_torch.ops.block_kernels.bwt_block']


def read(run):
    s = run.slice
    n = s.calls(SPANS[0])
    d = s.device_s_under(*SPANS)
    return 1e3 * d / n if n and d else None
