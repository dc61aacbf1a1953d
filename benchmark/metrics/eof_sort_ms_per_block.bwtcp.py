"""Device ms, per block, of the operations launched under the
EOF-terminated suffix sort and BWT (``ops.block_kernels.bwt_eof_block``)
of the BWTC-P encode."""

SPANS = ['compressjs_tpu_torch.ops.block_kernels.bwt_eof_block']


def read(run):
    s = run.slice
    n = s.calls(SPANS[0])
    d = s.device_s_under(*SPANS)
    return 1e3 * d / n if n and d else None
