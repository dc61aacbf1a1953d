"""Device ms, per block, of the operations launched under BWTC-L's block
decode on the card (``ops.device_lane.decode_block_lanes``: the lanes'
Fenwick models and range decoders, RLE2 and MTF undo, the inverse EOF
BWT)."""

SPANS = ['compressjs_tpu_torch.ops.device_lane.decode_block_lanes']


def read(run):
    s = run.slice
    n = s.calls(SPANS[0])
    d = s.device_s_under(*SPANS)
    return 1e3 * d / n if n and d else None
