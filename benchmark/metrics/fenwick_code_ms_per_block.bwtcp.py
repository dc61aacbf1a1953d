"""Device ms, per block on the card, of the operations launched under the
fused Fenwick model and range coder of the BWTC-P encode
(``ops.device_model.fenwick_code_streams``, one launch a dispatch of
whole-block lanes, with the zeroing of its token buffer)."""

SPANS = ['compressjs_tpu_torch.ops.device_model.fenwick_code_streams']


def read(run):
    s = run.slice
    d = s.device_s_under(*SPANS)
    return 1e3 * d / s.blocks if s.blocks and d else None
