"""Device ms, per block on the card, of the BWTC-L encode's lane coder
and the assembly of its stream: the operations launched under the 128
lanes' fused Fenwick model and range coder
(``ops.device_model.fenwick_code_streams``, with the zeroing of its token
buffer), the tokens' expansion to each lane's bytes
(``ops.device_coder.token_bytes``) and the lanes' bytes laid end to end
for one download (``ops.device_lane.ragged_concat``)."""

SPANS = ['compressjs_tpu_torch.ops.device_model.fenwick_code_streams',
         'compressjs_tpu_torch.ops.device_coder.token_bytes',
         'compressjs_tpu_torch.ops.device_lane.ragged_concat']


def read(run):
    s = run.slice
    d = s.device_s_under(*SPANS)
    return 1e3 * d / s.blocks if s.blocks and d else None
