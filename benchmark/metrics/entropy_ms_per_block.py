"""Device ms, per block, of the operations launched under the device
entropy stage's group optimisation and payload packing
(``ops.device_entropy``)."""

SPANS = ['compressjs_tpu_torch.ops.device_entropy.optimize_groups_dev',
         'compressjs_tpu_torch.ops.device_entropy.payload_pack_words_dev']


def read(run):
    s = run.slice
    d = s.device_s_under(*SPANS)
    return 1e3 * d / s.blocks if s.blocks and d else None
