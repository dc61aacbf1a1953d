"""Device ms, per block, of the operations launched under the parallel
Huffman walk (``ops.device_huffman.huffman_walk_dev``)."""

SPANS = ['compressjs_tpu_torch.ops.device_huffman.huffman_walk_dev']


def read(run):
    s = run.slice
    d = s.device_s_under(*SPANS)
    return 1e3 * d / s.blocks if s.blocks and d else None
