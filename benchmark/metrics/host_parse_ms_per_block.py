"""Host wall ms, per block, of the decoder's header parse and upload of
each candidate block (``parallel.decode._walk_inputs``, which runs
``host.bzip2_parse``)."""

SPANS = ['compressjs_tpu_torch.parallel.decode._walk_inputs']


def read(run):
    s = run.slice
    n = s.calls(SPANS[0])
    return 1e3 * s.host_s(SPANS[0]) / n if n else None
