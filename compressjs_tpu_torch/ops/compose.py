"""Windowed composition of the Huffman walk's next-position maps
(counterpart of ``compressjs_tpu.ops.pallas_compose``).

`compose_windowed(a, b, blo, bhi)` computes, for (G, cap) int32 maps,

    c[g, p] = a_pad[g, p + clip(b[g, p] - p, blo, bhi)]

with ``a_pad`` = ``a`` extended on the right by ``a[:, -1]``: the map
``a`` applied after ``b`` wherever ``b`` jumps by blo..bhi, and a clamped
value at tail positions whose jump was clipped, the same value every
build of the JAX package gives there.  For a CUDA tensor it launches
``csrc/compose_windowed.cu`` (replacing the Pallas ``_compose_kernel``);
for a CPU tensor it runs `compose_windowed_plain`.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..tracer import staged


def _check_window(a, b, blo, bhi):
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError('compose_windowed takes two (G, cap) maps, got '
                         '%s and %s' % (tuple(a.shape), tuple(b.shape)))
    if not 0 <= blo <= bhi:
        raise ValueError('compose_windowed: bad window [%d, %d]'
                         % (blo, bhi))


def compose_windowed_plain(a, b, blo, bhi):
    """Plain version of `compose_windowed`: pad, clip, gather."""
    _check_window(a, b, blo, bhi)
    G, cap = a.shape
    pos = torch.arange(cap, device=a.device)
    idx = pos + (b.to(torch.int64) - pos).clamp(blo, bhi)
    a_pad = torch.cat([a, a[:, -1:].expand(G, bhi + 1)], 1)
    return torch.gather(a_pad, 1, idx)


@staged('ops.compose_windowed')
def compose_windowed(a, b, blo, bhi):
    """c[g, p] = a[g, b[g, p]] for jumps b - p in [blo, bhi] (clipped
    into the window, read clamped at the tail).  a, b: (G, cap) int32.
    The CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor; for a tensor anywhere else it raises."""
    if a.device.type == 'cpu':
        return compose_windowed_plain(a, b, blo, bhi)
    _cuda.require_cuda(a, 'compose_windowed')
    _check_window(a, b, blo, bhi)
    if (a.dtype != torch.int32 or b.dtype != torch.int32
            or b.device != a.device or not a.is_contiguous()
            or not b.is_contiguous() or a.shape[0] > 65535):
        raise ValueError('compose_windowed takes contiguous int32 (G, cap) '
                         'tensors on one device, G <= 65535')
    G, cap = a.shape
    out = torch.empty_like(a)
    lib = _cuda.lib()
    _cuda.launches['compose_windowed'] += 1
    _cuda.check(lib.cz_compose_windowed(a.data_ptr(), b.data_ptr(),
                                        out.data_ptr(), G, cap, blo, bhi,
                                        _cuda.stream_handle(a.device)),
                'compose_windowed')
    return out
