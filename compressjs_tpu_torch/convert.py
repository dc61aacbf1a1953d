"""What crosses from the JAX package to this one: a compressor has no
weights, so it is each block's inputs, the encoder's constants, the
decoder's tables and the range coders' states."""

from __future__ import annotations

import numpy as np
import torch

from .tracer import stage_timer


def as_u8(data):
    """bytes-like or array `data` as a contiguous uint8 array: what every
    entry point takes in."""
    return np.frombuffer(bytes(data), dtype=np.uint8) \
        if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data, dtype=np.uint8)


def checked_device(device, what):
    """torch.device(device) for the entry point `what`; raises for 'cuda'
    without a card."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("%s: CUDA is not available; pass device='cpu' to "
                           'run on the CPU' % what)
    return dev


def block_inputs(block_u8, remap_i32, eob, device):
    """The numpy arrays ``compressjs_tpu.ops.device_entropy.
    encode_block_full(block, n, remap, eob)`` takes, as this package's
    inputs to ``ops.device_entropy.encode_block_full``: (block uint8
    tensor, remap int64 tensor, eob int), on `device`."""
    block = torch.from_numpy(np.ascontiguousarray(block_u8, dtype=np.uint8))
    remap = torch.from_numpy(np.asarray(remap_i32, dtype=np.int64))
    stage_timer().add('host_syncs', 2)  # uploads from pageable memory
    return block.to(device), remap.to(device), int(eob)


def decode_tables(limits, bases, perms, mins, device):
    """The decode tables ``tables_for_device`` returns (numpy, or the JAX
    package's arrays through ``np.asarray``) as this package's int32
    tensors on `device`, in the same order: a decoder has no weights, so
    these are what both packages are fed."""
    stage_timer().add('host_syncs', 4)  # uploads from pageable memory
    return tuple(torch.from_numpy(np.array(x, dtype=np.int32))
                 .to(device) for x in (limits, bases, perms, mins))


def coder_states(states, device):
    """Exported host range coder states, (L, 5) encoder states
    (``RangeCoder.export_enc_state``: low, range, buffer, help,
    bytecount) or (L, 4) decoder states (``export_dec_state``: low,
    range, buffer, read position), int64 numpy (either package's coder),
    as this package's int64 tensor on `device`: what
    ``ops.device_coder.batched_range_encode(init_state=)`` and
    ``ops.device_model.fenwick_decode_streams`` take."""
    st = np.asarray(states, dtype=np.int64)
    if st.ndim != 2 or st.shape[1] not in (4, 5):
        raise ValueError('coder states of shape (L, 4) or (L, 5), not %s'
                         % (st.shape,))
    return torch.from_numpy(np.ascontiguousarray(st)).to(device)
