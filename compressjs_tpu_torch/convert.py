"""What crosses from the JAX package to this one: a compressor has no
weights, so it is each block's inputs, the encoder's constants and the
decoder's tables."""

from __future__ import annotations

import numpy as np
import torch


def block_inputs(block_u8, remap_i32, eob, device):
    """The numpy arrays ``compressjs_tpu.ops.device_entropy.
    encode_block_full(block, n, remap, eob)`` takes, as this package's
    inputs to ``ops.device_entropy.encode_block_full``: (block uint8
    tensor, remap int64 tensor, eob int), on `device`."""
    block = torch.from_numpy(np.ascontiguousarray(block_u8, dtype=np.uint8))
    remap = torch.from_numpy(np.asarray(remap_i32, dtype=np.int64))
    return block.to(device), remap.to(device), int(eob)


def decode_tables(limits, bases, perms, mins, device):
    """The decode tables ``tables_for_device`` returns (numpy, or the JAX
    package's arrays through ``np.asarray``) as this package's int32
    tensors on `device`, in the same order: a decoder has no weights, so
    these are what both packages are fed."""
    return tuple(torch.from_numpy(np.array(x, dtype=np.int32))
                 .to(device) for x in (limits, bases, perms, mins))
