"""Typed configuration for the tier-3 (compile-time in the reference)
constants (SURVEY.md §5: "promote tier-3 constants to a typed config
dataclass").

The reference buries these as module-level constants
(Lzp3.js:12-28, Lzjb.js:55, Dmc.js:48-54, MTFModel.js:9-10); here they
are inspectable in one place, and the mutable ones can be overridden per
call via the codec props/parameters.  The values marked [format] change
the bit stream — altering them produces files only this configuration
can decode.

A copy of ``compressjs_tpu.config``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Lzp3Config:
    use_huffman_code: bool = False      # [format] first byte 0x80 flag
    use_defsum: bool = False            # [format]
    length_model_cutoff: int = 256      # [format] NoModel above this size
    log_window_size: int = 20           # [format] 1 MiB ring window
    match_len_contexts: int = 16        # [format]


@dataclasses.dataclass(frozen=True)
class LzjbConfig:
    c_compat: bool = True               # [format] offset 0 unusable
    lempel_size_base: int = 1024
    match_bits: int = 6                 # [format]
    match_min: int = 3                  # [format]


@dataclasses.dataclass(frozen=True)
class DmcConfig:
    min_cnt1: int = 8                   # per-call via props {'m': ...}
    min_cnt2: int = 128                 # per-call via props {'n': ...}
    max_trans_cnt: int = 0xFFFF
    clone_models: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    max_prob: int = 0xFF00              # adaptive model rescale threshold
    increment: int = 0x0100


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    mtf_chunk_len: int = 2048           # scan chunk for the device MTF
    bench_device_timeout_s: int = 480   # bench subprocess budget


DEFAULTS = {
    'lzp3': Lzp3Config(),
    'lzjb': LzjbConfig(),
    'dmc': DmcConfig(),
    'model': ModelConfig(),
    'device': DeviceConfig(),
}
