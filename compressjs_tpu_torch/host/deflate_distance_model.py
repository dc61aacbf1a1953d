"""Deflate-style distance model: the lg model gets two entries per bit
length (top two bits of the distance), and only lg-2 low bits are coded
separately (reference lib/DeflateDistanceModel.js:11-53).
Part of the model toolkit; not used by any in-tree codec.

A copy of ``compressjs_tpu.models.deflate_distance_model``.
"""

from __future__ import annotations

from . import util


class DeflateDistanceModel:

    def __init__(self, size, extra_states,
                 lg_distance_model_factory, length_bits_model_factory):
        bits = util.fls(size - 1)
        self.extra_states = extra_states or 0
        self.lg_distance_model = lg_distance_model_factory(
            2 * bits + self.extra_states)
        self.distance_model = {}
        for i in range(3, bits + 1):
            self.distance_model[i] = length_bits_model_factory(1 << (i - 2))

    def encode(self, distance):
        if distance < 4:  # small distance or extra state
            self.lg_distance_model.encode(distance + self.extra_states)
            return
        lg = util.fls(distance)
        assert distance & (1 << (lg - 1))
        assert lg >= 3
        next_bit = 1 if (distance & (1 << (lg - 2))) else 0
        l = 4 + ((lg - 3) * 2) + next_bit
        self.lg_distance_model.encode(l + self.extra_states)
        rest = distance & ((1 << (lg - 2)) - 1)
        self.distance_model[lg].encode(rest)

    def decode(self):
        l = self.lg_distance_model.decode() - self.extra_states
        if l < 4:
            return l
        next_bit = l & 1
        lg = ((l - 4) >> 1) + 3
        rest = self.distance_model[lg].decode()
        return ((2 + next_bit) << (lg - 2)) + rest
