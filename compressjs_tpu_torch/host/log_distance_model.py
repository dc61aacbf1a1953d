"""Composite distance model (a copy of
``compressjs_tpu.models.log_distance_model``): fls(distance) through
one model (plus optional negative 'extra states'), then the low
fls - 1 bits through a model per length.  The BWTC codec codes its
block lengths and pidx with it."""

from __future__ import annotations

from .util import fls


class LogDistanceModel:

    def __init__(self, size, extra_states,
                 lg_distance_model_factory, length_bits_model_factory):
        bits = fls(size - 1)
        self.extra_states = extra_states or 0
        self.lg_distance_model = lg_distance_model_factory(
            1 + bits + self.extra_states)
        # distance_model[n] codes distances that are n bits long; only the
        # low n-1 bits are coded (the top bit is known to be one).
        self.distance_model = {}
        for i in range(2, bits + 1):
            self.distance_model[i] = length_bits_model_factory(1 << (i - 1))

    def encode(self, distance):
        """distance in [0, size) or a negative 'extra state'."""
        if distance < 2:
            self.lg_distance_model.encode(distance + self.extra_states)
            return
        lg = fls(distance)
        assert distance & (1 << (lg - 1))
        assert lg >= 2
        self.lg_distance_model.encode(lg + self.extra_states)
        rest = distance & ((1 << (lg - 1)) - 1)
        self.distance_model[lg].encode(rest)

    def decode(self):
        lg = self.lg_distance_model.decode() - self.extra_states
        if lg < 2:
            return lg  # small distance or extra state
        rest = self.distance_model[lg].decode()
        return (1 << (lg - 1)) + rest
