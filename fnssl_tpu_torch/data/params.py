"""Random-parameter sampler (parity: FN-SSL/Dataset.py:54-83).

Improvement over the reference: sampling goes through an explicit
numpy Generator so scenes are reproducible per item seed (the capability
MyDistributedSampler adds in IPDnet2, made universal here).

Port of ``fnssl_tpu/data/params.py``, the same numpy code.
"""
from __future__ import annotations

import numpy as np


class Parameter:
    """Fixed value, uniform range, or discrete choice."""

    def __init__(self, *args, discrete: bool = False):
        self.discrete = discrete
        if discrete:
            self.value_range = args[0]
            return
        if len(args) == 1:
            self.random = False
            self.value = np.array(args[0])
        elif len(args) == 2:
            self.random = True
            self.min_value = np.array(args[0])
            self.max_value = np.array(args[1])
        else:
            raise ValueError(
                "Parameter takes one (value) or two (min, max) array-likes")

    def get_value(self, rng: np.random.Generator | None = None):
        rng = rng if rng is not None else np.random.default_rng()
        if self.discrete:
            return self.value_range[rng.integers(0, len(self.value_range))]
        if self.random:
            return self.min_value + rng.random(self.min_value.shape) \
                * (self.max_value - self.min_value)
        return self.value

    # reference-compatible alias
    getValue = get_value


def as_parameter(x) -> Parameter:
    return x if isinstance(x, Parameter) else Parameter(x)
