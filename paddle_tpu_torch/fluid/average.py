"""WeightedAverage (counterpart of ``paddle_tpu/fluid/average.py``, the
reference's python/paddle/fluid/average.py): a small host accumulator
kept for the API; fluid.metrics is the newer surface."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _flatten(value):
    a = np.asarray(value, dtype="float64")
    if a.ndim == 0:
        return float(a), 1.0
    return float(a.sum()), float(a.size)


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        """value: scalar or array (arrays contribute their mean weighted by
        `weight`, matching the reference's matrix handling)."""
        s, n = _flatten(value)
        w = float(weight)
        self.numerator += (s / n) * w
        self.denominator += w

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator
