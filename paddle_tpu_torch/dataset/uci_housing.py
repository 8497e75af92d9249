"""UCI-housing-shaped synthetic regression dataset
(reference python/paddle/dataset/uci_housing.py).

Samples: (features: float32[13], price: float32[1]) from a fixed linear model
plus noise — fit_a_line converges on it.
"""

from __future__ import annotations

import numpy as np

from . import common

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE",
    "DIS", "RAD", "TAX", "PTRATIO", "B", "LSTAT",
]

_W = np.linspace(-2.0, 2.0, 13).astype("float32").reshape(13, 1)
_B = 1.5


def _make(n, seed):
    r = common.rng(seed)
    x = r.uniform(-1, 1, (n, 13)).astype("float32")
    y = x @ _W + _B + 0.05 * r.randn(n, 1).astype("float32")
    return [(x[i], y[i].astype("float32")) for i in range(n)]


def train():
    return common.make_reader(_make(404, seed=7))


def test():
    return common.make_reader(_make(102, seed=8))
